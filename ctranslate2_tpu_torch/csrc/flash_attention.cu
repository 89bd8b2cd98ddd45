// Flash attention (prefill / full sequence) for Hopper (sm_90a).
//
// Replaces ctranslate2_tpu/kernels/flash_attention.py::flash_attention (the
// Pallas kernel _attn_kernel): blockwise online-softmax attention that never
// writes the [Tq, Tk] score matrix to device memory. For q [B, Hq, Tq, D] and
// k, v [B, Hkv, Tk, D] (query head hq reads KV head hq / (Hq / Hkv)),
//
//     s[i, j] = (q[i] * scale) . k[j]  + ALiBi term + T5 bucket bias
//     masked to -1e30 where key j is not visible to query i
//     out[i]  = softmax_j(s[i, :]) . v        (a row with no visible key: 0)
//
// Key j is visible to query i (at position i + q_offset) iff j < lengths[b],
// j <= position (causal), j > position - window (window > 0) and, with
// segment ids, seg[i] == seg[j]. The ALiBi term is slope[hq] * (j - offs);
// the T5 bias is table[hq, bucket(j - position)], the bucket recomputed per
// score. Softmax statistics and the accumulator are float32; P is rounded to
// V's type before P.V, as on the TPU.
//
// What bounds it on the H100: operations. 4 * B * Hq * Tq * Tk * D (half of
// it under a causal mask) against the tensor cores' 989 TFLOP/s in f16/bf16;
// q, k, v and out are each moved once.
//
// Design (f16/bf16, flash_wgmma_kernel): one block per (query tile, query
// head, batch row). At D = 64 and 128 a block has 384 threads: two consumer
// warpgroups of 64 query rows each (a tile of 128) and a producer warpgroup
// of which one thread works. At D = 256 it has 256 threads: one consumer
// warpgroup (a tile of 64 rows), since the O accumulator of 64 x 256 f32
// alone takes 128 registers a thread, and the producer. The
// producer loads the Q tile once and then K and V tiles of 64 keys into a
// 3-stage ring, all by TMA (4-D tensor maps built per call from the
// tensors' strides, so the head-split views of a fused QKV projection are
// read in place; ragged Tq/Tk edges are TMA's zero fill), 128B-swizzled, and
// signals each stage on an mbarrier; the consumers release a stage on a
// second mbarrier when all have read it. Each consumer computes
// S = Q.K^T with wgmma.m64n64k16 (Q and K K-major from shared-memory
// descriptors), the online softmax in registers, and O += P.V with
// wgmma.m64n{D}k16, P as the register A operand (rounded from the S
// accumulator, whose layout is the A fragment's) and V as the MN-major
// ("transposed") shared-memory B operand. Masks cost nothing where nothing
// is masked: a key tile that every row of the warpgroup sees in full gets no
// per-score test; the others (the causal diagonal, lengths[b], the window
// start, the ragged Tk) get the test. Segment ids, ALiBi and the T5 bias are
// a compile-time flag (EXTRA): the main path's instance (causal, optionally
// lengths) carries none of their code; with EXTRA every tile takes the
// per-score path. Key tiles that the causal mask, the window or lengths[b]
// rule out are never loaded. Under a causal mask the grid's slowest
// dimension runs the query tiles last-first, so the heaviest tiles start
// first. float32 inputs take a plain-FMA kernel of the same arithmetic
// (flash_fma_kernel: 8 lanes per query row, one key at a time): slow and
// right (D / 32 dims a lane at 8 lanes a row; at D = 256 key tiles of 16).
// ptxas (nvcc 12.8, sm_90a, -Xptxas -v): 148-149 registers at
// D = 128, 104-120 at D = 64 (without / with EXTRA), no spills, no stack;
// dynamic shared memory 132,152 bytes at D = 128 (Q 32 KB, three K/V
// stages of 32 KB) and 66,616 at D = 64. D = 256: 206-214 registers, no
// spills, 230,456 bytes of dynamic shared memory (Q 32 KB, three K/V
// stages of 64 KB). Other head dims are zero-padded by the wrapper to the
// next of 64, 128 and 256. Left for later work: FP8, overlapping one warpgroup's
// softmax with the next wgmma (FA3's ping-pong / intra-warpgroup
// pipelining), two consumer warpgroups with setmaxnreg at D = 256, a
// persistent longest-first schedule and a TMA store of the output.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long q_sb, q_sh, q_st;  // strides in elements; the last dim is dense
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  const int* lengths;      // [B] or null
  const int* segments;     // [B, Tk] (Tq == Tk) or null
  const float* slopes;     // [Hq] or null
  const float* rel_table;  // [Hq, rel_nb] or null
  int B, Hq, Hkv, Tq, Tk;
  float scale;
  int causal, q_offset, window;
  int alibi_offs;
  int rel_bidirectional, rel_nb;
  float rel_log_ratio;  // log(max_distance / max_exact)
};

__device__ __forceinline__ int rel_bucket(const FlashParams& p, int relp) {
  int nbh, base, r;
  if (p.rel_bidirectional) {
    nbh = p.rel_nb / 2;
    base = relp > 0 ? nbh : 0;
    r = abs(relp);
  } else {
    nbh = p.rel_nb;
    base = 0;
    r = -min(relp, 0);
  }
  const int max_exact = nbh / 2;
  if (r < max_exact) return base + r;
  const float rs = (float)max(r, 1);
  int large = max_exact + (int)(logf(rs / (float)max_exact) / p.rel_log_ratio *
                                (float)(nbh - max_exact));
  large = min(large, nbh - 1);
  return base + large;
}

// The score of (query at q_pos with segment q_seg, key k_pos) after the
// bias terms and the mask. `s` is (q * scale) . k.
__device__ __forceinline__ float score_terms(const FlashParams& p, float s,
                                             int q_pos, int k_pos, int kv_len,
                                             float slope, const float* tab,
                                             int q_seg, const int* seg_row) {
  if (k_pos >= kv_len) return NEG_INF;
  if (p.causal && k_pos > q_pos) return NEG_INF;
  if (p.window > 0 && k_pos <= q_pos - p.window) return NEG_INF;
  if (seg_row != nullptr && seg_row[k_pos] != q_seg) return NEG_INF;
  if (p.slopes != nullptr) s += slope * (float)(k_pos - p.alibi_offs);
  if (tab != nullptr) s += tab[rel_bucket(p, k_pos - q_pos)];
  return s;
}

// Key tiles [lo, hi) of width `bk` that can hold a visible key for query
// positions [q_first, q_last].
__device__ __forceinline__ void tile_range(const FlashParams& p, int kv_len,
                                           int q_first, int q_last, int bk,
                                           int& lo, int& hi) {
  hi = (kv_len + bk - 1) / bk;
  if (p.causal) hi = q_last < 0 ? 0 : min(hi, q_last / bk + 1);
  lo = 0;
  if (p.window > 0) lo = max(q_first - p.window + 1, 0) / bk;
}

// ---------------------------------------------------------------------------
// f16 / bf16: wgmma + TMA, warp-specialized.
// ---------------------------------------------------------------------------

constexpr int FL_BK = 64;   // keys a tile
constexpr int FL_STAGES = 3;

// D = 64 and 128: two consumer warpgroups of 64 query rows (384 threads,
// a 168-register cap). D = 256: one consumer warpgroup (256 threads, a
// 255-register cap), since its O accumulator alone is 128 registers a thread.
template <int D>
struct FlashShape {
  static constexpr int CONSUMERS = D == 256 ? 1 : 2;
  static constexpr int BQ = 64 * CONSUMERS;  // query rows a block
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
};

constexpr int FL_BQ_MIN = 64;  // the smallest query tile of any instance

template <int D>
struct FlashSmem {
  static constexpr int BQ = FlashShape<D>::BQ;
  static constexpr int CHUNKS = D / 64;  // 128-byte column chunks of a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = FL_BK * D * 2;  // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BARS = Q_BYTES + FL_STAGES * STAGE_BYTES;
  static constexpr int BYTES = 1024 + BARS + (1 + 2 * FL_STAGES) * 8;
};

// Where each of (time, head, batch) sits among the 4-D tensor map's outer
// dimensions (1..3): the map orders them by stride.
struct MapOrder {
  int t, h, b;
};

struct FlashMaps {
  MapOrder q, k, v;
};

__device__ __forceinline__ int map_coord(int dim, const MapOrder& o, int t, int h, int b) {
  return dim == o.t ? t : (dim == o.h ? h : b);
}

__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, const MapOrder& o, int col,
                                         int t, int h, int b) {
  tma_load_4d(dst, map, bar, col, map_coord(1, o, t, h, b), map_coord(2, o, t, h, b),
              map_coord(3, o, t, h, b));
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The score (already scaled) after the mask and, with EXTRA, the segment
// test and the bias terms.
template <bool EXTRA>
__device__ __forceinline__ float edge_score(const FlashParams& p, float s, int q_pos,
                                            int k_pos, int kv_len, float slope,
                                            const float* tab, int q_seg,
                                            const int* seg_row) {
  if (k_pos >= kv_len) return NEG_INF;
  if (p.causal && k_pos > q_pos) return NEG_INF;
  if (p.window > 0 && k_pos <= q_pos - p.window) return NEG_INF;
  if (EXTRA) {
    if (seg_row != nullptr && seg_row[k_pos] != q_seg) return NEG_INF;
    if (p.slopes != nullptr) s += slope * (float)(k_pos - p.alibi_offs);
    if (tab != nullptr) s += tab[rel_bucket(p, k_pos - q_pos)];
  }
  return s;
}

template <typename T, int D, bool EXTRA>
__global__ void __launch_bounds__(FlashShape<D>::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                   const __grid_constant__ CUtensorMap tmap_k,
                   const __grid_constant__ CUtensorMap tmap_v, const FlashParams p,
                   const FlashMaps order, int heaviest_first) {
  using S = FlashSmem<D>;
  constexpr int NC = FlashShape<D>::CONSUMERS;
  constexpr int BQ = S::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base;
  const uint32_t bars = base + S::BARS;
  const uint32_t q_full = bars;
  auto kv_smem = [&](int s) { return base + S::Q_BYTES + s * S::STAGE_BYTES; };
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + FL_STAGES + s); };

  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = heaviest_first ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int hkv = hq / (p.Hq / p.Hkv);
  const int kv_len = p.lengths != nullptr ? min(p.lengths[b], p.Tk) : p.Tk;

  // Key tiles [lo, lo + n_tiles) that hold a visible key for some row.
  int lo, hi;
  tile_range(p, kv_len, qt * BQ + p.q_offset,
             min(qt * BQ + BQ - 1, p.Tq - 1) + p.q_offset, FL_BK, lo, hi);
  const int n_tiles = max(hi - lo, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FL_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    if (threadIdx.x == 128 * NC) {
      tma_prefetch(&tmap_q);
      tma_prefetch(&tmap_k);
      tma_prefetch(&tmap_v);
      mbar_arrive_expect_tx(q_full, S::Q_BYTES);
#pragma unroll
      for (int c = 0; c < S::CHUNKS; ++c) {
        tma_rows(q_smem + c * BQ * 128, &tmap_q, q_full, order.q, c * 64,
                 qt * BQ, hq, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % FL_STAGES;
        if (i >= FL_STAGES) mbar_wait(empty(s), ((i / FL_STAGES) - 1) & 1);
        const int row = (lo + i) * FL_BK;
        mbar_arrive_expect_tx(full(s), S::STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < S::CHUNKS; ++c) {
          tma_rows(kv_smem(s) + c * FL_BK * 128, &tmap_k, full(s), order.k, c * 64, row,
                   hkv, b);
          tma_rows(kv_smem(s) + S::KV_BYTES + c * FL_BK * 128, &tmap_v, full(s), order.v,
                   c * 64, row, hkv, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup `wg`: query rows qt * BQ + wg * 64 + [0, 64) ----
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x & 127) >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg_row = qt * BQ + wg * 64;
  const int r0 = wg_row + warp * 16 + g;  // this thread's two query rows
  const int r1 = r0 + 8;
  const int qpos0 = r0 + p.q_offset;
  const int qpos1 = r1 + p.q_offset;
  const int wg_first = wg_row + p.q_offset;
  const int wg_last = wg_first + 63;

  float slope = 0.f;
  const float* tab = nullptr;
  const int* seg_row = nullptr;
  int qseg0 = 0, qseg1 = 0;
  if (EXTRA) {
    slope = p.slopes != nullptr ? p.slopes[hq] : 0.f;
    tab = p.rel_table != nullptr ? p.rel_table + (size_t)hq * p.rel_nb : nullptr;
    seg_row = p.segments != nullptr ? p.segments + (size_t)b * p.Tk : nullptr;
    qseg0 = (seg_row != nullptr && r0 < p.Tq) ? seg_row[r0] : 0;
    qseg1 = (seg_row != nullptr && r1 < p.Tq) ? seg_row[r1] : 0;
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the row sums

  mbar_wait(q_full, 0);
  const uint32_t q_rows = q_smem + wg * 64 * 128;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % FL_STAGES;
    const int k0 = (lo + i) * FL_BK;
    mbar_wait(full(s), (i / FL_STAGES) & 1);

    // S = Q.K^T: 64 rows x 64 keys; sc[4j + e] is (row r0, key k0 + 8j + 2t
    // + e), sc[4j + 2 + e] the same key for row r1.
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      Wgmma<T>::ss_m64n64k16(
          sc, desc_sw128(q_rows + (kk / 4) * BQ * 128 + off),
          desc_sw128(kv_smem(s) + (kk / 4) * FL_BK * 128 + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);

    const bool interior = !EXTRA && k0 + FL_BK <= kv_len &&
                          (!p.causal || k0 + FL_BK - 1 <= wg_first) &&
                          (p.window <= 0 || k0 > wg_last - p.window);
    if (interior) {
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] *= p.scale;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k_pos = k0 + 8 * j + 2 * t + e;
          sc[4 * j + e] = edge_score<EXTRA>(p, sc[4 * j + e] * p.scale, qpos0, k_pos,
                                            kv_len, slope, tab, qseg0, seg_row);
          sc[4 * j + 2 + e] = edge_score<EXTRA>(p, sc[4 * j + 2 + e] * p.scale, qpos1,
                                                k_pos, kv_len, slope, tab, qseg1, seg_row);
        }
      }
    }

    // Online softmax; the four threads of a quad share a row.
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float corr0 = __expf(m0 - mn0);
    const float corr1 = __expf(m1 - mn1);
    // A row with no visible key so far keeps weights of zero.
    const bool live0 = mn0 > NEG_INF / 2;
    const bool live1 = mn1 > NEG_INF / 2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = live0 ? __expf(sc[4 * j + e] - mn0) : 0.f;
        const float p1 = live1 ? __expf(sc[4 * j + 2 + e] - mn1) : 0.f;
        sc[4 * j + e] = p0;
        sc[4 * j + 2 + e] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }

    // O += P.V, 16 keys a step: the S accumulator of key blocks 2kk and
    // 2kk + 1 is the register A fragment of step kk.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack2<T>(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack2<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack2<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack2<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    reg_fence(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // V MN-major: 8-key groups 1024 bytes apart, 64-column chunks one
      // K/V tile's chunk (64 keys x 128 bytes) apart.
      const uint64_t dv =
          desc_sw128(kv_smem(s) + S::KV_BYTES + kk * 16 * 128, FL_BK * 128, 1024);
      if constexpr (D == 256) {
        Wgmma<T>::rs_m64n256k16(o, pa[kk], dv);
      } else if constexpr (D == 128) {
        Wgmma<T>::rs_m64n128k16(o, pa[kk], dv);
      } else {
        Wgmma<T>::rs_m64n64k16(o, pa[kk], dv);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    mbar_arrive(empty(s));
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-20f);
  const float d1 = fmaxf(l1, 1e-20f);
  T* ob = static_cast<T*>(p.out) + b * p.o_sb + hq * p.o_sh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r0 < p.Tq) {
      *reinterpret_cast<uint32_t*>(ob + r0 * p.o_st + col) =
          pack2<T>(o[4 * j] / d0, o[4 * j + 1] / d0);
    }
    if (r1 < p.Tq) {
      *reinterpret_cast<uint32_t*>(ob + r1 * p.o_st + col) =
          pack2<T>(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: plain-FMA kernel. 8 lanes per query row, 16 rows per block, one
// key at a time; lane `l` owns the float4 groups l, l + 8, ... of the head
// (D / 32 dims a lane). Key tiles of 32 (16 at D = 256: 32 KB of static
// shared memory for K and V).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128) flash_fma_kernel(const FlashParams p) {
  constexpr int BQ = 16;
  constexpr int BK = D == 256 ? 16 : 32;
  constexpr int NV = D / 32;  // float4 groups per lane
  __shared__ __align__(16) float Ks[BK * D];
  __shared__ __align__(16) float Vs[BK * D];

  const int tid = threadIdx.x;
  const int rslot = tid >> 3;
  const int lane = tid & 7;
  const int qt = blockIdx.x;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = hq / (p.Hq / p.Hkv);

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + hq * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hkv * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hkv * p.v_sh;
  float* ob = static_cast<float*>(p.out) + b * p.o_sb + hq * p.o_sh;

  const int row = qt * BQ + rslot;
  const int q_pos = row + p.q_offset;
  const bool row_ok = row < p.Tq;

  float4 qr[NV];
  float4 acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    qr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_ok) {
      qr[i] = *reinterpret_cast<const float4*>(qb + row * p.q_st + (i * 8 + lane) * 4);
      qr[i].x *= p.scale;
      qr[i].y *= p.scale;
      qr[i].z *= p.scale;
      qr[i].w *= p.scale;
    }
  }

  const int kv_len = p.lengths != nullptr ? min(p.lengths[b], p.Tk) : p.Tk;
  const float slope = p.slopes != nullptr ? p.slopes[hq] : 0.f;
  const float* tab = p.rel_table != nullptr ? p.rel_table + (size_t)hq * p.rel_nb : nullptr;
  const int* seg_row = p.segments != nullptr ? p.segments + (size_t)b * p.Tk : nullptr;
  const int q_seg = (seg_row != nullptr && row_ok) ? seg_row[row] : 0;

  float m = NEG_INF;
  float l = 0.f;

  int kt_lo, kt_hi;
  tile_range(p, kv_len, qt * BQ + p.q_offset, qt * BQ + BQ - 1 + p.q_offset, BK,
             kt_lo, kt_hi);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();
    for (int c = tid; c < BK * (D / 4); c += 128) {
      const int r = c / (D / 4);
      const int col = (c % (D / 4)) * 4;
      float4 k4 = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 v4 = k4;
      if (k_start + r < p.Tk) {
        k4 = *reinterpret_cast<const float4*>(kb + (long long)(k_start + r) * p.k_st + col);
        v4 = *reinterpret_cast<const float4*>(vb + (long long)(k_start + r) * p.v_st + col);
      }
      *reinterpret_cast<float4*>(Ks + r * D + col) = k4;
      *reinterpret_cast<float4*>(Vs + r * D + col) = v4;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 k4 = *reinterpret_cast<const float4*>(Ks + j * D + (i * 8 + lane) * 4);
        s += qr[i].x * k4.x + qr[i].y * k4.y + qr[i].z * k4.z + qr[i].w * k4.w;
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s = score_terms(p, s, q_pos, k_start + j, kv_len, slope, tab, q_seg, seg_row);
      if (s > NEG_INF / 2) {  // an invisible key has weight zero
        const float mn = fmaxf(m, s);
        const float corr = expf(m - mn);
        const float pw = expf(s - mn);
        l = l * corr + pw;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const float4 v4 = *reinterpret_cast<const float4*>(Vs + j * D + (i * 8 + lane) * 4);
          acc[i].x = acc[i].x * corr + pw * v4.x;
          acc[i].y = acc[i].y * corr + pw * v4.y;
          acc[i].z = acc[i].z * corr + pw * v4.z;
          acc[i].w = acc[i].w * corr + pw * v4.w;
        }
        m = mn;
      }
    }
  }

  if (row_ok) {
    const float d = fmaxf(l, 1e-20f);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      *reinterpret_cast<float4*>(ob + row * p.o_st + (i * 8 + lane) * 4) =
          make_float4(acc[i].x / d, acc[i].y / d, acc[i].z / d, acc[i].w / d);
    }
  }
}

int launch_fma(const FlashParams& p, int D, cudaStream_t stream) {
  dim3 grid((p.Tq + 15) / 16, p.Hq, p.B);
  if (D == 64) {
    flash_fma_kernel<64><<<grid, 128, 0, stream>>>(p);
  } else if (D == 128) {
    flash_fma_kernel<128><<<grid, 128, 0, stream>>>(p);
  } else if (D == 256) {
    flash_fma_kernel<256><<<grid, 128, 0, stream>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}


// A 4-D tensor map over a [B, H, T, D] tensor of 16-bit elements addressed
// by its (batch, head, time) strides in elements: D innermost, the other
// three ordered by stride; a box of 64 columns x `rows` time steps.
int encode_bhtd(CUtensorMap* map, MapOrder* order, const void* ptr, int dtype,
                long long sb, long long sh, long long st, int B, int H, int T, int D,
                int rows) {
  ct2_encode_tiled_fn encode = ct2_encode_tiled();
  if (encode == nullptr) return CT2_ERR_NO_ENCODER;
  struct Outer {
    long long stride;
    int size;
    int which;  // 0 time, 1 head, 2 batch
  } outer[3] = {{st, max(T, 1), 0}, {sh, H, 1}, {sb, B, 2}};
  for (int i = 1; i < 3; ++i) {
    for (int j = i; j > 0 && outer[j].stride < outer[j - 1].stride; --j) {
      const Outer tmp = outer[j];
      outer[j] = outer[j - 1];
      outer[j - 1] = tmp;
    }
  }
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {64u, 1u, 1u, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)outer[i].size;
    strides[i] = (cuuint64_t)outer[i].stride * 2;
    if (outer[i].which == 0) {
      box[i + 1] = (cuuint32_t)rows;
      order->t = i + 1;
    } else if (outer[i].which == 1) {
      order->h = i + 1;
    } else {
      order->b = i + 1;
    }
  }
  const CUresult r = encode(
      map, dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : CT2_ERR_ENCODE + static_cast<int>(r);
}

template <typename T, int D, bool EXTRA>
int launch_wgmma_instance(const FlashParams& p, const CUtensorMap& tq,
                          const CUtensorMap& tk, const CUtensorMap& tv,
                          const FlashMaps& order, int heaviest_first,
                          cudaStream_t stream) {
  constexpr int SMEM = FlashSmem<D>::BYTES;
  constexpr int BQ = FlashShape<D>::BQ;
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(flash_wgmma_kernel<T, D, EXTRA>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    attr_set = true;
  }
  dim3 grid(p.Hq, p.B, (p.Tq + BQ - 1) / BQ);
  flash_wgmma_kernel<T, D, EXTRA><<<grid, FlashShape<D>::THREADS, SMEM, stream>>>(
      tq, tk, tv, p, order, heaviest_first);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_wgmma_dim(const FlashParams& p, int dtype, int heaviest_first,
                     cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  FlashMaps order;
  int err = encode_bhtd(&tq, &order.q, p.q, dtype, p.q_sb, p.q_sh, p.q_st, p.B, p.Hq,
                        p.Tq, D, FlashShape<D>::BQ);
  if (err == 0) {
    err = encode_bhtd(&tk, &order.k, p.k, dtype, p.k_sb, p.k_sh, p.k_st, p.B, p.Hkv,
                      p.Tk, D, FL_BK);
  }
  if (err == 0) {
    err = encode_bhtd(&tv, &order.v, p.v, dtype, p.v_sb, p.v_sh, p.v_st, p.B, p.Hkv,
                      p.Tk, D, FL_BK);
  }
  if (err != 0) return err;
  const bool extra = p.segments != nullptr || p.slopes != nullptr || p.rel_table != nullptr;
  return extra ? launch_wgmma_instance<T, D, true>(p, tq, tk, tv, order, heaviest_first, stream)
               : launch_wgmma_instance<T, D, false>(p, tq, tk, tv, order, heaviest_first, stream);
}

template <typename T>
int launch_wgmma(const FlashParams& p, int D, int dtype, int heaviest_first,
                 cudaStream_t stream) {
  if (D == 64) return launch_wgmma_dim<T, 64>(p, dtype, heaviest_first, stream);
  if (D == 128) return launch_wgmma_dim<T, 128>(p, dtype, heaviest_first, stream);
  if (D == 256) return launch_wgmma_dim<T, 256>(p, dtype, heaviest_first, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, out: tensors of `dtype` (0 float32, 1 float16, 2 bfloat16) with a
// dense last dim of D (64, 128 or 256), 16-byte aligned, addressed by the
// (batch, head, time) strides in `strides` (12 values, in elements: q, k, v,
// out). lengths: int32 [B] or null; segments: int32 [B, Tk] or null;
// slopes: f32 [Hq] or null; rel_table: f32 [Hq, rel_nb] or null.
// heaviest_first (f16/bf16): run the query tiles last-first (the causal
// mask's heaviest first) instead of in launch order. Returns
// cudaGetLastError() after the launch, or CT2_ERR_* (hopper.cuh) if a
// tensor map could not be made.
extern "C" int ct2_flash_attention(
    const void* q, const void* k, const void* v, void* out,
    const long long* strides, const void* lengths, const void* segments,
    const void* slopes, const void* rel_table, int B, int Hq, int Hkv, int Tq,
    int Tk, int D, float scale, int causal, int q_offset, int window,
    int alibi_offs, int rel_bidirectional, int rel_nb, float rel_log_ratio,
    int dtype, int heaviest_first, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 || B > 65535 ||
      (Tq + FL_BQ_MIN - 1) / FL_BQ_MIN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Tq == 0) return static_cast<int>(cudaGetLastError());
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_st = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_st = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_st = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_st = strides[11];
  p.lengths = static_cast<const int*>(lengths);
  p.segments = static_cast<const int*>(segments);
  p.slopes = static_cast<const float*>(slopes);
  p.rel_table = static_cast<const float*>(rel_table);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Tq = Tq; p.Tk = Tk;
  p.scale = scale;
  p.causal = causal; p.q_offset = q_offset; p.window = window;
  p.alibi_offs = alibi_offs;
  p.rel_bidirectional = rel_bidirectional; p.rel_nb = rel_nb;
  p.rel_log_ratio = rel_log_ratio;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fma(p, D, s);
  if (dtype == 1) return launch_wgmma<__half>(p, D, dtype, heaviest_first, s);
  if (dtype == 2) return launch_wgmma<__nv_bfloat16>(p, D, dtype, heaviest_first, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
