// One-token attention over an int8 KV cache for Hopper (sm_90a).
//
// Replaces ctranslate2_tpu/kernels/decode_attention.py::decode_attention_int8
// (the Pallas kernel _decode_kernel). For one query token per batch row,
//
//     s[c]  = ((q * scale) . k8[c]) / k_scale[c]      for the visible keys c
//     p     = softmax over the visible keys and, if given, the fresh key
//     out   = sum_c (p[c] / v_scale[c]) * v8[c]  (+ the fresh value's term)
//
// where key c of row b is visible iff c < lengths[b] and, with a window,
// c >= lengths[b] - window. The fresh key/value (this step's token, not yet
// in the cache) is merged last as a one-key block, exactly as the TPU
// kernel's _done does. Output float32. A row with no visible key and no
// fresh key gives zeros.
//
// What bounds it on the H100: bytes. The visible part of the int8 K and V
// cache is read once (2 * D bytes and two scales per key and KV head);
// about 4 * G * D operations per key is far below the card's rate.
//
// Design: one launch, grid (splits, KV heads x query tiles, batch). The
// visible keys of a row are cut into `splits` slices of whole 64-key tiles
// (kernels/decode_attention.py::decode_plan picks the count from the
// shapes and the SM count alone, so a CUDA graph can hold the launch); a
// block takes one slice for the GT query rows of one KV head. For one
// (batch, KV head) a slice is one contiguous run of K and V bytes and of
// scales, streamed by tiles into a ring in shared memory while the block
// computes on an earlier tile.
//
// float16 q and D a multiple of 16 (both main paths; decode_mma_kernel):
// K and V come by 2-D TMA in boxes of 64 keys x 128 bytes, 128B-swizzled,
// into a 4-stage ring (3 at D > 128), the scales by cp.async; warp w takes
// keys 16w .. 16w + 15 of a tile. S = Q.K^T and O += P.V run on the tensor
// cores (mma.sync m16n8k16, f32 sums): ldmatrix reads the int8 rows
// without bank conflicts, a byte permute and one half2 subtraction turn
// them into float16 exactly, and ldmatrix.trans gives P.V its B operand
// (even and odd dims in two mmas). P = p / v_scale is split into float16
// hi + lo (about 22 bits), so the sums keep f32 accuracy. Q.K^T of tile
// t + 1 is issued beside the softmax and P.V of tile t. Per tile and row:
// one maximum, one rescale of the accumulator, one exp() per score.
// float32 or bfloat16 q, or D off a multiple of 16 (decode_fma_kernel):
// f32 FMAs over key slots of 8 lanes (16 at D > 128) that own 16 dims a
// lane; K, V and the scales by 16-byte cp.async chunks of each run's
// enclosing aligned range (a row of D off a multiple of 16 starts anywhere
// in a chunk).
//
// After the last tile the warps are merged through shared memory. With one
// split the block then finishes the rows; with more it writes its partial
// (max, sum, accumulator) to a workspace, and the last block of the row
// group to finish (a counter per group, in a buffer that the last block
// re-zeroes) merges the splits in a fixed order (each split's weight
// exp(m_s - m) computed once), folds in the fresh key/value (read at the
// kernel's start) and divides. The result does not depend on which block
// finishes last: two calls are bit-equal.
//
// What limits it: a fixed cost a launch (the launch, the first reads, the
// partials' fence, counter and merge; chip_smoke.py times the main-path
// call with every row at length 1 beside it), and a tile loop bound by
// latency, not bytes, at two blocks an SM.

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;        // keys a ring stage: kernels/decode_attention.py::DECODE_TILE
constexpr int STAGES = 4;       // tiles in the FMA path's shared-memory ring
constexpr int MAX_SPLITS = 64;  // kernels/decode_attention.py::DECODE_MAX_SPLITS
constexpr int MAX_D = 256;
constexpr int BOX = TILE * 128;  // one 128-byte-wide TMA box of a tile (mma path)
// The mma path keeps p / v_scale x P_SCALE in float16 (hi + lo): a power of
// two that keeps the low half clear of subnormals and the high half below
// float16's maximum up to a cached |value| of 32,000.
constexpr float P_SCALE = 256.f;

struct DecodeParams {
  const void* q;          // [B, Hkv * G, D] of TQ
  const int8_t* k8;       // [B, Hkv, C, D]
  const float* k_scale;   // [B, Hkv, C]
  const int8_t* v8;
  const float* v_scale;
  const int* lengths;     // [B]
  const int8_t* k_new;    // [B, Hkv, D] or null
  const float* kn_scale;  // [B, Hkv]
  const int8_t* v_new;
  const float* vn_scale;
  float* part;            // [B * Hkv * G, splits, D + 2] (splits > 1)
  int* counters;          // one a row group (splits > 1)
  float* out;             // [B, Hkv * G, D]
  int B, Hkv, G, C, D;
  float scale;
  int window, splits, gtiles;
  int stage_bytes;        // one ring stage
  int kv_run, s_run;      // bytes reserved for a tile's K (or V) / scales
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// f32 values of the 16 signed bytes in `w`: each byte, offset by 128, is
// put under the exponent of 2^23 and 2^23 + 128 taken off again (exact).
__device__ __forceinline__ void bytes_to_f32(const uint32_t (&w)[4], float (&f)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[4 * i + j] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650u + j)) - 8388736.f;
    }
  }
}

// Two signed bytes of `w`, picked by the byte-permute selector `sel`
// (0x5140: bytes 0, 1; 0x5342: 2, 3; 0x5240: 0, 2; 0x5341: 1, 3), as a
// float16 pair: offset by 128 under the exponent of 1024, 1152 taken off
// again (exact).
__device__ __forceinline__ uint32_t bytes_to_h2(uint32_t w, uint32_t sel) {
  const uint32_t h = __byte_perm(w ^ 0x80808080u, 0x64646464u, sel);
  const uint32_t k1152 = 0x64806480u;  // float16 1152.0 twice
  const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&h),
                            *reinterpret_cast<const __half2*>(&k1152));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The 16 bytes of dims [d0, d0 + 16) of a row that starts at `row` in
// shared memory, as f32; dims at or past D give 0. VEC: the row is 16-byte
// aligned and D a multiple of 16 (one 16-byte load), else byte loads.
template <bool VEC>
__device__ __forceinline__ void row_f32(const uint8_t* row, int d0, int D, float (&f)[16]) {
  if (VEC) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (d0 < D) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + d0);
      w[0] = raw.x;
      w[1] = raw.y;
      w[2] = raw.z;
      w[3] = raw.w;
    }
    bytes_to_f32(w, f);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      f[i] = d0 + i < D ? (float)(int)reinterpret_cast<const int8_t*>(row)[d0 + i] : 0.f;
    }
  }
}

// cp.async of the 16-byte chunks that cover bytes [off, off + n) of a
// tensor of `total` bytes starting (16-byte aligned) at `base`, to `dst`
// onwards; a chunk past the tensor's end copies only its bytes inside.
// Byte off lands at dst + (off & 15).
__device__ __forceinline__ void copy_run(uint32_t dst, const void* base, size_t off, int n,
                                         size_t total) {
  const size_t a0 = off & ~static_cast<size_t>(15);
  const int chunks = static_cast<int>((off + n - a0 + 15) >> 4);
  for (int i = threadIdx.x; i < chunks; i += THREADS) {
    const size_t src = a0 + 16 * static_cast<size_t>(i);
    const size_t left = total > src ? total - src : 0;
    cp_async16(dst + 16 * i, static_cast<const uint8_t*>(base) + (left ? src : 0),
               left >= 16 ? 16 : static_cast<int>(left));
  }
}

// The visible keys [lo, hi) of row b, and block `split`'s slice [c0, c1)
// of them: the row's tiles dealt out evenly over the splits, the last tile
// ragged (kernels/decode_attention.py::decode_split_range).
__device__ __forceinline__ void slice(const DecodeParams& p, int b, int split, int& c0,
                                      int& c1) {
  const int hi = min(max(p.lengths[b], 0), p.C);
  const int lo = p.window > 0 ? max(hi - p.window, 0) : 0;
  const int row_tiles = (hi - lo + TILE - 1) / TILE;
  c0 = lo + split * row_tiles / p.splits * TILE;
  c1 = min(lo + (split + 1) * row_tiles / p.splits * TILE, hi);
}

// Static shared memory of the merge that ends both kernels.
template <int GT>
struct Tail {
  float red_m[WARPS][GT], red_l[WARPS][GT];  // each warp's max and sum
  float weight[GT][MAX_SPLITS];
  float fin_m[GT], fin_l[GT], fin_corr[GT], fin_pf[GT];
  float fresh_lf[GT], fresh_rvs;
  float fresh_v[MAX_D];
  int last_block;
};

// The fresh key's score of each row (warp g takes row g) and the fresh
// value: load() issues every read at the kernel's start, store() uses them
// once the first tiles are on their way, so that the end of the kernel
// reads nothing from device memory but the partials.
template <typename TQ, int GT>
struct Fresh {
  static constexpr int N = MAX_D / 32;
  TQ q[N];
  int8_t k[N], v[N / 4 + 1];
  float kscale, vscale;

  __device__ __forceinline__ void load(const DecodeParams& p, size_t head, size_t row0,
                                       int g0) {
    if (p.k_new == nullptr) return;
    const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
    const bool row_ok = warp < GT && g0 + warp < p.G;
    const TQ* qrow = static_cast<const TQ*>(p.q) + (row0 + warp) * p.D;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int d = ln + 32 * j;
      q[j] = row_ok && d < p.D ? qrow[d] : TQ(0.f);
      k[j] = row_ok && d < p.D ? p.k_new[head * p.D + d] : int8_t(0);
    }
#pragma unroll
    for (int j = 0; j < N / 4 + 1; ++j) {
      const int d = tid + THREADS * j;
      v[j] = d < p.D ? p.v_new[head * p.D + d] : int8_t(0);
    }
    kscale = p.kn_scale[head];
    vscale = p.vn_scale[head];
  }

  __device__ __forceinline__ void store(const DecodeParams& p, Tail<GT>& tl) const {
    if (p.k_new == nullptr) return;
    const int tid = threadIdx.x, warp = tid >> 5;
    if (warp < GT) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) dot = fmaf(to_f32(q[j]) * p.scale, (float)k[j], dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if ((tid & 31) == 0) tl.fresh_lf[warp] = dot / kscale;
    }
#pragma unroll
    for (int j = 0; j < N / 4 + 1; ++j) {
      const int d = tid + THREADS * j;
      if (d < p.D) tl.fresh_v[d] = (float)v[j];
    }
    if (tid == 0) tl.fresh_rvs = 1.f / vscale;
  }
};

// After every warp has put its (max, sum, accumulator) of each row in
// tl.red_m, tl.red_l and red_acc [WARPS][GT][MAX_D]: merge the warps; with
// one split finish the rows, else publish the partial and let the last
// block of the row group merge the splits, fold in the fresh key and
// divide. `red_acc` has room for WARPS + 1 rows of GT x MAX_D floats.
template <int GT>
__device__ __forceinline__ void finish(const DecodeParams& p, Tail<GT>& tl, float* red_acc,
                                       size_t row0, int g0, int split) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int D = p.D;
  float* tot = red_acc + WARPS * GT * MAX_D;  // [GT][MAX_D]
  __syncthreads();
  if (tid < GT) {
    float mb = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mb = fmaxf(mb, tl.red_m[w][tid]);
    float lb = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      tl.weight[tid][w] = __expf(tl.red_m[w][tid] - mb);
      lb += tl.red_l[w][tid] * tl.weight[tid][w];
    }
    tl.fin_m[tid] = mb;
    tl.fin_l[tid] = lb;
  }
  __syncthreads();
  for (int e = tid; e < GT * D; e += THREADS) {
    const int g = e / D, d = e % D;
    float a = 0.f;
    for (int w = 0; w < WARPS; ++w) a += red_acc[(w * GT + g) * MAX_D + d] * tl.weight[g][w];
    tot[g * MAX_D + d] = a;
  }

  if (p.splits > 1) {
    // Publish this split's partial; the last block of the group merges.
    const int stride = D + 2;
    for (int e = tid; e < GT * D; e += THREADS) {
      const int g = e / D, d = e % D;
      if (g0 + g < p.G) {
        p.part[((row0 + g) * p.splits + split) * stride + 2 + d] = tot[g * MAX_D + d];
      }
    }
    if (tid < GT && g0 + tid < p.G) {
      float* pr = p.part + ((row0 + tid) * p.splits + split) * stride;
      pr[0] = tl.fin_m[tid];
      pr[1] = tl.fin_l[tid];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* counter = p.counters + blockIdx.z * gridDim.y + blockIdx.y;
      const int done = atomicAdd(counter, 1);
      tl.last_block = done == p.splits - 1;
      if (tl.last_block) *counter = 0;  // ready for the next launch
    }
    __syncthreads();
    if (!tl.last_block) return;
    // The partials are read from L2 (ld.cg), where every block's writes
    // landed before its counter moved. Each thread's share of the first
    // PRE splits' sums is loaded together with the statistics.
    constexpr int PRE = 8;
    constexpr int ITEMS = GT * MAX_D / THREADS;
    float pre[ITEMS][PRE];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int e = tid + THREADS * k;
      const int g = e / D, d = e % D;
      const bool in = e < GT * D && g0 + g < p.G;
      const float* pr = p.part + (row0 + g) * p.splits * stride + 2 + d;
#pragma unroll
      for (int z = 0; z < PRE; ++z) pre[k][z] = in && z < p.splits ? __ldcg(pr + z * stride) : 0.f;
    }
    // Warp g takes the statistics of row g: lane z (and z + 32) loads
    // split z's, each split's weight exp(m_z - m) is taken once, and the
    // sums run in a fixed order.
    if (warp < GT && g0 + warp < p.G) {
      const int ln = tid & 31;
      const float* pr = p.part + (row0 + warp) * p.splits * stride;
      float mz[2], lz[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int z = ln + 32 * j;
        mz[j] = z < p.splits ? __ldcg(pr + z * stride) : NEG_INF;
        lz[j] = z < p.splits ? __ldcg(pr + z * stride + 1) : 0.f;
      }
      float mt = fmaxf(mz[0], mz[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      float lt = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int z = ln + 32 * j;
        const float w = z < p.splits ? __expf(mz[j] - mt) : 0.f;
        if (z < p.splits) tl.weight[warp][z] = w;
        lt += lz[j] * w;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
      if (ln == 0) {
        tl.fin_m[warp] = mt;
        tl.fin_l[warp] = lt;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int e = tid + THREADS * k;
      const int g = e / D, d = e % D;
      if (e >= GT * D || g0 + g >= p.G) continue;
      const float* pr = p.part + (row0 + g) * p.splits * stride + 2 + d;
      float a = 0.f;
#pragma unroll
      for (int z = 0; z < PRE; ++z) {
        if (z < p.splits) a += pre[k][z] * tl.weight[g][z];
      }
      for (int z = PRE; z < p.splits; ++z) a += __ldcg(pr + z * stride) * tl.weight[g][z];
      tot[g * MAX_D + d] = a;
    }
  }

  // Fold in the fresh key of each row, then divide.
  if (tid < GT) {
    float corr = 1.f, pf = 0.f, lt = tl.fin_l[tid];
    if (p.k_new != nullptr) {
      const float lf = tl.fresh_lf[tid];
      const float m_new = fmaxf(tl.fin_m[tid], lf);
      corr = __expf(tl.fin_m[tid] - m_new);
      const float pw = __expf(lf - m_new);
      lt = lt * corr + pw;
      pf = pw * tl.fresh_rvs;
    }
    tl.fin_corr[tid] = corr;
    tl.fin_pf[tid] = pf;
    tl.fin_l[tid] = fmaxf(lt, 1e-20f);
  }
  __syncthreads();
  for (int e = tid; e < GT * D; e += THREADS) {
    const int g = e / D, d = e % D;
    if (g0 + g >= p.G) continue;
    float a = tot[g * MAX_D + d] * tl.fin_corr[g];
    if (p.k_new != nullptr) a += tl.fin_pf[g] * tl.fresh_v[d];
    p.out[(row0 + g) * D + d] = a / tl.fin_l[g];
  }
}

// ---------------------------------------------------------------------------
// FMA path (float32 or bfloat16 q, or D off a multiple of 16): key slots of
// LANES lanes, a lane owning 16 dims, KPS keys of each tile a slot.
// ---------------------------------------------------------------------------

template <typename TQ, int LANES, int GT, bool VEC>
__global__ void __launch_bounds__(THREADS, 2) decode_fma_kernel(const DecodeParams p) {
  constexpr int SLOTS = THREADS / LANES;
  constexpr int KPS = TILE / SLOTS;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Tail<GT> tl;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int slot = tid / LANES;
  const int lane = tid % LANES;
  const int d0 = lane * 16;
  const int split = blockIdx.x;
  const int hkv = blockIdx.y / p.gtiles;
  const int g0 = (blockIdx.y % p.gtiles) * GT;
  const int b = blockIdx.z;
  const int D = p.D;
  const size_t head = static_cast<size_t>(b) * p.Hkv + hkv;
  const size_t row0 = head * p.G + g0;  // query row (b * Hq + hq) of g = 0
  Fresh<TQ, GT> fresh;
  fresh.load(p, head, row0, g0);
  int c0, c1;
  slice(p, b, split, c0, c1);
  const int n_tiles = c1 > c0 ? (c1 - c0 + TILE - 1) / TILE : 0;

  const uint32_t ring = smem_u32(smem);
  const size_t kv_total = static_cast<size_t>(p.B) * p.Hkv * p.C * D;
  const size_t s_total = static_cast<size_t>(p.B) * p.Hkv * p.C * 4;

  // Stage layout: K run, V run, k scales, v scales.
  auto issue = [&](int t) {
    const int c = c0 + t * TILE;
    const int nk = min(TILE, c1 - c);
    const uint32_t st = ring + (t % STAGES) * p.stage_bytes;
    const size_t kv_off = (head * p.C + c) * D;
    copy_run(st, p.k8, kv_off, nk * D, kv_total);
    copy_run(st + p.kv_run, p.v8, kv_off, nk * D, kv_total);
    const size_t s_off = (head * p.C + c) * 4;
    copy_run(st + 2 * p.kv_run, p.k_scale, s_off, nk * 4, s_total);
    copy_run(st + 2 * p.kv_run + p.s_run, p.v_scale, s_off, nk * 4, s_total);
  };

  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();
  }

  // This lane's dims of the GT query rows, pre-scaled.
  float qr[GT][16];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const TQ* qrow = static_cast<const TQ*>(p.q) + (row0 + g) * D;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      qr[g][i] = (g0 + g < p.G && d0 + i < D) ? to_f32(qrow[d0 + i]) * p.scale : 0.f;
    }
  }
  fresh.store(p, tl);

  float m[GT], l[GT], acc[GT][16];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[g][i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    // Tile t is in; every thread is done with tile t - 1, whose stage the
    // next copy refills.
    __syncthreads();
    if (t + STAGES - 1 < n_tiles) issue(t + STAGES - 1);
    cp_async_commit();

    const int c = c0 + t * TILE;
    const int nk = min(TILE, c1 - c);
    const uint8_t* st = smem + (t % STAGES) * p.stage_bytes;
    const size_t kv_off = (head * p.C + c) * D;
    const uint8_t* krows = st + (kv_off & 15);  // 0 when D % 16 == 0
    const uint8_t* vrows = st + p.kv_run + (kv_off & 15);
    const size_t s_off = (head * p.C + c) * 4;
    const float* ks = reinterpret_cast<const float*>(st + 2 * p.kv_run + (s_off & 15));
    const float* vs = reinterpret_cast<const float*>(st + 2 * p.kv_run + p.s_run + (s_off & 15));

    // Scores of this slot's keys r = kk * SLOTS + slot of the tile.
    float s[KPS][GT];
#pragma unroll
    for (int kk = 0; kk < KPS; ++kk) {
      const int r = kk * SLOTS + slot;
      float kf[16];
      row_f32<VEC>(krows + r * D, d0, D, kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) dot = fmaf(qr[g][i], kf[i], dot);
        s[kk][g] = dot;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KPS; ++kk) {
      const int r = kk * SLOTS + slot;
      const float rks = r < nk ? __frcp_rn(ks[r]) : 0.f;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int off = 1; off < LANES; off <<= 1) {
          s[kk][g] += __shfl_xor_sync(0xffffffffu, s[kk][g], off);
        }
        s[kk][g] = r < nk ? s[kk][g] * rks : NEG_INF;
      }
    }

    // One maximum per query row over the warp's keys of the tile, one
    // rescale of the accumulators (when the maximum moved), one exp() per
    // score.
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int kk = 1; kk < KPS; ++kk) mx = fmaxf(mx, s[kk][g]);
#pragma unroll
      for (int off = LANES; off < 32; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[g], mx);
      const float corr = __expf(m[g] - m_new);
      m[g] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < KPS; ++kk) {
        s[kk][g] = kk * SLOTS + slot < nk ? __expf(s[kk][g] - m_new) : 0.f;
        sum += s[kk][g];
      }
      l[g] = l[g] * corr + sum;
      if (corr != 1.f) {  // warp-uniform: the warp shares m
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[g][i] *= corr;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KPS; ++kk) {
      const int r = kk * SLOTS + slot;
      const float rvs = r < nk ? __frcp_rn(vs[r]) : 0.f;
      float vf[16];
      row_f32<VEC>(vrows + r * D, d0, D, vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float pv = s[kk][g] * rvs;
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[g][i] = fmaf(pv, vf[i], acc[g][i]);
      }
    }
  }

  // The slots of a warp share its maximum: sum their sums and accumulators.
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int off = LANES; off < 32; off <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
    }
  }
  // Merge the warps through shared memory (the ring is free now: every
  // copy issued was waited for).
  __syncthreads();
  float* red_acc = reinterpret_cast<float*>(smem);
  if ((tid & 31) < LANES) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (d0 + i < MAX_D) red_acc[(warp * GT + g) * MAX_D + d0 + i] = acc[g][i];
      }
      if (lane == 0) {
        tl.red_m[warp][g] = m[g];
        tl.red_l[warp][g] = l[g];
      }
    }
  }
  finish<GT>(p, tl, red_acc, row0, g0, split);
}

// ---------------------------------------------------------------------------
// mma path (float16 q, D a multiple of 16): warp w takes keys 16w .. 16w + 15
// of each 64-key tile; S = Q.K^T and O += P.V on the tensor cores
// (mma.sync m16n8k16, f16 in, f32 sums), the query rows on the M side (row
// g = lane / 4 of the block's GT; the rest zero). K and V come by 2-D TMA in
// boxes of 64 keys x 128 bytes, 128B-swizzled, so that ldmatrix reads them
// without bank conflicts; NB = D / 16 blocks of 16 dims at most (8 or 16).
// ---------------------------------------------------------------------------

// The shared address of 16-byte chunk `cc` (dims 16 cc .. + 15) of key row
// r of a tile whose boxes start at `base`.
__device__ __forceinline__ uint32_t swz(uint32_t base, int r, int cc) {
  return base + (cc >> 3) * BOX + r * 128 + (((cc & 7) ^ (r & 7)) << 4);
}

// Ring stages of the mma path: 4 of 17 KB for D <= 128, 3 of 33 KB above
// (two blocks an SM either way).
template <int NB>
struct MmaStages {
  static constexpr int value = NB > 8 ? 3 : 4;
};

template <int GT, int NB, bool FULL>
__global__ void __launch_bounds__(THREADS, 2)
decode_mma_kernel(const __grid_constant__ CUtensorMap tmap_k,
                  const __grid_constant__ CUtensorMap tmap_v, const DecodeParams p) {
  constexpr int NBOX = (NB + 7) / 8;
  constexpr int ST = MmaStages<NB>::value;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[ST];
  __shared__ Tail<GT> tl;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // this thread's query row
  const int t = lane & 3;
  const int split = blockIdx.x;
  const int hkv = blockIdx.y / p.gtiles;
  const int g0 = (blockIdx.y % p.gtiles) * GT;
  const int b = blockIdx.z;
  const int D = FULL ? 16 * NB : p.D;
  const size_t head = static_cast<size_t>(b) * p.Hkv + hkv;
  const size_t row0 = head * p.G + g0;
  Fresh<__half, GT> fresh;
  fresh.load(p, head, row0, g0);
  // Q's A fragments: for dim block cc the mma's k = 2t, 2t + 1 stand for
  // dims 16 cc + 4t, + 1 and k = 2t + 8, 2t + 9 for 16 cc + 4t + 2, + 3 (the
  // order in which ldmatrix hands out K's bytes); float16 as given, the
  // scale applied to the f32 score.
  uint32_t qa[NB][2];
  {
    const bool row_ok = g < GT && g0 + g < p.G;
    const __half* qrow = static_cast<const __half*>(p.q) + (row0 + g) * D;
#pragma unroll
    for (int cc = 0; cc < NB; ++cc) {
      uint2 v = make_uint2(0u, 0u);
      if (row_ok && 16 * cc < D) v = *reinterpret_cast<const uint2*>(qrow + 16 * cc + 4 * t);
      qa[cc][0] = v.x;
      qa[cc][1] = v.y;
    }
  }
  int c0, c1;
  slice(p, b, split, c0, c1);
  const int n_tiles = c1 > c0 ? (c1 - c0 + TILE - 1) / TILE : 0;

  // 128B-swizzled boxes need 1,024-byte aligned shared memory.
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (ring - smem_u32(smem_raw));
  const size_t s_total = static_cast<size_t>(p.B) * p.Hkv * p.C * 4;
  if (tid == 0) {
    tma_prefetch(&tmap_k);
    tma_prefetch(&tmap_v);
    for (int s = 0; s < ST; ++s) mbar_init(smem_u32(&full_bar[s]), 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Stage layout: NBOX K boxes, NBOX V boxes, k scales, v scales.
  auto issue = [&](int tt) {
    const int c = c0 + tt * TILE;
    const int nk = min(TILE, c1 - c);
    const uint32_t st = ring + (tt % ST) * p.stage_bytes;
    if (tid == 0) {
      const uint32_t bar = smem_u32(&full_bar[tt % ST]);
      const int row = static_cast<int>(head * p.C + c);
      fence_proxy_async();
      mbar_arrive_expect_tx(bar, 2u * NBOX * BOX);
#pragma unroll
      for (int x = 0; x < NBOX; ++x) {
        tma_load_2d(st + x * BOX, &tmap_k, bar, 128 * x, row);
        tma_load_2d(st + (NBOX + x) * BOX, &tmap_v, bar, 128 * x, row);
      }
    }
    const size_t s_off = (head * p.C + c) * 4;
    copy_run(st + 2 * NBOX * BOX, p.k_scale, s_off, nk * 4, s_total);
    copy_run(st + 2 * NBOX * BOX + p.s_run, p.v_scale, s_off, nk * 4, s_total);
  };
  // Tile tt's K and V have landed.
  auto await_tile = [&](int tt) {
    mbar_wait(smem_u32(&full_bar[tt % ST]), (tt / ST) & 1);
  };

  // ldmatrix: lane l addresses row l % 8 of matrix l / 8, which is key
  // block (l / 8) & 1 of the warp's 16 keys and dim block cc + (l / 16).
  const int ld_r = 16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7);
  const int ld_c = lane >> 4;

  // S[row g][keys 16w + 8j + 2t, + 1] of tile tt in s[j][0..1]; even and
  // odd dim blocks in two sums, so that each mma chain is half as long.
  auto qk = [&](int tt, float (&s)[2][4]) {
    const uint32_t kst = ring + (tt % ST) * p.stage_bytes;
    float s2[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = s2[j][i] = 0.f;
    }
#pragma unroll
    for (int cc = 0; cc < NB; cc += 2) {
      if (FULL || 16 * cc < D) {
        const int cx = FULL || 16 * (cc + ld_c) < D ? cc + ld_c : cc;
        uint32_t x[4];
        ldmatrix_x4(x, swz(kst, ld_r, cx));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (FULL || 16 * (cc + h) < D) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              mma_f16_m16n8k16(h ? s2[j] : s[j], qa[cc + h][0], 0u, qa[cc + h][1], 0u,
                               bytes_to_h2(x[2 * h + j], 0x5140u),
                               bytes_to_h2(x[2 * h + j], 0x5342u));
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j][0] += s2[j][0];
      s[j][1] += s2[j][1];
    }
  };

  // Row g's running max, this thread's share of its sum, and its
  // accumulator: ae[cc][0..1] dims 16 cc + 4t and + 2, ao[cc][0..1] dims
  // 16 cc + 4t + 1 and + 3 (rows g + 8, in [2..3], stay zero).
  float m = NEG_INF, l = 0.f;
  float ae[NB][4], ao[NB][4];
#pragma unroll
  for (int cc = 0; cc < NB; ++cc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) ae[cc][i] = ao[cc][i] = 0.f;
  }

  // Tiles 0 .. ST - 2 in flight; Q.K^T of tile tt + 1 is computed while
  // the softmax and P.V of tile tt run (the stage refilled in iteration tt
  // held tile tt - 1).
  for (int tt = 0; tt < ST - 1; ++tt) {
    if (tt < n_tiles) issue(tt);
    cp_async_commit();
  }
  fresh.store(p, tl);
  float s[2][4];
  if (n_tiles > 0) {
    await_tile(0);
    __syncwarp();
    qk(0, s);
  }
  for (int tt = 0; tt < n_tiles; ++tt) {
    // Tile tt + 1 in (its K for the next Q.K^T; tile tt's scales too).
    cp_async_wait<ST - 3>();
    if (tt + 1 < n_tiles) await_tile(tt + 1);
    __syncthreads();
    if (tt + ST - 1 < n_tiles) issue(tt + ST - 1);
    cp_async_commit();

    const int c = c0 + tt * TILE;
    const int nk = min(TILE, c1 - c);
    const uint32_t vst = ring + (tt % ST) * p.stage_bytes + NBOX * BOX;
    const uint8_t* sc_base = smem + (tt % ST) * p.stage_bytes + 2 * NBOX * BOX;
    const size_t s_off = (head * p.C + c) * 4;
    const float* ks = reinterpret_cast<const float*>(sc_base + (s_off & 15));
    const float* vs = reinterpret_cast<const float*>(sc_base + p.s_run + (s_off & 15));

    // Scale and mask; one maximum per row over the warp's 16 keys; one
    // rescale of the accumulator; one exp() per score; P = p / v_scale x
    // P_SCALE split into float16 hi + lo.
    float sv[4], rv[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 16 * warp + 8 * j + 2 * t + e;
        ok[2 * j + e] = r < nk;
        sv[2 * j + e] = r < nk ? s[j][e] * p.scale * __frcp_rn(ks[r]) : NEG_INF;
        rv[2 * j + e] = r < nk ? __frcp_rn(vs[r]) * P_SCALE : 0.f;
      }
    }
    float mx = fmaxf(fmaxf(sv[0], sv[1]), fmaxf(sv[2], sv[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = __expf(m - m_new);
    m = m_new;
    float pw[4], sum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pw[i] = ok[i] ? __expf(sv[i] - m_new) : 0.f;
      sum += pw[i];
    }
    l = l * corr + sum;
#pragma unroll
    for (int cc = 0; cc < NB; ++cc) {
      ae[cc][0] *= corr;
      ae[cc][1] *= corr;
      ao[cc][0] *= corr;
      ao[cc][1] *= corr;
    }
    uint32_t hi[2], lo[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float x0 = pw[2 * j] * rv[2 * j], x1 = pw[2 * j + 1] * rv[2 * j + 1];
      const __half2 h = __floats2half2_rn(x0, x1);
      const float2 hf = __half22float2(h);
      const __half2 r = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
      hi[j] = *reinterpret_cast<const uint32_t*>(&h);
      lo[j] = *reinterpret_cast<const uint32_t*>(&r);
    }

    // The next tile's scores (past the last tile: a stage's stale bytes,
    // discarded), independent of the P.V below.
    qk(tt + 1, s);

    // O += P.V: the S accumulator of key blocks 0 and 1 is the A fragment;
    // ldmatrix.trans hands lane (g, t) bytes (key 2t, dims 2g, 2g + 1) and
    // (key 2t + 1, same dims) of each 8-key x 16-dim block: the even dims
    // feed one mma, the odd dims another.
#pragma unroll
    for (int cc = 0; cc < NB; cc += 2) {
      if (FULL || 16 * cc < D) {
        const int cx = FULL || 16 * (cc + ld_c) < D ? cc + ld_c : cc;
        uint32_t x[4];
        ldmatrix_x4_trans(x, swz(vst, ld_r, cx));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (FULL || 16 * (cc + h) < D) {
            const uint32_t e0 = bytes_to_h2(x[2 * h], 0x5240u);
            const uint32_t e1 = bytes_to_h2(x[2 * h + 1], 0x5240u);
            const uint32_t o0 = bytes_to_h2(x[2 * h], 0x5341u);
            const uint32_t o1 = bytes_to_h2(x[2 * h + 1], 0x5341u);
            mma_f16_m16n8k16(ae[cc + h], hi[0], 0u, hi[1], 0u, e0, e1);
            mma_f16_m16n8k16(ao[cc + h], hi[0], 0u, hi[1], 0u, o0, o1);
            mma_f16_m16n8k16(ae[cc + h], lo[0], 0u, lo[1], 0u, e0, e1);
            mma_f16_m16n8k16(ao[cc + h], lo[0], 0u, lo[1], 0u, o0, o1);
          }
        }
      }
    }
  }

  // Row g's sum over the four lanes that share it; the accumulator out of
  // P_SCALE's units.
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  __syncthreads();
  float* red_acc = reinterpret_cast<float*>(smem);
  if (g < GT) {
    float* ra = red_acc + (warp * GT + g) * MAX_D;
#pragma unroll
    for (int cc = 0; cc < NB; ++cc) {
      if (FULL || 16 * cc < D) {
        const int d = 16 * cc + 4 * t;
        ra[d] = ae[cc][0] * (1.f / P_SCALE);
        ra[d + 1] = ao[cc][0] * (1.f / P_SCALE);
        ra[d + 2] = ae[cc][1] * (1.f / P_SCALE);
        ra[d + 3] = ao[cc][1] * (1.f / P_SCALE);
      }
    }
    if (t == 0) {
      tl.red_m[warp][g] = m;
      tl.red_l[warp][g] = l;
    }
  }
  finish<GT>(p, tl, red_acc, row0, g0, split);
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

// The merge after the loop reuses the ring: the warps' accumulators and the
// total, (WARPS + 1) x GT x MAX_D floats.
template <int GT>
int set_smem(const void* kernel, int ring, int* attr) {
  const int merge = (WARPS + 1) * GT * MAX_D * 4;
  const int smem = ring > merge ? ring : merge;
  if (smem > *attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return -static_cast<int>(e);
    *attr = smem;
  }
  return smem;
}

template <typename TQ, int LANES, int GT, bool VEC>
int launch_fma(DecodeParams p, cudaStream_t stream) {
  p.kv_run = (TILE * p.D + 15) / 16 * 16 + 16;  // + the shift of an unaligned run
  p.s_run = TILE * 4 + 16;
  p.stage_bytes = 2 * p.kv_run + 2 * p.s_run;
  static int attr = 0;
  const int smem = set_smem<GT>(reinterpret_cast<const void*>(
                                    decode_fma_kernel<TQ, LANES, GT, VEC>),
                                STAGES * p.stage_bytes, &attr);
  if (smem < 0) return -smem;
  dim3 grid(p.splits, p.Hkv * p.gtiles, p.B);
  decode_fma_kernel<TQ, LANES, GT, VEC><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// A 2-D uint8 map over a [rows, D] cache: boxes of 128 bytes x TILE rows,
// 128B-swizzled; rows past the end read as zeros.
int encode_cache(CUtensorMap* map, const void* ptr, int D, long long rows) {
  ct2_encode_tiled_fn encode = ct2_encode_tiled();
  if (encode == nullptr) return CT2_ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D};
  const cuuint32_t box[2] = {128u, (cuuint32_t)TILE};
  const cuuint32_t elem[2] = {1u, 1u};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : CT2_ERR_ENCODE + static_cast<int>(r);
}

template <int GT, int NB, bool FULL>
int launch_mma(DecodeParams p, cudaStream_t stream) {
  constexpr int NBOX = (NB + 7) / 8;
  CUtensorMap tk, tv;
  const long long rows = static_cast<long long>(p.B) * p.Hkv * p.C;
  int err = encode_cache(&tk, p.k8, p.D, rows);
  if (err == 0) err = encode_cache(&tv, p.v8, p.D, rows);
  if (err != 0) return err;
  p.kv_run = NBOX * BOX;
  p.s_run = TILE * 4 + 16;
  p.stage_bytes = (2 * p.kv_run + 2 * p.s_run + 1023) / 1024 * 1024;
  static int attr = 0;
  const int smem = set_smem<GT>(reinterpret_cast<const void*>(decode_mma_kernel<GT, NB, FULL>),
                                MmaStages<NB>::value * p.stage_bytes + 1024, &attr);
  if (smem < 0) return -smem;
  dim3 grid(p.splits, p.Hkv * p.gtiles, p.B);
  decode_mma_kernel<GT, NB, FULL><<<grid, THREADS, smem, stream>>>(tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, int LANES, int GT>
int launch_path(const DecodeParams& p, cudaStream_t stream) {
  if (p.D % 16 != 0) return launch_fma<TQ, LANES, GT, false>(p, stream);
  if constexpr (std::is_same<TQ, __half>::value) {
    constexpr int NB = LANES == 8 ? 8 : 16;
    return p.D == 16 * NB ? launch_mma<GT, NB, true>(p, stream)
                          : launch_mma<GT, NB, false>(p, stream);
  } else {
    return launch_fma<TQ, LANES, GT, true>(p, stream);
  }
}

template <typename TQ, int LANES>
int launch_lanes(const DecodeParams& p, int gt, cudaStream_t stream) {
  if (gt == 1) return launch_path<TQ, LANES, 1>(p, stream);
  if (gt == 2) return launch_path<TQ, LANES, 2>(p, stream);
  return launch_path<TQ, LANES, 4>(p, stream);
}

template <typename TQ>
int launch(const DecodeParams& p, int lanes, int gt, cudaStream_t stream) {
  return lanes == 8 ? launch_lanes<TQ, 8>(p, gt, stream)
                    : launch_lanes<TQ, 16>(p, gt, stream);
}

}  // namespace

// The kernels of one q dtype each. kernels/build.py compiles this source as
// three units at once (-DCT2_UNIT=0, 1, 2), unit u holding dtype u's 16
// instances (and unit 0 the entry point below), and links them into one
// library.
#ifndef CT2_UNIT
#error "build decode_attention_int8.cu with -DCT2_UNIT=0, 1 or 2"
#endif
extern "C" int ct2_decode_launch_f32(const void* p, int lanes, int gt, void* stream);
extern "C" int ct2_decode_launch_f16(const void* p, int lanes, int gt, void* stream);
extern "C" int ct2_decode_launch_bf16(const void* p, int lanes, int gt, void* stream);

#if CT2_UNIT == 0
extern "C" int ct2_decode_launch_f32(const void* p, int lanes, int gt, void* stream) {
  return launch<float>(*static_cast<const DecodeParams*>(p), lanes, gt,
                       static_cast<cudaStream_t>(stream));
}
#endif
#if CT2_UNIT == 1
extern "C" int ct2_decode_launch_f16(const void* p, int lanes, int gt, void* stream) {
  return launch<__half>(*static_cast<const DecodeParams*>(p), lanes, gt,
                        static_cast<cudaStream_t>(stream));
}
#endif
#if CT2_UNIT == 2
extern "C" int ct2_decode_launch_bf16(const void* p, int lanes, int gt, void* stream) {
  return launch<__nv_bfloat16>(*static_cast<const DecodeParams*>(p), lanes, gt,
                               static_cast<cudaStream_t>(stream));
}
#endif

#if CT2_UNIT == 0

// q: [B, Hkv * G, D] of `dtype` (0 float32, 1 float16, 2 bfloat16); k8, v8:
// int8 [B, Hkv, C, D]; k_scale, v_scale: f32 [B, Hkv, C]; all four 16-byte
// aligned; lengths: int32 [B]; k_new, v_new: int8 [B, Hkv, D] or null
// (both); kn_scale, vn_scale: f32 [B, Hkv]; part: f32 workspace
// [B * Hkv * G, splits, D + 2] and counters: int32, one a row group
// (B * Hkv * gtiles), zero before the launch and left zero after it, both
// used only when splits > 1; out: f32 [B, Hkv * G, D]. `window` counts
// cache keys (0: none). lanes (8: D <= 128, 16: D <= 256), gt (1, 2 or 4
// query rows a block) and splits come from decode_plan. Returns
// cudaGetLastError() after the launch, or CT2_ERR_* (hopper.cuh) if a
// tensor map could not be made.
extern "C" int ct2_decode_attention_int8(
    const void* q, const void* k8, const void* k_scale, const void* v8,
    const void* v_scale, const void* lengths, const void* k_new,
    const void* kn_scale, const void* v_new, const void* vn_scale, void* part,
    void* counters, void* out, int B, int Hkv, int G, int C, int D, float scale,
    int window, int lanes, int gt, int splits, int dtype, void* stream) {
  if (D <= 0 || D > MAX_D || D > lanes * 16 || (lanes != 8 && lanes != 16) ||
      (gt != 1 && gt != 2 && gt != 4) || splits < 1 || splits > MAX_SPLITS ||
      B > 65535 || G < 1 || (splits > 1 && (part == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Hkv == 0) return static_cast<int>(cudaGetLastError());
  DecodeParams p;
  p.q = q;
  p.k8 = static_cast<const int8_t*>(k8);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v8 = static_cast<const int8_t*>(v8);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.k_new = static_cast<const int8_t*>(k_new);
  p.kn_scale = static_cast<const float*>(kn_scale);
  p.v_new = static_cast<const int8_t*>(v_new);
  p.vn_scale = static_cast<const float*>(vn_scale);
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.Hkv = Hkv;
  p.G = G;
  p.C = C;
  p.D = D;
  p.scale = scale;
  p.window = window;
  p.splits = splits;
  p.gtiles = (G + gt - 1) / gt;
  if ((long long)Hkv * p.gtiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return ct2_decode_launch_f32(&p, lanes, gt, stream);
  if (dtype == 1) return ct2_decode_launch_f16(&p, lanes, gt, stream);
  if (dtype == 2) return ct2_decode_launch_bf16(&p, lanes, gt, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif
