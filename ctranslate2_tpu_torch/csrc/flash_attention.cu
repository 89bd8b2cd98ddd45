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
// score. Softmax statistics and the accumulator are float32; P is cast to
// V's type before P.V, as on the TPU.
//
// What bounds it on the H100: operations. 4 * B * Hq * Tq * Tk * D (half of
// it under a causal mask) against the tensor cores' 989 TFLOP/s in f16/bf16;
// q, k, v and out are each moved once.
//
// Design (f16/bf16): one 128-thread block per (query tile of 64, query
// head, batch row); each of the four warps owns 16 query rows, whose Q
// fragments stay in registers. K and V tiles of 64 keys pass through shared
// memory (rows padded by 16 bytes so fragment loads spread over the banks);
// Q.K^T and P.V run on mma.sync.m16n8k16 with float32 accumulators, the P
// fragment being built in registers from the score fragment (the C layout of
// the first mma is the A layout of the second), V fragments read with
// ldmatrix.trans. Running max, sum and output accumulator live in registers.
// Tiles that the causal mask, the window or lengths[b] rule out are skipped;
// ragged Tq/Tk edges are masked in the kernel. The tensors are addressed by
// their strides, so the head-split views of a fused QKV projection are read
// in place. float32 inputs take a plain-FMA kernel of the same arithmetic
// (8 lanes per query row, one key at a time): slow and right. Left for later
// work: cp.async/TMA pipelining, wgmma, a persistent schedule that balances
// the causal tiles.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// f16 / bf16: tensor-core kernel.
// ---------------------------------------------------------------------------

template <typename T>
struct Mma;

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
};

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
};

__device__ __forceinline__ unsigned ld32(const unsigned short* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned& r0, unsigned& r1,
                                                  const unsigned short* row) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

template <typename T, int D>
__global__ void __launch_bounds__(128) flash_mma_kernel(const FlashParams p) {
  constexpr int BQ = 64;
  constexpr int BK = 64;
  constexpr int LD = D + 8;  // shared row stride in elements
  constexpr int KS = D / 16;  // k-steps of Q.K^T
  constexpr int ND = D / 8;   // n-tiles of P.V
  __shared__ __align__(16) unsigned short Ks[BK * LD];
  __shared__ __align__(16) unsigned short Vs[BK * LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qt = blockIdx.x;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = hq / (p.Hq / p.Hkv);

  const unsigned short* qb = static_cast<const unsigned short*>(p.q) + b * p.q_sb + hq * p.q_sh;
  const unsigned short* kb = static_cast<const unsigned short*>(p.k) + b * p.k_sb + hkv * p.k_sh;
  const unsigned short* vb = static_cast<const unsigned short*>(p.v) + b * p.v_sb + hkv * p.v_sh;
  unsigned short* ob = static_cast<unsigned short*>(p.out) + b * p.o_sb + hq * p.o_sh;

  const int r0 = qt * BQ + warp * 16 + g;  // this thread's query rows
  const int r1 = r0 + 8;
  const int qpos0 = r0 + p.q_offset;
  const int qpos1 = r1 + p.q_offset;

  unsigned qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int col = ks * 16 + 2 * t;
    qf[ks][0] = r0 < p.Tq ? ld32(qb + r0 * p.q_st + col) : 0u;
    qf[ks][1] = r1 < p.Tq ? ld32(qb + r1 * p.q_st + col) : 0u;
    qf[ks][2] = r0 < p.Tq ? ld32(qb + r0 * p.q_st + col + 8) : 0u;
    qf[ks][3] = r1 < p.Tq ? ld32(qb + r1 * p.q_st + col + 8) : 0u;
  }

  const int kv_len = p.lengths != nullptr ? min(p.lengths[b], p.Tk) : p.Tk;
  const float slope = p.slopes != nullptr ? p.slopes[hq] : 0.f;
  const float* tab = p.rel_table != nullptr ? p.rel_table + (size_t)hq * p.rel_nb : nullptr;
  const int* seg_row = p.segments != nullptr ? p.segments + (size_t)b * p.Tk : nullptr;
  const int qseg0 = (seg_row != nullptr && r0 < p.Tq) ? seg_row[r0] : 0;
  const int qseg1 = (seg_row != nullptr && r1 < p.Tq) ? seg_row[r1] : 0;

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nd][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the row sums

  int kt_lo, kt_hi;
  tile_range(p, kv_len, qt * BQ + p.q_offset, qt * BQ + BQ - 1 + p.q_offset, BK,
             kt_lo, kt_hi);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();  // the previous tile has been read
    for (int c = tid; c < BK * (D / 8); c += 128) {
      const int r = c / (D / 8);
      const int col = (c % (D / 8)) * 8;
      int4 kv4 = make_int4(0, 0, 0, 0);
      int4 vv4 = make_int4(0, 0, 0, 0);
      if (k_start + r < p.Tk) {
        kv4 = *reinterpret_cast<const int4*>(kb + (long long)(k_start + r) * p.k_st + col);
        vv4 = *reinterpret_cast<const int4*>(vb + (long long)(k_start + r) * p.v_st + col);
      }
      *reinterpret_cast<int4*>(Ks + r * LD + col) = kv4;
      *reinterpret_cast<int4*>(Vs + r * LD + col) = vv4;
    }
    __syncthreads();

    // S = Q.K^T for this warp's 16 rows x 64 keys.
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const unsigned short* kp = Ks + (nt * 8 + g) * LD + ks * 16 + 2 * t;
        Mma<T>::run(s[nt], qf[ks], ld32(kp), ld32(kp + 8));
      }
    }

    // Bias terms, mask, running max.
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k_pos = k_start + nt * 8 + 2 * t + i;
        s[nt][i] = score_terms(p, s[nt][i] * p.scale, qpos0, k_pos, kv_len,
                               slope, tab, qseg0, seg_row);
        s[nt][2 + i] = score_terms(p, s[nt][2 + i] * p.scale, qpos1, k_pos,
                                   kv_len, slope, tab, qseg1, seg_row);
        mx0 = fmaxf(mx0, s[nt][i]);
        mx1 = fmaxf(mx1, s[nt][2 + i]);
      }
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
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = live0 ? __expf(s[nt][i] - mn0) : 0.f;
        const float p1 = live1 ? __expf(s[nt][2 + i] - mn1) : 0.f;
        s[nt][i] = p0;
        s[nt][2 + i] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= corr0;
      o[nd][1] *= corr0;
      o[nd][2] *= corr1;
      o[nd][3] *= corr1;
    }

    // O += P.V: the score fragments of key tiles 2kk and 2kk+1 are the A
    // fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned a[4];
      a[0] = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        unsigned b0, b1;
        ldmatrix_x2_trans(b0, b1, Vs + (kk * 16 + (lane & 15)) * LD + nd * 8);
        Mma<T>::run(o[nd], a, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-20f);
  const float d1 = fmaxf(l1, 1e-20f);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (r0 < p.Tq) {
      *reinterpret_cast<unsigned*>(ob + r0 * p.o_st + col) =
          Mma<T>::pack(o[nd][0] / d0, o[nd][1] / d0);
    }
    if (r1 < p.Tq) {
      *reinterpret_cast<unsigned*>(ob + r1 * p.o_st + col) =
          Mma<T>::pack(o[nd][2] / d1, o[nd][3] / d1);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: plain-FMA kernel. 8 lanes per query row, 16 rows per block, one
// key at a time; lane `l` owns the float4 groups l, l + 8, ... of the head.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128) flash_fma_kernel(const FlashParams p) {
  constexpr int BQ = 16;
  constexpr int BK = 32;
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

template <typename T>
int launch_mma(const FlashParams& p, int D, cudaStream_t stream) {
  dim3 grid((p.Tq + 63) / 64, p.Hq, p.B);
  if (D == 64) {
    flash_mma_kernel<T, 64><<<grid, 128, 0, stream>>>(p);
  } else if (D == 128) {
    flash_mma_kernel<T, 128><<<grid, 128, 0, stream>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_fma(const FlashParams& p, int D, cudaStream_t stream) {
  dim3 grid((p.Tq + 15) / 16, p.Hq, p.B);
  if (D == 64) {
    flash_fma_kernel<64><<<grid, 128, 0, stream>>>(p);
  } else if (D == 128) {
    flash_fma_kernel<128><<<grid, 128, 0, stream>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: tensors of `dtype` (0 float32, 1 float16, 2 bfloat16) with a
// dense last dim of D (64 or 128), 16-byte aligned, addressed by the
// (batch, head, time) strides in `strides` (12 values, in elements: q, k, v,
// out). lengths: int32 [B] or null; segments: int32 [B, Tk] or null;
// slopes: f32 [Hq] or null; rel_table: f32 [Hq, rel_nb] or null.
// Returns cudaGetLastError() after the launch.
extern "C" int ct2_flash_attention(
    const void* q, const void* k, const void* v, void* out,
    const long long* strides, const void* lengths, const void* segments,
    const void* slopes, const void* rel_table, int B, int Hq, int Hkv, int Tq,
    int Tk, int D, float scale, int causal, int q_offset, int window,
    int alibi_offs, int rel_bidirectional, int rel_nb, float rel_log_ratio,
    int dtype, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 || B > 65535) {
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
  if (dtype == 1) return launch_mma<__half>(p, D, s);
  if (dtype == 2) return launch_mma<__nv_bfloat16>(p, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
