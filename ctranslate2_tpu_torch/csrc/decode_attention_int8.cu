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
// Design: (batch, KV head) alone is too few blocks for 132 SMs, so the
// visible key range of each row is also cut into `splits` slices: grid
// (splits, KV heads * query tiles, batch). A 128-thread block is 16 key
// slots of 8 lanes; a slot streams every 16th key of the slice with one
// 16-byte load of K and one of V per lane (a lane owns 16 of the head's
// dims, or 32 when D > 128), keeps the GT query rows of its KV head
// (pre-scaled) and its own running (max, sum, accumulator) in registers,
// and skips invisible keys. The slots are merged by shuffles and shared
// memory, and the block writes one partial (max, sum, accumulator) per
// query row. A second small kernel merges the partials of a row, folds in
// the fresh key/value and divides. A slice that holds no visible key does
// no loads. D must be a multiple of 16 and at most 256.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int LANES = 8;                 // lanes per key slot
constexpr int SLOTS = THREADS / LANES;   // key slots per block
constexpr int CHUNK = 16;                // int8 elements per 16-byte load

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void unpack16(const int4& raw, float (&out)[CHUNK]) {
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      out[i * 4 + b] = (float)(int)(signed char)((w[i] >> (8 * b)) & 0xff);
    }
  }
}

// Running softmax state of GT query rows over this lane's dims.
template <int NCH, int GT>
struct State {
  float m[GT];
  float l[GT];
  float acc[GT][NCH * CHUNK];
};

template <int NCH, int GT>
__device__ __forceinline__ void merge_into(State<NCH, GT>& a, const float (&m_o)[GT],
                                           const float (&l_o)[GT],
                                           const float (&acc_o)[GT][NCH * CHUNK]) {
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const float m_new = fmaxf(a.m[g], m_o[g]);
    // Both sides empty: exp(0) = 1 scales sums and accumulators that are 0.
    const float ca = __expf(a.m[g] - m_new);
    const float co = __expf(m_o[g] - m_new);
    a.l[g] = a.l[g] * ca + l_o[g] * co;
#pragma unroll
    for (int i = 0; i < NCH * CHUNK; ++i) a.acc[g][i] = a.acc[g][i] * ca + acc_o[g][i] * co;
    a.m[g] = m_new;
  }
}

template <typename TQ, int NCH, int GT>
__global__ void __launch_bounds__(THREADS)
decode_partial_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ k8,
                      const float* __restrict__ k_scale,
                      const int8_t* __restrict__ v8,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ lengths,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int Hkv, int G, int C,
                      int D, float scale, int window, int splits) {
  constexpr int W = NCH * CHUNK;  // dims per lane
  const int split = blockIdx.x;
  const int gtiles = (G + GT - 1) / GT;
  const int hkv = blockIdx.y / gtiles;
  const int g0 = (blockIdx.y % gtiles) * GT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int slot = tid / LANES;
  const int lane = tid % LANES;

  // Visible key range of this row, and this block's slice of it.
  int hi = min(lengths[b], C);
  int lo = 0;
  if (window > 0) lo = max(hi - window, 0);
  if (hi < lo) hi = lo;
  int per = (hi - lo + splits - 1) / splits;
  per = (per + SLOTS - 1) / SLOTS * SLOTS;
  const int c0 = lo + split * per;
  const int c1 = min(c0 + per, hi);

  // This lane's dims: chunk j covers dims [(j * LANES + lane) * 16, +16).
  float qr[GT][W];
  State<NCH, GT> st;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    st.m[g] = NEG_INF;
    st.l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      st.acc[g][i] = 0.f;
      qr[g][i] = 0.f;
    }
  }
  if (c0 < c1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g0 + g < G) {
        const TQ* qrow = q + ((size_t)b * Hkv * G + (size_t)hkv * G + g0 + g) * D;
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          const int d0 = (j * LANES + lane) * CHUNK;
          if (d0 < D) {
#pragma unroll
            for (int i = 0; i < CHUNK; ++i) qr[g][j * CHUNK + i] = to_f32(qrow[d0 + i]) * scale;
          }
        }
      }
    }
    const size_t head = (size_t)b * Hkv + hkv;
    const int8_t* kbase = k8 + head * C * D;
    const int8_t* vbase = v8 + head * C * D;
    const float* ks = k_scale + head * C;
    const float* vs = v_scale + head * C;

    // The trip count is the same for every slot (the shuffles below need
    // whole warps); a slot whose key lies past the slice only takes part in
    // the shuffles.
    for (int base = c0; base < c1; base += SLOTS) {
      const int c = base + slot;
      const bool live = c < c1;
      float kf[W];
      float vf[W];
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int d0 = (j * LANES + lane) * CHUNK;
        float kt[CHUNK], vt[CHUNK];
        if (live && d0 < D) {
          unpack16(*reinterpret_cast<const int4*>(kbase + (size_t)c * D + d0), kt);
          unpack16(*reinterpret_cast<const int4*>(vbase + (size_t)c * D + d0), vt);
        } else {
#pragma unroll
          for (int i = 0; i < CHUNK; ++i) kt[i] = vt[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) {
          kf[j * CHUNK + i] = kt[i];
          vf[j * CHUNK + i] = vt[i];
        }
      }
      const float ksc = live ? ks[c] : 1.f;
      const float vsc = live ? vs[c] : 1.f;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < W; ++i) s += qr[g][i] * kf[i];
        // The 8 lanes of a slot are neighbours within a warp.
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        if (live) {
          s = s / ksc;
          const float m_new = fmaxf(st.m[g], s);
          const float corr = __expf(st.m[g] - m_new);
          const float p = __expf(s - m_new);
          st.l[g] = st.l[g] * corr + p;
          const float pv = p / vsc;
#pragma unroll
          for (int i = 0; i < W; ++i) st.acc[g][i] = st.acc[g][i] * corr + pv * vf[i];
          st.m[g] = m_new;
        }
      }
    }
  }
  // Merge the four slots of each warp (lanes 8 and 16 apart).
#pragma unroll
  for (int off = LANES; off < 32; off <<= 1) {
    float m_o[GT], l_o[GT], acc_o[GT][W];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      m_o[g] = __shfl_xor_sync(0xffffffffu, st.m[g], off);
      l_o[g] = __shfl_xor_sync(0xffffffffu, st.l[g], off);
#pragma unroll
      for (int i = 0; i < W; ++i) acc_o[g][i] = __shfl_xor_sync(0xffffffffu, st.acc[g][i], off);
    }
    merge_into<NCH, GT>(st, m_o, l_o, acc_o);
  }

  // Merge the four warps through shared memory.
  __shared__ float sm_m[3][LANES][GT];
  __shared__ float sm_l[3][LANES][GT];
  __shared__ float sm_acc[3][LANES][GT][W];
  const int warp = tid >> 5;
  const int wl = tid & 31;
  if (warp > 0 && wl < LANES) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      sm_m[warp - 1][wl][g] = st.m[g];
      sm_l[warp - 1][wl][g] = st.l[g];
#pragma unroll
      for (int i = 0; i < W; ++i) sm_acc[warp - 1][wl][g][i] = st.acc[g][i];
    }
  }
  __syncthreads();
  if (warp == 0 && wl < LANES) {
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      float m_o[GT], l_o[GT], acc_o[GT][W];
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        m_o[g] = sm_m[w][wl][g];
        l_o[g] = sm_l[w][wl][g];
#pragma unroll
        for (int i = 0; i < W; ++i) acc_o[g][i] = sm_acc[w][wl][g][i];
      }
      merge_into<NCH, GT>(st, m_o, l_o, acc_o);
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g0 + g >= G) continue;
      const size_t row = ((size_t)b * Hkv * G + (size_t)hkv * G + g0 + g) * splits + split;
      if (wl == 0) {
        part_m[row] = st.m[g];
        part_l[row] = st.l[g];
      }
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int d0 = (j * LANES + wl) * CHUNK;
        if (d0 < D) {
#pragma unroll
          for (int i = 0; i < CHUNK; ++i) part_acc[row * D + d0 + i] = st.acc[g][j * CHUNK + i];
        }
      }
    }
  }
}

// One block per (batch, query head): merges the partials of the row, folds
// in the fresh key/value and divides.
template <typename TQ>
__global__ void __launch_bounds__(THREADS)
decode_merge_kernel(const TQ* __restrict__ q, const float* __restrict__ part_m,
                    const float* __restrict__ part_l,
                    const float* __restrict__ part_acc,
                    const int8_t* __restrict__ k_new, const float* __restrict__ kn_scale,
                    const int8_t* __restrict__ v_new, const float* __restrict__ vn_scale,
                    float* __restrict__ out, int Hkv, int G, int D, float scale,
                    int splits) {
  __shared__ float red[THREADS / 32];
  const size_t row = blockIdx.x;  // (b * Hkv + hkv) * G + g
  const size_t head = row / G;    // b * Hkv + hkv
  const int tid = threadIdx.x;

  float m = NEG_INF;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_m[row * splits + s]);
  float l = 0.f;
  for (int s = 0; s < splits; ++s) l += part_l[row * splits + s] * __expf(part_m[row * splits + s] - m);

  float lf = 0.f;
  if (k_new != nullptr) {
    float partial = 0.f;
    for (int d = tid; d < D; d += THREADS) {
      partial += to_f32(q[row * D + d]) * scale * (float)k_new[head * D + d];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) partial += __shfl_xor_sync(0xffffffffu, partial, off);
    if ((tid & 31) == 0) red[tid >> 5] = partial;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) lf += red[w];
    lf = lf / kn_scale[head];
  }

  float corr = 1.f;
  float pf = 0.f;
  if (k_new != nullptr) {
    const float m_new = fmaxf(m, lf);
    corr = __expf(m - m_new);
    const float p = __expf(lf - m_new);
    l = l * corr + p;
    pf = p / vn_scale[head];
    // `corr` rescales what was accumulated against the old maximum `m`.
  }
  const float denom = fmaxf(l, 1e-20f);
  for (int d = tid; d < D; d += THREADS) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      acc += part_acc[(row * splits + s) * D + d] * __expf(part_m[row * splits + s] - m);
    }
    acc *= corr;
    if (k_new != nullptr) acc += pf * (float)v_new[head * D + d];
    out[row * D + d] = acc / denom;
  }
}

template <typename TQ>
int launch(const void* q, const void* k8, const void* k_scale, const void* v8,
           const void* v_scale, const void* lengths, const void* k_new,
           const void* kn_scale, const void* v_new, const void* vn_scale,
           void* part_m, void* part_l, void* part_acc, void* out, int B, int Hkv,
           int G, int C, int D, float scale, int window, int splits,
           cudaStream_t stream) {
  const TQ* qp = static_cast<const TQ*>(q);
  const int8_t* kp = static_cast<const int8_t*>(k8);
  const int8_t* vp = static_cast<const int8_t*>(v8);
  const float* ksp = static_cast<const float*>(k_scale);
  const float* vsp = static_cast<const float*>(v_scale);
  const int* lp = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (D <= 128) {
    constexpr int GT = 4;
    dim3 grid(splits, Hkv * ((G + GT - 1) / GT), B);
    decode_partial_kernel<TQ, 1, GT><<<grid, THREADS, 0, stream>>>(
        qp, kp, ksp, vp, vsp, lp, pm, pl, pa, Hkv, G, C, D, scale, window, splits);
  } else {
    constexpr int GT = 2;
    dim3 grid(splits, Hkv * ((G + GT - 1) / GT), B);
    decode_partial_kernel<TQ, 2, GT><<<grid, THREADS, 0, stream>>>(
        qp, kp, ksp, vp, vsp, lp, pm, pl, pa, Hkv, G, C, D, scale, window, splits);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  decode_merge_kernel<TQ><<<B * Hkv * G, THREADS, 0, stream>>>(
      qp, pm, pl, pa, static_cast<const int8_t*>(k_new),
      static_cast<const float*>(kn_scale), static_cast<const int8_t*>(v_new),
      static_cast<const float*>(vn_scale), static_cast<float*>(out), Hkv, G, D,
      scale, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [B, Hkv * G, D] of `dtype` (0 float32, 1 float16, 2 bfloat16); k8, v8:
// int8 [B, Hkv, C, D], 16-byte aligned; k_scale, v_scale: f32 [B, Hkv, C];
// lengths: int32 [B]; k_new, v_new: int8 [B, Hkv, D] or null (both);
// kn_scale, vn_scale: f32 [B, Hkv]; part_m, part_l: f32 scratch
// [B, Hkv * G, splits]; part_acc: f32 scratch [B, Hkv * G, splits, D];
// out: f32 [B, Hkv * G, D]. `window` counts cache keys (0: none).
// Returns cudaGetLastError() after the launches.
extern "C" int ct2_decode_attention_int8(
    const void* q, const void* k8, const void* k_scale, const void* v8,
    const void* v_scale, const void* lengths, const void* k_new,
    const void* kn_scale, const void* v_new, const void* vn_scale, void* part_m,
    void* part_l, void* part_acc, void* out, int B, int Hkv, int G, int C, int D,
    float scale, int window, int splits, int dtype, void* stream) {
  if (D <= 0 || D % CHUNK != 0 || D > 2 * LANES * CHUNK || splits < 1 ||
      splits > 65535 || B > 65535 || G < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Hkv == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k8, k_scale, v8, v_scale, lengths, k_new, kn_scale,
                         v_new, vn_scale, part_m, part_l, part_acc, out, B, Hkv,
                         G, C, D, scale, window, splits, s);
  }
  if (dtype == 1) {
    return launch<__half>(q, k8, k_scale, v8, v_scale, lengths, k_new, kn_scale,
                          v_new, vn_scale, part_m, part_l, part_acc, out, B, Hkv,
                          G, C, D, scale, window, splits, s);
  }
  if (dtype == 2) {
    return launch<__nv_bfloat16>(q, k8, k_scale, v8, v_scale, lengths, k_new,
                                 kn_scale, v_new, vn_scale, part_m, part_l,
                                 part_acc, out, B, Hkv, G, C, D, scale, window,
                                 splits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
