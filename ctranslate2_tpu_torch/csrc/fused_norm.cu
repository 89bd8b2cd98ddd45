// Fused LayerNorm / RMSNorm for Hopper (sm_90a).
//
// Replaces ctranslate2_tpu/kernels/norms.py::fused_norm (the Pallas kernel
// _ln_kernel). For x [rows, D] (f32, f16 or bf16), gamma and optional beta
// [D] (f32) it computes, per row, in float32,
//
//     LayerNorm (beta given):  mu = mean(x); xc = x - mu;
//                              y = xc / sqrt(mean(xc * xc) + eps) * gamma + beta
//     RMSNorm (no beta):       y = x / sqrt(mean(x * x) + eps) * gamma
//
// and writes y in x's type. The variance is the centered one (a second
// pass over the row, not E[x^2] - E[x]^2).
//
// What bounds it on the H100: bytes. Each element is read once and written
// once and about ten operations are spent on it, so the least time is
// (rows * D * 2 * sizeof(T) + the parameters) / 3.35 TB/s. Eager PyTorch
// spends six or seven launches and as many round trips through device
// memory on the same function; this is one launch and one round trip.
//
// Design: a group of threads owns one row and keeps it in registers between
// the passes: a warp per row where D <= 1024 (four rows per 128-thread
// block), a 256-thread block per row otherwise. Loads and stores are 16
// bytes wide for the half types (8 elements) and 2 x 16 bytes for float32.
// A row longer than the register budget (D > 16384) is read again from
// device memory (in practice from L2) in each pass instead. D must be a
// multiple of 8; rows need no padding.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;       // elements per thread per step
constexpr int MAX_STEPS = 8;  // register-resident steps per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float& o, float v) { o = v; }
__device__ __forceinline__ void from_f32(__half& o, float v) { o = __float2half_rn(v); }
__device__ __forceinline__ void from_f32(__nv_bfloat16& o, float v) { o = __float2bfloat16_rn(v); }

template <typename T>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&out)[VEC]) {
  const Pack<T> pk = *reinterpret_cast<const Pack<T>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(pk.v[i]);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&in)[VEC]) {
  Pack<T> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) from_f32(pk.v[i], in[i]);
  *reinterpret_cast<Pack<T>*>(p) = pk;
}

// Sum over the TPR threads that share a row (TPR == 32: one warp; else the
// whole block through shared memory).
template <int TPR>
__device__ __forceinline__ float group_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (TPR == 32) return v;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // scratch may still be read from the previous sum
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < TPR / 32; ++w) total += scratch[w];
  return total;
}

template <typename T, int TPR, bool CACHED>
__global__ void __launch_bounds__(TPR == 32 ? 128 : TPR)
fused_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ out,
                  long long rows, int D, float eps) {
  __shared__ float scratch[32];
  const int rows_per_block = (TPR == 32) ? 4 : 1;
  const long long row = (long long)blockIdx.x * rows_per_block +
                        (TPR == 32 ? (threadIdx.x >> 5) : 0);
  const int t = (TPR == 32) ? (threadIdx.x & 31) : threadIdx.x;
  // A warp whose row lies past the end has nothing to do (no block-wide
  // barrier is used when TPR == 32).
  if (row >= rows) return;
  const T* xr = x + row * D;
  T* outr = out + row * D;
  const bool rms = beta == nullptr;
  const float inv_d = 1.0f / (float)D;

  float vals[CACHED ? MAX_STEPS : 1][VEC];
  float sum = 0.f;
  if (CACHED) {
#pragma unroll
    for (int s = 0; s < MAX_STEPS; ++s) {
      const int col = (s * TPR + t) * VEC;
      if (col < D) {
        load8(xr + col, vals[s]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) sum += rms ? vals[s][i] * vals[s][i] : vals[s][i];
      }
    }
  } else {
    for (int col = t * VEC; col < D; col += TPR * VEC) {
      load8(xr + col, vals[0]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum += rms ? vals[0][i] * vals[0][i] : vals[0][i];
    }
  }
  sum = group_sum<TPR>(sum, scratch);

  float mu = 0.f;
  float ms;
  if (rms) {
    ms = sum * inv_d;
  } else {
    mu = sum * inv_d;
    float sq = 0.f;
    if (CACHED) {
#pragma unroll
      for (int s = 0; s < MAX_STEPS; ++s) {
        const int col = (s * TPR + t) * VEC;
        if (col < D) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float c = vals[s][i] - mu;
            sq += c * c;
          }
        }
      }
    } else {
      for (int col = t * VEC; col < D; col += TPR * VEC) {
        load8(xr + col, vals[0]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float c = vals[0][i] - mu;
          sq += c * c;
        }
      }
    }
    ms = group_sum<TPR>(sq, scratch) * inv_d;
  }
  const float inv = 1.0f / sqrtf(ms + eps);

  auto finish = [&](int col, float (&v)[VEC]) {
    float g[VEC];
    load8(gamma + col, g);
    float y[VEC];
    if (rms) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) y[i] = v[i] * inv * g[i];
    } else {
      float b[VEC];
      load8(beta + col, b);
#pragma unroll
      for (int i = 0; i < VEC; ++i) y[i] = (v[i] - mu) * inv * g[i] + b[i];
    }
    store8(outr + col, y);
  };
  if (CACHED) {
#pragma unroll
    for (int s = 0; s < MAX_STEPS; ++s) {
      const int col = (s * TPR + t) * VEC;
      if (col < D) finish(col, vals[s]);
    }
  } else {
    for (int col = t * VEC; col < D; col += TPR * VEC) {
      load8(xr + col, vals[0]);
      finish(col, vals[0]);
    }
  }
}

template <typename T>
void launch(const void* x, const void* gamma, const void* beta, void* out,
            long long rows, int D, float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  T* op = static_cast<T*>(out);
  if (D <= 1024) {
    const unsigned blocks = (unsigned)((rows + 3) / 4);
    fused_norm_kernel<T, 32, true><<<blocks, 128, 0, stream>>>(xp, gp, bp, op, rows, D, eps);
  } else if (D <= 256 * VEC * MAX_STEPS) {
    fused_norm_kernel<T, 256, true><<<(unsigned)rows, 256, 0, stream>>>(xp, gp, bp, op, rows, D, eps);
  } else {
    fused_norm_kernel<T, 256, false><<<(unsigned)rows, 256, 0, stream>>>(xp, gp, bp, op, rows, D, eps);
  }
}

}  // namespace

// x, out: [rows, D] of `dtype` (0 float32, 1 float16, 2 bfloat16), 16-byte
// aligned; gamma, beta: float32 [D], beta null for RMSNorm; D % 8 == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int ct2_fused_norm(const void* x, const void* gamma, const void* beta,
                              void* out, long long rows, int D, float eps,
                              int dtype, void* stream) {
  if (D <= 0 || D % VEC != 0 || rows < 0 || rows > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, gamma, beta, out, rows, D, eps, s);
  } else if (dtype == 1) {
    launch<__half>(x, gamma, beta, out, rows, D, eps, s);
  } else if (dtype == 2) {
    launch<__nv_bfloat16>(x, gamma, beta, out, rows, D, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
