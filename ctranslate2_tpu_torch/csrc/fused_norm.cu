// Fused residual add + LayerNorm / RMSNorm + int8 quantization for Hopper
// (sm_90a).
//
// Replaces ctranslate2_tpu/kernels/norms.py::fused_norm (the Pallas kernel
// _ln_kernel), and takes in the eager work that sits on either side of a
// norm in the port's layers: the residual add before it and, under W8A8,
// the per-row int8 quantization after it (ops/linear.py::quantize_per_row).
// For x and an optional r [rows, D] (f32, f16 or bf16, one type), gamma and
// optional beta [D] (f32) it computes, per row,
//
//     s = round_T(f32(x) + f32(r))     (x itself without r; the single
//                                        rounding of torch's add in T)
//     LayerNorm (beta given):  mu = mean(s); sc = s - mu;
//                              y = sc / sqrt(mean(sc * sc) + eps) * gamma + beta
//     RMSNorm (no beta):       y = s / sqrt(mean(s * s) + eps) * gamma
//
// in float32 (the variance is the centered one, a second pass over the
// row), rounds y to T, and writes any of:
//
//     s      [rows, D] T    the new residual stream (where a later add reads it)
//     y      [rows, D] T
//     q      [rows, D] int8 rint(y * scale) clamped to [-128, 127] (half to even)
//     scale  [rows]    f32  127 / max|y| by IEEE division, 1 where max|y| == 0
//
// q and scale are what quantize_per_row gives for the T-rounded y: the row
// max runs over y as stored, not over the float32 y, and the division and
// multiply are IEEE (this file is built without fast math).
//
// What bounds it on the H100: bytes. Each element is read once (twice with
// r) and written once or twice, with about twenty operations spent on it,
// so the least time is the bytes moved (x, r, s, y, q, scale, gamma, beta)
// over 3.35 TB/s. The eager sequence it replaces spends an add, the norm
// and about twelve launches of quantization, each a round trip through
// device memory; this is one launch and one round trip.
//
// Design: a group of threads owns one row and keeps it in registers between
// the passes (statistics, then y and its row max, then q). The per-thread
// array is sized from D (STEPS loads of V elements a thread): a warp per
// row up to D = 1,024 (four rows per 128-thread block), then one block of
// 128 to 1,024 threads per row: at D = 4,096 in a half type 256 threads
// with two 16-byte loads each in flight (with r, four), or, for fewer rows
// than FEW_ROWS (a decode step's), 512 threads of one load, since a call
// with few rows lasts as long as one row's chain of dependent steps. Where
// D is a multiple of 8, loads and stores are 16 bytes wide for the half
// types (8 elements), two 16-byte loads for float32 and 8 bytes for q; any
// other D takes a scalar instance (V = 1), with the same arithmetic. A row
// longer than the register budget (STEPS = 0: D > 32,768, or > 4,096 off a
// multiple of 8) is read again from device memory (in practice from L2) in
// each pass.
// Rows need no padding: zero padding would enter LayerNorm's centred
// variance. Every row sum runs in one fixed order, so a row's results do
// not depend on its neighbours or on the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float& o, float v) { o = v; }
__device__ __forceinline__ void from_f32(__half& o, float v) { o = __float2half_rn(v); }
__device__ __forceinline__ void from_f32(__nv_bfloat16& o, float v) { o = __float2bfloat16_rn(v); }

// v rounded to T and back (exact for float).
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  T o;
  from_f32(o, v);
  return to_f32(o);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float (&out)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f32(pk.v[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* p, const float (&in)[V]) {
  Pack<T, V> pk;
#pragma unroll
  for (int i = 0; i < V; ++i) from_f32(pk.v[i], in[i]);
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

// q = rint(v * scale) clamped to [-128, 127], V bytes in one store.
template <int V>
__device__ __forceinline__ void store_q(int8_t* p, const float (&v)[V], float scale) {
  Pack<int8_t, V> pk;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float r = fminf(fmaxf(rintf(v[i] * scale), -128.0f), 127.0f);
    pk.v[i] = static_cast<int8_t>(static_cast<int>(r));
  }
  *reinterpret_cast<Pack<int8_t, V>*>(p) = pk;
}

// Sum (or max) over the TPR threads that share a row: warp shuffles, then,
// for TPR > 32, the warps' results through `scratch` (one slot per
// reduction of a row, so one barrier each). Every thread gets the result,
// summed in the same order.
template <int TPR, bool MAX>
__device__ __forceinline__ float row_reduce(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  if (TPR == 32) return v;
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = scratch[0];
#pragma unroll
  for (int w = 1; w < TPR / 32; ++w) total = MAX ? fmaxf(total, scratch[w]) : total + scratch[w];
  return total;
}

struct NormArgs {
  const void* x;
  const void* r;      // null: no residual
  const float* gamma;
  const float* beta;  // null: RMSNorm
  void* s;            // null: the sum is not written
  void* y;            // null: y is not written
  int8_t* q;          // null: no quantization (then scale is null too)
  float* scale;
  long long rows;
  int D;
  float eps;
};

// V elements a load (8, or 1 for D off a multiple of 8); TPR threads a
// row (32: a warp, four rows a block); STEPS loads a thread kept in
// registers (0: the row is read again in each pass). No output aliases an
// input (the wrapper allocates them), hence __restrict__.
template <typename T, int V, int TPR, int STEPS>
__global__ void __launch_bounds__(TPR == 32 ? 128 : TPR)
fused_norm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  T* __restrict__ s, T* __restrict__ y, int8_t* __restrict__ q,
                  float* __restrict__ scale, const long long rows, const int D,
                  const float eps) {
  constexpr bool CACHED = STEPS > 0;
  constexpr int NS = CACHED ? STEPS : 1;
  constexpr int RPB = TPR == 32 ? 4 : 1;
  __shared__ float scratch[3][TPR / 32];
  const long long row = (long long)blockIdx.x * RPB + (TPR == 32 ? (threadIdx.x >> 5) : 0);
  const int t = TPR == 32 ? (threadIdx.x & 31) : threadIdx.x;
  // A warp whose row lies past the end has nothing to do (with TPR == 32
  // no block-wide barrier is used; otherwise the grid has one block a row).
  if (row >= rows) return;
  const T* xr = x + row * D;
  const T* rr = r ? r + row * D : nullptr;
  T* sr = s ? s + row * D : nullptr;
  T* yr = y ? y + row * D : nullptr;
  int8_t* qr = q ? q + row * D : nullptr;
  const bool rms = beta == nullptr;
  const float inv_d = 1.0f / (float)D;

  // The row's input at `col`: s = round_T(x + r), or x.
  auto input = [&](int col, float (&v)[V]) {
    load_v<T, V>(xr + col, v);
    if (rr) {
      float w[V];
      load_v<T, V>(rr + col, w);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = round_t<T>(v[i] + w[i]);
    }
  };

  // Pass 1: the input (written as s where asked) and its sum / sum of squares.
  float vals[NS][V];
  float sum = 0.f;
  auto first = [&](int col, float (&v)[V]) {
    input(col, v);
    if (sr) store_v<T, V>(sr + col, v);
#pragma unroll
    for (int i = 0; i < V; ++i) sum += rms ? v[i] * v[i] : v[i];
  };
  if (CACHED) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int col = (k * TPR + t) * V;
      if (col < D) first(col, vals[k]);
    }
  } else {
    for (int col = t * V; col < D; col += TPR * V) first(col, vals[0]);
  }
  sum = row_reduce<TPR, false>(sum, scratch[0]);

  float mu = 0.f;
  float ms;
  if (rms) {
    ms = sum * inv_d;
  } else {
    mu = sum * inv_d;
    float sq = 0.f;
    auto centred = [&](const float (&v)[V]) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float c = v[i] - mu;
        sq += c * c;
      }
    };
    if (CACHED) {
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        if ((k * TPR + t) * V < D) centred(vals[k]);
      }
    } else {
      for (int col = t * V; col < D; col += TPR * V) {
        input(col, vals[0]);
        centred(vals[0]);
      }
    }
    ms = row_reduce<TPR, false>(sq, scratch[1]) * inv_d;
  }
  const float inv = 1.0f / sqrtf(ms + eps);

  // Pass 2: y rounded to T, in place (written where asked), and its row max.
  float amax = 0.f;
  auto normed = [&](int col, float (&v)[V]) {
    float g[V];
    load_v<float, V>(gamma + col, g);
    if (rms) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = round_t<T>(v[i] * inv * g[i]);
    } else {
      float b[V];
      load_v<float, V>(beta + col, b);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = round_t<T>((v[i] - mu) * inv * g[i] + b[i]);
    }
  };
  auto second = [&](int col, float (&v)[V]) {
    normed(col, v);
    if (yr) store_v<T, V>(yr + col, v);
#pragma unroll
    for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(v[i]));
  };
  if (CACHED) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int col = (k * TPR + t) * V;
      if (col < D) second(col, vals[k]);
    }
  } else {
    for (int col = t * V; col < D; col += TPR * V) {
      input(col, vals[0]);
      second(col, vals[0]);
    }
  }
  if (!qr) return;  // uniform over the row's threads

  // Pass 3: the int8 row.
  amax = row_reduce<TPR, true>(amax, scratch[2]);
  const float qs = amax > 0.f ? 127.0f / amax : 1.0f;
  if (t == 0) scale[row] = qs;
  if (CACHED) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int col = (k * TPR + t) * V;
      if (col < D) store_q<V>(qr + col, vals[k], qs);
    }
  } else {
    for (int col = t * V; col < D; col += TPR * V) {
      input(col, vals[0]);
      normed(col, vals[0]);
      store_q<V>(qr + col, vals[0], qs);
    }
  }
}

template <typename T, int V, int TPR, int STEPS>
void launch_cfg(const NormArgs& a, cudaStream_t stream) {
  constexpr int RPB = TPR == 32 ? 4 : 1;
  const unsigned blocks = (unsigned)((a.rows + RPB - 1) / RPB);
  fused_norm_kernel<T, V, TPR, STEPS><<<blocks, TPR * RPB, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.r), a.gamma, a.beta,
      static_cast<T*>(a.s), static_cast<T*>(a.y), a.q, a.scale, a.rows, a.D, a.eps);
}

// Fewer rows than this leave most SMs idle: the call's time is then one
// row's chain of dependent steps, which is shortest with one load a thread.
constexpr long long FEW_ROWS = 256;

// The row group of a width: a warp per row up to D = 1,024; past it, for
// few rows one 16-byte load a thread (the shortest chain), else two (at
// [8,192, 4,096] in float16, 256 threads of two loads ran ahead of 128 of
// four and of 512 of one).
template <typename T>
void launch(const NormArgs& a, cudaStream_t s) {
  const int D = a.D;
  if (D % 8 == 0) {
    if (D <= 256) launch_cfg<T, 8, 32, 1>(a, s);
    else if (D <= 512) launch_cfg<T, 8, 32, 2>(a, s);
    else if (D <= 1024) launch_cfg<T, 8, 32, 4>(a, s);
    else if (a.rows < FEW_ROWS && D <= 2048) launch_cfg<T, 8, 256, 1>(a, s);
    else if (a.rows < FEW_ROWS && D <= 4096) launch_cfg<T, 8, 512, 1>(a, s);
    else if (a.rows < FEW_ROWS && D <= 8192) launch_cfg<T, 8, 1024, 1>(a, s);
    else if (D <= 2048) launch_cfg<T, 8, 128, 2>(a, s);
    else if (D <= 4096) launch_cfg<T, 8, 256, 2>(a, s);
    else if (D <= 8192) launch_cfg<T, 8, 512, 2>(a, s);
    else if (D <= 16384) launch_cfg<T, 8, 1024, 2>(a, s);
    else if (D <= 32768) launch_cfg<T, 8, 1024, 4>(a, s);
    else launch_cfg<T, 8, 256, 0>(a, s);
  } else {
    if (D <= 128) launch_cfg<T, 1, 32, 4>(a, s);
    else if (D <= 512) launch_cfg<T, 1, 128, 4>(a, s);
    else if (D <= 2048) launch_cfg<T, 1, 512, 4>(a, s);
    else if (D <= 4096) launch_cfg<T, 1, 1024, 4>(a, s);
    else launch_cfg<T, 1, 256, 0>(a, s);
  }
}

}  // namespace

// x, r, s, y: [rows, D] of `dtype` (0 float32, 1 float16, 2 bfloat16),
// 16-byte aligned where D % 8 == 0 (any D > 0 is taken; other widths load
// one element at a time); gamma, beta: float32 [D], beta null for RMSNorm;
// q int8 [rows, D] (8-byte aligned where D % 8 == 0) and scale f32 [rows].
// r null: no residual; s, y, q null: not written (q and scale together; at
// least one of y and q). Returns cudaGetLastError() after the launch.
extern "C" int ct2_fused_norm(const void* x, const void* r, const void* gamma,
                              const void* beta, void* s, void* y, void* q,
                              void* scale, long long rows, int D, float eps,
                              int dtype, void* stream) {
  if (D <= 0 || rows < 0 || rows > 2147483647LL || (y == nullptr && q == nullptr) ||
      ((q == nullptr) != (scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const NormArgs a{x, r, static_cast<const float*>(gamma), static_cast<const float*>(beta),
                   s, y, static_cast<int8_t*>(q), static_cast<float*>(scale), rows, D, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(a, st);
  } else if (dtype == 1) {
    launch<__half>(a, st);
  } else if (dtype == 2) {
    launch<__nv_bfloat16>(a, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
