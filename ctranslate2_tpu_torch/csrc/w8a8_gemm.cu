// W8A8 GEMM for Hopper (sm_90a): int8 x int8 -> int32, f32 dequant epilogue.
//
// Replaces ctranslate2_tpu/kernels/quant_matmul.py::matmul_w8a8 (the Pallas
// kernel _w8a8_kernel). It computes, for q int8 [M, K] (row-major) and
// w int8 [N, K] (row-major, i.e. K-major per output column, the layout
// model.bin stores):
//
//     out[m, n] = float(sum_k q[m, k] * w[n, k]) / (a_scale[m] * w_scale[n])
//
// with a_scale[m] == 0 read as 1. The int32 sum is exact and the epilogue
// is one IEEE f32 multiply and one IEEE f32 divide (no fast math), so the
// result is bit-equal to the plain PyTorch version in quant_matmul.py.
//
// What bounds it on the H100: the main path's shapes are small-M decode
// GEMMs (M = batch * beam = 128 rows against K = 512..2048 and N up to the
// 32,000-word vocabulary). There the weight bytes dominate (N * K read once
// per call), so the call is bound by device memory (3.35 TB/s); only the
// encoder's M = 2048 GEMMs approach the int8 tensor-core rate
// (1,979 TOP/s dense).
//
// Design: a plain, right-first kernel. Each 128-thread block computes a
// 64 x 64 output tile; each of its four warps a 32 x 32 sub-tile with
// mma.sync.m16n8k32 (s8 x s8 -> s32), which takes both operands K-major
// ("row.col"), so the weights need no transpose. 64-byte-deep K slices of
// both operands are staged through shared memory with 16-byte vector loads;
// shared rows are padded to 80 bytes so the fragment loads hit 32 distinct
// banks. Ragged M, N and K edges are masked in the kernel (zero fill on
// load, bounds check on store): no row padding as on the TPU. What it
// leaves for later work: no cp.async/TMA pipelining, no wgmma, and small-M
// grids that leave most SMs idle (a split-K or narrower-tile variant is the
// next step for the decode shapes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // shared row stride in bytes (bank spread)
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copies 16 bytes of row `row` starting at column `col` into shared memory,
// zero-filling whatever lies outside the [rows, K] matrix.
__device__ __forceinline__ void load_chunk(int8_t* dst, const int8_t* src,
                                           int row, int rows, int col, int K,
                                           bool vec) {
  if (row < rows && vec && col + 16 <= K) {
    *reinterpret_cast<int4*>(dst) =
        *reinterpret_cast<const int4*>(src + (size_t)row * K + col);
    return;
  }
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    dst[b] = (row < rows && col + b < K) ? src[(size_t)row * K + col + b] : 0;
  }
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__global__ void __launch_bounds__(THREADS)
w8a8_gemm_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w,
                 const float* __restrict__ a_scale,
                 const float* __restrict__ w_scale, float* __restrict__ out,
                 int M, int N, int K, int vec) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma threadID_in_group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * (BK / 16); c += THREADS) {
      const int r = c / (BK / 16);
      const int col = (c % (BK / 16)) * 16;
      load_chunk(As + r * LDS + col, q, m0 + r, M, k0 + col, K, vec);
      load_chunk(Bs + r * LDS + col, w, n0 + r, N, k0 + col, K, vec);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[2][4];
      unsigned bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* a = As + (wm + i * 16 + g) * LDS + kk + t * 4;
        af[i][0] = lds32(a);
        af[i][1] = lds32(a + 8 * LDS);
        af[i][2] = lds32(a + 16);
        af[i][3] = lds32(a + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* b = Bs + (wn + j * 8 + g) * LDS + kk + t * 4;
        bf[j][0] = lds32(b);
        bf[j][1] = lds32(b + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + i * 16 + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn + j * 8 + t * 2 + (r & 1);
        if (row < M && col < N) {
          float as = a_scale[row];
          if (as == 0.0f) as = 1.0f;
          out[(size_t)row * N + col] =
              __int2float_rn(acc[i][j][r]) / (as * w_scale[col]);
        }
      }
    }
  }
}

}  // namespace

// Launches the GEMM on `stream`. `vec` (0/1) allows 16-byte loads: the
// caller sets it when K % 16 == 0 and both int8 operands are 16-byte
// aligned. Returns cudaGetLastError() after the launch.
extern "C" int ct2_w8a8_gemm(const void* q, const void* w, const void* a_scale,
                             const void* w_scale, void* out, int M, int N,
                             int K, int vec, void* stream) {
  if (M > 0 && N > 0) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    w8a8_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(w),
        static_cast<const float*>(a_scale), static_cast<const float*>(w_scale),
        static_cast<float*>(out), M, N, K, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
