// AWQ-W4 GEMMs for Hopper (sm_90a): float activations x 4-bit group-quantized
// weights, f32 output.
//
// Replaces four Pallas kernels of ctranslate2_tpu/kernels/quant_matmul.py,
// one entry point with two compile-time axes:
//
//   payload   int8 (q - z) [K, N]            |  packed nibbles [K/2, N]
//   scale     per group, f32 accumulate       |  folded into the weight tile
//
//   matmul_w4a16       (q - z), per group:  acc += (x_g . w_g) * s[g, n]
//   matmul_w4p         nibbles, per group:  acc += (x_g . q_g) * s[g, n]
//                                                 - rowsum(x_g) * zs[g, n]
//   matmul_w4a16_fold  (q - z), folded:     acc += x . half((q - z) * s)
//   matmul_w4p_fold    nibbles, folded:     acc += x . half(q * s); the
//                      zero-point term rowsum_g(x) @ zs runs outside.
//
// The packed byte at row r carries logical row r (low nibble) and row
// r + K/2 (high nibble); bytes are read unsigned. G divides K and is a
// multiple of 16, so one mma k-step lies in one group; packed, (K/2) % G == 0
// too, so the two halves of a byte row reach their group ends together.
//
// What bounds it on the H100: at the decode shapes (M = 4) the weight bytes
// (half a byte a weight packed, one unpacked, plus the scales) over
// 3.35 TB/s; at the prefill shapes (M = 8,192) the 2*M*N*K operations over
// the tensor cores' 989 TFLOP/s in f16/bf16.
//
// Design (f16/bf16): a plain, right-first kernel. Each 128-thread block
// computes a 64 x 64 output tile, each of its four warps a 32 x 32 sub-tile
// with mma.sync.m16n8k16 and f32 accumulators. Per stage of 32 payload rows
// the block loads x's tiles (two for the packed payload: columns r and
// r + K/2) and one 16-byte chunk of payload per thread, unpacks it with
// shifts and masks into f16/bf16 tiles in shared memory (exact: |q - z| and
// q are at most 15), and the warps read the B fragments with
// ldmatrix.trans. The non-folded forms keep a partial accumulator per half
// and fold it into the output accumulator at each group's end with the f32
// scale (and, packed, the f32 row sums of the same x tile times zs). Warps
// whose rows lie past M skip their products. float32 activations take a
// plain-FMA kernel of the same arithmetic (no rounding to a half type).
// Left for later work: cp.async/TMA pipelining, wgmma, split-K or a
// narrower tile for the decode shapes, where 64-row tiles waste most of each
// mma and a 4,096-wide output gives only 64 blocks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct W4Params {
  const unsigned short* x16;  // [M, K] f16/bf16 bits (or null)
  const float* x32;           // [M, K] f32 (or null)
  const uint8_t* w;           // [K, N] int8 (q - z), or [K/2, N] nibbles
  const float* scale;         // [K/G, N]
  const float* zs;            // [K/G, N] (packed, not folded) or null
  float* out;                 // [M, N]
  int M, N, K, G;
  int vec;                    // 16-byte payload loads allowed
};

template <typename T>
struct Half;

template <>
struct Half<__half> {
  static __device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ unsigned short bits(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
  static __device__ __forceinline__ float value(unsigned short b) {
    return __half2float(__ushort_as_half(b));
  }
};

template <>
struct Half<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ unsigned short bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float value(unsigned short b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
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

// The 16 payload bytes of row k, columns [n, n + 16), zero past the edges.
__device__ __forceinline__ void load_payload(uint8_t (&bytes)[16], const W4Params& p,
                                             int k, int rows, int n) {
  if (k < rows && p.vec && n + 16 <= p.N) {
    *reinterpret_cast<uint4*>(bytes) =
        *reinterpret_cast<const uint4*>(p.w + (size_t)k * p.N + n);
    return;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
    bytes[j] = (k < rows && n + j < p.N) ? p.w[(size_t)k * p.N + n + j] : 0;
}

// The weight value of payload byte `b` in half `h` (packed: 0 low nibble,
// 1 high nibble; unpacked: the signed byte).
template <bool PACKED>
__device__ __forceinline__ float payload_value(uint8_t b, int h) {
  if (PACKED) return (float)(h == 0 ? (b & 0xF) : (b >> 4));
  return (float)(int8_t)b;
}

// ---------------------------------------------------------------------------
// f16 / bf16: tensor-core kernel.
// ---------------------------------------------------------------------------

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;            // payload rows per stage
constexpr int LDA = BK + 8;       // shared row stride of x tiles (elements)
constexpr int LDB = BN + 8;       // shared row stride of weight tiles
constexpr int THREADS = 128;
constexpr int MT = 2;             // m16 tiles per warp
constexpr int NT = 4;             // n8 tiles per warp

template <typename T, bool PACKED, bool FOLD>
__global__ void __launch_bounds__(THREADS) w4_mma_kernel(const W4Params p) {
  constexpr int H = PACKED ? 2 : 1;        // halves of a payload row
  constexpr bool ZERO = PACKED && !FOLD;   // the zero-point term in-kernel
  constexpr int KS = BK / 16;
  __shared__ __align__(16) unsigned short As[H][BM * LDA];
  __shared__ __align__(16) unsigned short Bs[H][BK * LDB];
  __shared__ float Xs[ZERO ? H : 1][BM][KS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const int rows = PACKED ? p.K / 2 : p.K;  // payload rows = rows of a half

  float acc[MT][NT][4];
  float part[H][MT][NT][4];
  float xs[H][MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[i][j][r] = 0.f;
#pragma unroll
        for (int h = 0; h < H; ++h) part[h][i][j][r] = 0.f;
      }
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < MT; ++i) xs[h][i][0] = xs[h][i][1] = 0.f;

  for (int r0 = 0; r0 < rows; r0 += BK) {
    // x tiles: columns [r0, r0 + BK) of each half, 8 elements a chunk.
    for (int c = tid; c < H * BM * (BK / 8); c += THREADS) {
      const int h = c / (BM * (BK / 8));
      const int rem = c % (BM * (BK / 8));
      const int row = rem / (BK / 8);
      const int col = (rem % (BK / 8)) * 8;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + row < p.M && r0 + col < rows)
        v = *reinterpret_cast<const int4*>(p.x16 + (size_t)(m0 + row) * p.K +
                                           h * rows + r0 + col);
      *reinterpret_cast<int4*>(&As[h][row * LDA + col]) = v;
    }
    // Payload: one 16-byte chunk a thread, unpacked into each half's tile.
    {
      const int r = tid / (BN / 16);
      const int c = (tid % (BN / 16)) * 16;
      uint8_t bytes[16];
      load_payload(bytes, p, r0 + r, rows, n0 + c);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float* srow = p.scale + (size_t)((h * rows + r0 + r) / p.G) * p.N;
        __align__(16) unsigned short vals[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float v = payload_value<PACKED>(bytes[j], h);
          if (FOLD) v *= (r0 + r < rows && n0 + c + j < p.N) ? srow[n0 + c + j] : 0.f;
          vals[j] = Half<T>::bits(v);
        }
        int4* dst = reinterpret_cast<int4*>(&Bs[h][r * LDB + c]);
        dst[0] = reinterpret_cast<const int4*>(vals)[0];
        dst[1] = reinterpret_cast<const int4*>(vals)[1];
      }
    }
    __syncthreads();
    if (ZERO) {
      // Row sums of x over each k-step, in f32, for the zero-point term.
      for (int c = tid; c < H * BM * KS; c += THREADS) {
        const int h = c / (BM * KS);
        const int row = (c / KS) % BM;
        const int kk = c % KS;
        const unsigned short* a = &As[h][row * LDA + kk * 16];
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) s += Half<T>::value(a[j]);
        Xs[ZERO ? h : 0][row][kk] = s;
      }
      __syncthreads();
    }

#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (r0 + kk * 16 >= rows) break;  // rows % 16 == 0: whole k-steps
#pragma unroll
      for (int h = 0; h < H; ++h) {
        unsigned bf[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          ldmatrix_x2_trans(bf[j][0], bf[j][1],
                            &Bs[h][(kk * 16 + (lane & 15)) * LDB + wn + j * 8]);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (m0 + wm + i * 16 >= p.M) continue;  // warp-uniform
          const unsigned short* a = &As[h][(wm + i * 16 + g) * LDA + kk * 16 + 2 * t];
          const unsigned af[4] = {ld32(a), ld32(a + 8 * LDA), ld32(a + 8),
                                  ld32(a + 8 * LDA + 8)};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (FOLD) Half<T>::mma(acc[i][j], af, bf[j][0], bf[j][1]);
            else Half<T>::mma(part[h][i][j], af, bf[j][0], bf[j][1]);
          }
          if (ZERO) {
            xs[h][i][0] += Xs[ZERO ? h : 0][wm + i * 16 + g][kk];
            xs[h][i][1] += Xs[ZERO ? h : 0][wm + i * 16 + g + 8][kk];
          }
        }
      }
      if (!FOLD && (r0 + kk * 16 + 16) % p.G == 0) {
        // A group ends in both halves: scale the partial sums into acc.
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const size_t grp = (size_t)((h * rows + r0 + kk * 16) / p.G);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = n0 + wn + j * 8 + 2 * t + e;
              const float s = col < p.N ? p.scale[grp * p.N + col] : 0.f;
              const float z = (ZERO && col < p.N) ? p.zs[grp * p.N + col] : 0.f;
#pragma unroll
              for (int i = 0; i < MT; ++i) {
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                  float v = part[h][i][j][2 * hh + e] * s;
                  if (ZERO) v -= xs[h][i][hh] * z;
                  acc[i][j][2 * hh + e] += v;
                  part[h][i][j][2 * hh + e] = 0.f;
                }
              }
            }
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) xs[h][i][0] = xs[h][i][1] = 0.f;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + i * 16 + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn + j * 8 + 2 * t + (r & 1);
        if (row < p.M && col < p.N) p.out[(size_t)row * p.N + col] = acc[i][j][r];
      }
}

// ---------------------------------------------------------------------------
// float32: plain-FMA kernel of the same arithmetic.
// ---------------------------------------------------------------------------

constexpr int FB = 64;        // output tile is FB x FB
constexpr int FK = 16;        // payload rows per stage: one k-step, one group
constexpr int FTHREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

template <bool PACKED, bool FOLD>
__global__ void __launch_bounds__(FTHREADS) w4_fma_kernel(const W4Params p) {
  constexpr int H = PACKED ? 2 : 1;
  constexpr bool ZERO = PACKED && !FOLD;
  __shared__ float As[H][FK][FB + 4];  // x tile, transposed: [k][m]
  __shared__ float Bs[H][FK][FB];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * FB;
  const int n0 = blockIdx.x * FB;
  const int rows = PACKED ? p.K / 2 : p.K;

  float acc[4][4], part[H][4][4], xs[H][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) part[h][i][j] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < H; ++h) xs[h][i] = 0.f;
  }

  for (int r0 = 0; r0 < rows; r0 += FK) {  // rows % 16 == 0
    for (int c = tid; c < H * FB * FK; c += FTHREADS) {
      const int h = c / (FB * FK);
      const int row = (c / FK) % FB;
      const int k = c % FK;
      As[h][k][row] = m0 + row < p.M
          ? p.x32[(size_t)(m0 + row) * p.K + h * rows + r0 + k] : 0.f;
    }
    for (int c = tid; c < FK * FB; c += FTHREADS) {
      const int r = c / FB;
      const int col = n0 + c % FB;
      const uint8_t b = col < p.N ? p.w[(size_t)(r0 + r) * p.N + col] : 0;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float v = payload_value<PACKED>(b, h);
        if (FOLD)
          v *= col < p.N ? p.scale[(size_t)((h * rows + r0 + r) / p.G) * p.N + col] : 0.f;
        Bs[h][r][c % FB] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < H; ++h) {
#pragma unroll
      for (int k = 0; k < FK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[h][k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[h][k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (FOLD) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            else part[h][i][j] = fmaf(a[i], b[j], part[h][i][j]);
          }
          if (ZERO) xs[h][i] += a[i];
        }
      }
    }
    if (!FOLD && (r0 + FK) % p.G == 0) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const size_t grp = (size_t)((h * rows + r0) / p.G);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + tx + 16 * j;
          const float s = col < p.N ? p.scale[grp * p.N + col] : 0.f;
          const float z = (ZERO && col < p.N) ? p.zs[grp * p.N + col] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float v = part[h][i][j] * s;
            if (ZERO) v -= xs[h][i] * z;
            acc[i][j] += v;
            part[h][i][j] = 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) xs[h][i] = 0.f;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty + 16 * i;
      const int col = n0 + tx + 16 * j;
      if (row < p.M && col < p.N) p.out[(size_t)row * p.N + col] = acc[i][j];
    }
}

template <bool PACKED, bool FOLD>
void launch(const W4Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    dim3 grid((p.N + FB - 1) / FB, (p.M + FB - 1) / FB);
    w4_fma_kernel<PACKED, FOLD><<<grid, FTHREADS, 0, stream>>>(p);
    return;
  }
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  if (dtype == 1)
    w4_mma_kernel<__half, PACKED, FOLD><<<grid, THREADS, 0, stream>>>(p);
  else
    w4_mma_kernel<__nv_bfloat16, PACKED, FOLD><<<grid, THREADS, 0, stream>>>(p);
}

}  // namespace

// Launches one W4 product on `stream`: x [M, K] (dtype 0 f32, 1 f16,
// 2 bf16), payload `w` ([K, N] int8 (q - z), or [K/2, N] nibbles when
// `packed`), f32 `scale` [K/G, N], f32 `zs` [K/G, N] for the packed,
// non-folded form (else null), f32 `out` [M, N]. The caller checks the
// shapes: G divides K, G % 16 == 0, packed (K/2) % G == 0, M <= 65,535 * 64,
// x 16-byte aligned. `vec` (0/1) allows 16-byte payload loads: N % 16 == 0
// and an aligned payload. Returns cudaGetLastError() after the launch.
extern "C" int ct2_w4_gemm(const void* x, const void* w, const void* scale,
                           const void* zs, void* out, int M, int N, int K,
                           int G, int dtype, int packed, int fold, int vec,
                           void* stream) {
  W4Params p;
  p.x16 = dtype == 0 ? nullptr : static_cast<const unsigned short*>(x);
  p.x32 = dtype == 0 ? static_cast<const float*>(x) : nullptr;
  p.w = static_cast<const uint8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.zs = static_cast<const float*>(zs);
  p.out = static_cast<float*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.G = G;
  p.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0 && N > 0) {
    if (packed && fold) launch<true, true>(p, dtype, s);
    else if (packed) launch<true, false>(p, dtype, s);
    else if (fold) launch<false, true>(p, dtype, s);
    else launch<false, false>(p, dtype, s);
  }
  return static_cast<int>(cudaGetLastError());
}
