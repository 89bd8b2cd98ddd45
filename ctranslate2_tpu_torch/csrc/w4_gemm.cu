// AWQ-W4 GEMMs for Hopper (sm_90a): float activations x 4-bit group-quantized
// weights, f32 output.
//
// Replaces four Pallas kernels of ctranslate2_tpu/kernels/quant_matmul.py,
// one source with two compile-time axes:
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
// (half a byte a weight packed, one unpacked, plus the f32 scales) over
// 3.35 TB/s: 2.8 / 4.3 / 9.9 / 9.9 us packed at (K, N) = (4096, 4096) /
// (4096, 6144) / (4096, 14336) / (14336, 4096); at the prefill shapes
// (M = 8,192) the 2*M*N*K operations over the tensor cores' 989 TFLOP/s in
// f16/bf16. The wrapper picks one of three paths per shape with
// quant_matmul.w4_plan:
//
// 1. Split-K, swap-AB, for small M (ct2_w4_gemm_splitk; the four forms in
//    f16/bf16). At M = 4 a 64-row output tile wastes 15/16 of
//    each mma and N = 4,096 gives 64 blocks for 132 SMs. Here the weights are
//    the A operand of mma.sync.m16n8k16 (16 output columns a warp) and x its B
//    operand (8 rows an n-tile, XR / 8 n-tiles for XR = 8..64 rows a block), so
//    M = 4 uses half of each mma. A 128-thread block owns 64 output columns x
//    XR rows x one slice of the payload rows; the plan splits K until the grid
//    holds about eight blocks an SM, on group boundaries (a slice is a multiple
//    of G payload rows; packed, rows [r0, r1) also carry k in [r0 + K/2, r1 +
//    K/2), on group boundaries since (K/2) % G == 0). The block streams 64-row
//    payload stages and the matching x stages (both halves' columns, packed)
//    through a 3-stage cp.async ring: at the M = 4 shapes, 3 stages and eight
//    blocks an SM ran faster on the card than 4 stages and four blocks, and
//    128-column blocks or deeper rings were no faster for matmul_w4p. Each
//    thread copies the same chunks of every stage, and a group's end is counted
//    down, so the loop holds no integer division. A warp reads its 16 x 16
//    payload bytes of a k-step with one ldmatrix.x2.trans, which hands each
//    thread the bytes of columns 2g and 2g + 1 at rows 2t, 2t + 1 (+ 8):
//    exactly the A fragment of mma rows g and g + 8 if mma row i < 8 stands for
//    column 2i and row i + 8 for column 2i + 1. The bytes become f16/bf16 pairs
//    in registers with the magic-number trick (a nibble or a biased byte OR-ed
//    into the mantissa of 1024.0 or 128.0, then one subtract; exact for every
//    nibble and every int8); the unpacked payload in bf16 goes through f32 the
//    same way, since bf16's 7-bit mantissa cannot hold a biased byte. Each
//    group keeps a partial sum, folded into the output accumulator at the
//    group's end with the f32 scale s[g, n] and, packed, minus rowsum(x_g) *
//    zs[g, n]; the row sums come from the x fragments the warp already holds:
//    one more mma a k-step with an A of ones (up to 16 rows), else f32 adds and
//    four shuffles a group (32 and 64 rows, where the mma's accumulators would
//    cost too many registers). Slices meet in a deterministic sum: each writes
//    its f32 partial tile into a workspace [splits, M, N]; a per-tile counter
//    finds the last block, which adds the splits in slice order and writes out,
//    then re-zeroes its counter (zeroed once when the buffer is made, so a call
//    is one launch and no memset). The fixed order makes two calls on the same
//    inputs bit-equal, so the AWQ decode is the same run to run (float atomics
//    would add in arrival order). The folded forms (FOLD) keep the ring, the
//    fragments and the sum; dequant_fold multiplies each weight of the A
//    fragment by its column's f32 scale and rounds the product once to the
//    half type (as the tile does; rounding the scale first would round
//    twice), so each mma adds straight into the output accumulator: no group
//    partial, no group-end fold, no row sums. A group's scales are loaded a
//    group ahead.
// 2. wgmma + TMA, swap-AB, for large M (ct2_w4_gemm_wgmma; the four forms
//    in the same types). At the prefill shapes the product is bound by the
//    tensor cores, and the tile below ran at 70-78 TFLOP/s. One block owns
//    128 weight columns x 128 x rows over the whole K (a grouped raster of 8
//    x-row tiles, so the blocks in flight share their x panels in L2): one
//    producer warp issues the TMA loads of an 8-stage ring signalled by
//    mbarriers (a stage: the 128B-swizzled x box [128 rows x 64 k] of one
//    half and the payload box [64 rows x 128 columns]); two consumer
//    warpgroups run wgmma.mma_async.m64n128k16 with the weights as the A
//    operand from registers (64 columns each: warp w's A fragment of a k-step
//    is the split-K kernel's, one ldmatrix.x2.trans and the magic-number
//    conversion, so no dequantized weight goes through shared memory) and x as
//    the K-major B operand. setmaxnreg moves registers from the producer
//    warpgroup (40) to the consumers (232). Packed, the stages run half 0's
//    payload rows, then half 1's (each payload box is read twice), which
//    keeps one group partial a thread; the nibble half is a compile-time
//    constant, and in f16 the high nibble takes one AND and one HFMA2. Each
//    thread keeps an f32 partial (64 registers) and an f32 accumulator (64):
//    at each group end it waits for the group's wgmmas and folds acc +=
//    part * s[g, n] (- rowsum(x_g) * zs[g, n]); n is an accumulator row, so
//    a thread needs two scales and zero terms a group, loaded a group ahead.
//    The row sums come from a first launch (w4_rowsum_kernel: f32 sums of
//    x over each group into a workspace [K/G, M]) and reach each stage by
//    TMA, a [4 groups x 128 rows] slice beside the stage. For G % 64 == 0 a
//    stage's four wgmmas issue as one batch, committed before any branch
//    (in the SASS a branch between two wgmmas closes the batch, and a
//    commit after one opens an empty group that the wait then waits behind:
//    both measured slower); other G fold wherever their groups end. The
//    accumulator holds out^T: each thread stores two adjacent columns of 32
//    x rows as float2 (full 32-byte sectors), no workspace, no atomics, so
//    two calls are bit-equal and a CUDA graph can hold the launches. It
//    needs N % 16 == 0 and 16-byte aligned x and payload (TMA's rules).
//    The folded forms have a kernel of their own (w4_wgmma_fold_kernel):
//    the same producer, raster, fragments (dequant_fold) and stores, but
//    with the scale in the fragment one accumulator runs over the whole K,
//    so there is no partial, no group-end wait, no row sums and no first
//    launch. A half's four wgmmas of a stage issue back to back as one
//    commit group; groups alternate between two fragment buffers, and the
//    only wait retires the group before, freeing its fragments and, at a
//    stage's end, the ring slot. Packed, one pass over the payload: a stage
//    holds the payload box and both halves' x boxes (columns r and
//    r + K/2). The partial's 64 registers buy a wider x tile: 256 x rows a
//    block (m64n256k16, 128 accumulators a thread) where the 128-row grid
//    needs more than one wave of blocks, which halves the fragment
//    conversions per operation; the ring then holds 3 (packed) or 5 stages.
//    The zero-point term of matmul_w4p_fold stays outside, as in the JAX
//    package (the wrapper: f32 group sums of x, then one product).
// 3. The tile kernel (ct2_w4_gemm; every form, every M): a plain, right-first
//    kernel. Each 128-thread block computes a 64 x 64 output tile, each of
//    its four warps a 32 x 32 sub-tile with mma.sync.m16n8k16 and f32
//    accumulators. Per stage of 32 payload rows the block loads x's tiles
//    (two for the packed payload: columns r and r + K/2) and one 16-byte
//    chunk of payload per thread, unpacks it with shifts and masks into
//    f16/bf16 tiles in shared memory, and the warps read the B fragments
//    with ldmatrix.trans. The non-folded forms keep a partial accumulator
//    per half and fold it into the output accumulator at each group's end
//    with the f32 scale (and, packed, the f32 row sums of the same x tile
//    times zs). Warps whose rows lie past M skip their products. float32
//    activations take a plain-FMA kernel of the same arithmetic (no rounding
//    to a half type) on both paths' shapes. The plan keeps it for float32,
//    unaligned payloads and N off a multiple of 16, in every form.
// Left for later work: the exact forms' wgmma path waits for each group's
// last batch before its fold, and both consumer warpgroups fold at once, so
// the tensor cores idle there; two partials would let the next group's
// wgmmas run during the fold, but with 128 x rows a block they leave too
// few registers for the A fragments (ptxas then issues each wgmma alone).

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

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
                                                  const void* row) {
  const unsigned addr = smem_u32(row);
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


// ---------------------------------------------------------------------------
// Split-K, swap-AB (f16/bf16, small M).
// ---------------------------------------------------------------------------

constexpr int SK_BN = 64;           // output columns a block: 4 warps x 16
constexpr int SK_BK = 64;           // payload rows a stage
constexpr int SK_LDW = SK_BN + 16;  // payload stage row stride (bytes): conflict-free ldmatrix
constexpr int SK_LDX = SK_BK + 8;   // x stage row stride (elements): conflict-free fragments
constexpr int SK_STAGES = 3;
constexpr int SK_THREADS = 128;

__device__ __forceinline__ unsigned sub_f16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("sub.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// a * 1 - b, exact here (fma.rn.bf16x2: sm_80 and up).
__device__ __forceinline__ unsigned sub_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3F803F80u), "r"(b ^ 0x80008000u));
  return d;
}

// Two payload values (bits 0-7 and 16-23 of `v`, already biased to be
// unsigned) as a bf16 pair, through f32: 2^23 + u - (2^23 + bias) is exact.
__device__ __forceinline__ unsigned bf16x2_of_bytes(unsigned v, float bias) {
  const float lo = __uint_as_float(0x4B000000u | (v & 0xFFu)) - (8388608.f + bias);
  const float hi = __uint_as_float(0x4B000000u | ((v >> 16) & 0xFFu)) - (8388608.f + bias);
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&b);
}

// The A fragment (16 output columns x 16 k) of half `h` from the two
// registers of ldmatrix.x2.trans over 16 payload rows x 16 bytes: p0 holds
// rows 2t, 2t + 1 and p1 rows 2t + 8, 2t + 9, each at columns 2g (bytes 0,
// 2) and 2g + 1 (bytes 1, 3). Registers 0 / 2 are mma row g (column 2g),
// 1 / 3 mma row g + 8 (column 2g + 1), low half the lower k.
template <typename T, bool PACKED>
__device__ __forceinline__ void dequant_frag(unsigned (&a)[4], unsigned p0, unsigned p1,
                                             int h) {
  constexpr bool F16 = std::is_same<T, __half>::value;
  const unsigned src[4] = {p0, p0 >> 8, p1, p1 >> 8};
  if (PACKED) {
    // Nibble h of bytes 0 and 2: q in the mantissa of 1024.0 (f16) or 128.0
    // (bf16), minus that number.
    const unsigned magic = F16 ? 0x64006400u : 0x43004300u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned v = ((src[i] >> (4 * h)) & 0x000F000Fu) | magic;
      a[i] = F16 ? sub_f16x2(v, magic) : sub_bf16x2(v, magic);
    }
  } else if (F16) {
    // Signed bytes biased by 128 into the mantissa of 1024.0, minus 1152.0.
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = sub_f16x2(((src[i] ^ 0x00800080u) & 0x00FF00FFu) | 0x64006400u, 0x64806480u);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = bf16x2_of_bytes(src[i] ^ 0x00800080u, 128.f);
  }
}

// dequant_frag for a half known at compile time. float16 packed, half 1:
// the high nibble stays in place, 16q in the mantissa of 1024.0 (exact),
// and one HFMA2 gives (1024 + 16q) / 16 - 64 = q, saving the shifts.
template <typename T, bool PACKED, int HALF>
__device__ __forceinline__ void dequant_half(unsigned (&a)[4], unsigned p0, unsigned p1) {
  if (PACKED && HALF == 1 && std::is_same<T, __half>::value) {
    const unsigned src[4] = {p0, p0 >> 8, p1, p1 >> 8};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned v = (src[i] & 0x00F000F0u) | 0x64006400u;
      asm("fma.rn.f16x2 %0, %1, %2, %3;\n"
          : "=r"(a[i])
          : "r"(v), "r"(0x2C002C00u), "r"(0xD400D400u));  // x 1/16, - 64
    }
  } else {
    dequant_frag<T, PACKED>(a, p0, p1, HALF);
  }
}

// Two f32 values as a T pair (`lo` in the low half), each rounded once.
template <typename T>
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
  }
}

// The folded forms' A fragment: dequant_frag's weights, each times the f32
// scale of its column (s.x for column 2g: registers 0 and 2; s.y for column
// 2g + 1: registers 1 and 3) and rounded once to T, as the tile rounds
// half((q - z) * s). The payload value comes exactly as an f32 from the
// mantissa of 2^23. Packed, one FFMA then gives (2^23 + q) * s - 2^23 * s
// = q * s with its single rounding (2^23 * s is exact); unpacked, the
// subtract of 2^23 + 128 is exact and the product rounds once.
template <typename T, bool PACKED>
__device__ __forceinline__ void dequant_fold(unsigned (&a)[4], unsigned p0, unsigned p1, int h,
                                             float2 s) {
  const unsigned src[4] = {p0, p0 >> 8, p1, p1 >> 8};
  const float c[2] = {8388608.f * s.x, 8388608.f * s.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float sc = (i & 1) ? s.y : s.x;
    float lo, hi;
    if (PACKED) {
      const unsigned v = (src[i] >> (4 * h)) & 0x000F000Fu;
      lo = fmaf(__uint_as_float(0x4B000000u | (v & 0xFFFFu)), sc, -c[i & 1]);
      hi = fmaf(__uint_as_float(0x4B000000u | (v >> 16)), sc, -c[i & 1]);
    } else {
      const unsigned v = src[i] ^ 0x00800080u;  // signed bytes biased by 128
      lo = (__uint_as_float(0x4B000000u | (v & 0xFFu)) - 8388736.f) * sc;
      hi = (__uint_as_float(0x4B000000u | ((v >> 16) & 0xFFu)) - 8388736.f) * sc;
    }
    a[i] = pack2<T>(lo, hi);
  }
}

// An A fragment of ones: mma(d, ONES, b0, b1) adds each x row's 16 values
// of the k-step to d (d[0] row 2t, d[1] row 2t + 1).
template <typename T>
__device__ __forceinline__ unsigned ones2() {
  return std::is_same<T, __half>::value ? 0x3C003C00u : 0x3F803F80u;
}

// Sum, in f32, of the four half values of a B fragment (b0, b1).
template <typename T>
__device__ __forceinline__ float frag_sum(unsigned b0, unsigned b1) {
  return (Half<T>::value(b0 & 0xFFFF) + Half<T>::value(b0 >> 16)) +
         (Half<T>::value(b1 & 0xFFFF) + Half<T>::value(b1 >> 16));
}

// Grid: (ceil(N / 64), ceil(M / XR), splits); slice z covers payload rows
// [z * k_chunk, min(rows, (z + 1) * k_chunk)), rows = K/2 packed or K;
// k_chunk is a multiple of G. With splits > 1, `part` is the f32 workspace
// [splits, M, N] (no zeroing needed) and `counters` one int per (x, y) tile,
// zero on entry and left zero. Needs N % 16 == 0, 16-byte aligned x and
// payload. FOLD: the scale rides in the A fragment (dequant_fold) and each
// mma adds straight into the output accumulator: no group partial, no
// group-end fold, no row sums (zs unused).
template <typename T, int XR, bool PACKED, bool FOLD>
__global__ void __launch_bounds__(SK_THREADS)
w4_splitk_kernel(const unsigned short* __restrict__ x, const uint8_t* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ zs,
                 float* __restrict__ out, float* __restrict__ part,
                 int* __restrict__ counters, int M, int N, int K, int G, int k_chunk,
                 int splits) {
  constexpr int H = PACKED ? 2 : 1;
  constexpr int JT = XR / 8;
  // Packed, the zero-point term needs rowsum(x_g): on the tensor cores (one
  // mma with an A of ones) where registers allow, else from the B
  // fragments with shuffles at each group's end.
  constexpr bool RS_MMA = PACKED && !FOLD && JT <= 2;
  constexpr int W_BYTES = SK_BK * SK_LDW;
  constexpr int STAGE = W_BYTES + H * XR * SK_LDX * 2;
  constexpr int W_CHUNKS = SK_BK * (SK_BN / 16);
  constexpr int X_CHUNKS = H * XR * (SK_BK / 8);
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * SK_BN;
  const int m0 = blockIdx.y * XR;
  const int rows = PACKED ? K / 2 : K;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(rows, kbeg + k_chunk);
  const int nsteps = kend > kbeg ? (kend - kbeg + SK_BK - 1) / SK_BK : 0;

  // kend - kbeg and every stage start are multiples of 16, so a 16-byte
  // payload chunk (one row) or x chunk (8 columns) is all in or all out.
  // Each thread copies the same chunks of every stage (fixed rows, columns
  // and shared offsets), so the copies are straight-line code.
  constexpr int W_ROW_CHUNKS = SK_BN / 16;
  constexpr int X_ROW_CHUNKS = SK_BK / 8;
  constexpr int W_PER = W_CHUNKS / SK_THREADS;
  constexpr int X_PER = (X_CHUNKS + SK_THREADS - 1) / SK_THREADS;
  static_assert(W_CHUNKS % SK_THREADS == 0, "whole payload chunks a thread");
  const int wrow = tid / W_ROW_CHUNKS;
  const int wcol = (tid % W_ROW_CHUNKS) * 16;
  const bool wcol_in = n0 + wcol < N;
  const uint8_t* wsrc = w + (size_t)wrow * N + n0 + wcol;
  const int xcol = (tid % X_ROW_CHUNKS) * 8;
  auto load_stage = [&](int slot, int step) {
    uint8_t* base = smem + slot * STAGE;
    const int r0 = kbeg + step * SK_BK;
#pragma unroll
    for (int i = 0; i < W_PER; ++i) {
      const int r = wrow + i * (SK_THREADS / W_ROW_CHUNKS);
      const bool ok = wcol_in && r0 + r < kend;
      cp_async16(smem_u32(base + r * SK_LDW + wcol),
                 ok ? wsrc + (size_t)(r0 + i * (SK_THREADS / W_ROW_CHUNKS)) * N : w,
                 ok ? 16 : 0);
    }
    unsigned short* xs = reinterpret_cast<unsigned short*>(base + W_BYTES);
#pragma unroll
    for (int i = 0; i < X_PER; ++i) {
      const int hr = tid / X_ROW_CHUNKS + i * (SK_THREADS / X_ROW_CHUNKS);  // h * XR + row
      if (X_CHUNKS % SK_THREADS == 0 || hr < H * XR) {
        const int h = hr / XR;
        const int row = hr % XR;
        const bool ok = m0 + row < M && r0 + xcol < kend;
        cp_async16(smem_u32(xs + hr * SK_LDX + xcol),
                   ok ? x + (size_t)(m0 + row) * K + h * rows + r0 + xcol : x, ok ? 16 : 0);
      }
    }
  };

  float acc[JT][4], prt[H][JT][4], rs[H][JT], rsm[H][JT][4];
#pragma unroll
  for (int j = 0; j < JT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[j][r] = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) prt[h][j][r] = rsm[h][j][r] = 0.f;
    }
  const unsigned ones[4] = {ones2<T>(), ones2<T>(), ones2<T>(), ones2<T>()};
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < JT; ++j) rs[h][j] = 0.f;

  // This thread's two output columns (mma rows g and g + 8), and the scale
  // (and zero-term) row of its first group: the slice starts on a group
  // boundary, and each group end steps to the next row; half 1's groups lie
  // rows / G rows further.
  const int n = n0 + warp * 16 + 2 * g;
  const bool n_in = n < N;
  const int gsteps = G / 16;  // k-steps a group
  int gleft = gsteps;
  const size_t half_rows = (size_t)(rows / G) * N;
  const float* srow = scale + (size_t)(kbeg / G) * N + n;
  const float* zrow = PACKED && !FOLD ? zs + (size_t)(kbeg / G) * N + n : nullptr;
  // FOLD: the scales of the current group (sf) and of the next (sn), loaded
  // a group ahead; past the slice's last group they are not read.
  const float* send = scale + (size_t)(kend / G) * N + n;
  float2 sf[H], sn[H];
  auto fold_scales = [&](float2 (&dst)[H], const float* row) {
#pragma unroll
    for (int h = 0; h < H; ++h)
      dst[h] = n_in && row < send ? __ldg(reinterpret_cast<const float2*>(row + h * half_rows))
                                  : make_float2(0.f, 0.f);
  };
  if (FOLD) {
    fold_scales(sf, srow);
    fold_scales(sn, srow + N);
  }

#pragma unroll
  for (int s = 0; s < SK_STAGES - 1; ++s) {
    if (s < nsteps) load_stage(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<SK_STAGES - 2>();
    __syncthreads();  // stage `it` has landed; stage `it - 1` has been read
    const int next = it + SK_STAGES - 1;
    if (next < nsteps) load_stage(next % SK_STAGES, next);
    cp_async_commit();
    const uint8_t* Ws = smem + (it % SK_STAGES) * STAGE;
    const unsigned short* Xs = reinterpret_cast<const unsigned short*>(Ws + W_BYTES);
    const int r0 = kbeg + it * SK_BK;
#pragma unroll
    for (int kk = 0; kk < SK_BK / 16; ++kk) {
      const int r = r0 + kk * 16;
      if (r >= kend) break;  // block-uniform: the slice's last, short stage
      unsigned p0, p1;
      ldmatrix_x2_trans(p0, p1, Ws + (kk * 16 + (lane & 15)) * SK_LDW + warp * 16);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        unsigned a[4];
        if (FOLD) dequant_fold<T, PACKED>(a, p0, p1, h, sf[h]);
        else dequant_frag<T, PACKED>(a, p0, p1, h);
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          const unsigned short* xp = Xs + (h * XR + j * 8 + g) * SK_LDX + kk * 16 + 2 * t;
          const unsigned b0 = ld32(xp);
          const unsigned b1 = ld32(xp + 8);
          if (FOLD) {
            Half<T>::mma(acc[j], a, b0, b1);
            continue;
          }
          Half<T>::mma(prt[h][j], a, b0, b1);
          if (RS_MMA) Half<T>::mma(rsm[h][j], ones, b0, b1);
          else if (PACKED) rs[h][j] += frag_sum<T>(b0, b1);
        }
      }
      if (--gleft == 0 && FOLD) {
        gleft = gsteps;
        srow += N;
#pragma unroll
        for (int h = 0; h < H; ++h) sf[h] = sn[h];
        fold_scales(sn, srow + N);
      } else if (gleft == 0) {
        // A group ends (in both halves): scale the partial sums into acc.
        gleft = gsteps;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float2 s2 = n_in ? __ldg(reinterpret_cast<const float2*>(srow + h * half_rows))
                                 : make_float2(0.f, 0.f);
          const float2 z2 = (PACKED && n_in)
              ? __ldg(reinterpret_cast<const float2*>(zrow + h * half_rows))
              : make_float2(0.f, 0.f);
#pragma unroll
          for (int j = 0; j < JT; ++j) {
            float x0 = 0.f, x1 = 0.f;  // rowsum(x_g) of rows 2t and 2t + 1
            if (RS_MMA) {
              x0 = rsm[h][j][0];
              x1 = rsm[h][j][1];
#pragma unroll
              for (int e = 0; e < 4; ++e) rsm[h][j][e] = 0.f;
            } else if (PACKED) {
              float v = rs[h][j];
              v += __shfl_xor_sync(0xffffffffu, v, 1);
              v += __shfl_xor_sync(0xffffffffu, v, 2);  // row g of this n-tile
              x0 = __shfl_sync(0xffffffffu, v, 8 * t);
              x1 = __shfl_sync(0xffffffffu, v, 8 * t + 4);
              rs[h][j] = 0.f;
            }
            // prt[h][j][r]: row 2t + (r & 1), column n + (r >> 1).
            acc[j][0] += prt[h][j][0] * s2.x - x0 * z2.x;
            acc[j][1] += prt[h][j][1] * s2.x - x1 * z2.x;
            acc[j][2] += prt[h][j][2] * s2.y - x0 * z2.y;
            acc[j][3] += prt[h][j][3] * s2.y - x1 * z2.y;
#pragma unroll
            for (int e = 0; e < 4; ++e) prt[h][j][e] = 0.f;
          }
        }
        srow += N;
        if (PACKED) zrow += N;
      }
    }
  }
  cp_async_wait<0>();

  // acc[j][e + 2c] is out[m0 + 8j + 2t + e][n + c].
  float* dst = splits == 1 ? out : part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int j = 0; j < JT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + j * 8 + 2 * t + e;
      if (m < M && n_in)
        *reinterpret_cast<float2*>(dst + (size_t)m * N + n) = make_float2(acc[j][e], acc[j][2 + e]);
    }
  if (splits == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
    const int last = atomicAdd(counter, 1) == splits - 1;
    if (last) *counter = 0;  // every slice of this tile has arrived
    is_last = last;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // The last slice of this tile: every slice's partial tile is in `part`;
  // add them in slice order.
#pragma unroll
  for (int j = 0; j < JT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + j * 8 + 2 * t + e;
      if (m < M && n < N) {
        float2 sum = make_float2(0.f, 0.f);
        for (int z = 0; z < splits; ++z) {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(
              part + ((size_t)z * M + m) * N + n));
          sum.x += v.x;
          sum.y += v.y;
        }
        *reinterpret_cast<float2*>(out + (size_t)m * N + n) = sum;
      }
    }
}

template <typename T, int XR, bool PACKED, bool FOLD>
int launch_splitk(const void* x, const void* w, const void* scale, const void* zs,
                  void* out, void* part, void* counters, int M, int N, int K, int G,
                  int k_chunk, int splits, cudaStream_t stream) {
  constexpr int H = PACKED ? 2 : 1;
  constexpr int smem = SK_STAGES * (SK_BK * SK_LDW + H * XR * SK_LDX * 2);
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(w4_splitk_kernel<T, XR, PACKED, FOLD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    // Several blocks an SM (about eight by the plan) need their rings at
    // once: ask for the largest shared-memory share of the SM.
    cudaFuncSetAttribute(w4_splitk_kernel<T, XR, PACKED, FOLD>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    attr_set = true;
  }
  dim3 grid((N + SK_BN - 1) / SK_BN, (M + XR - 1) / XR, splits);
  w4_splitk_kernel<T, XR, PACKED, FOLD><<<grid, SK_THREADS, smem, stream>>>(
      static_cast<const unsigned short*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(zs),
      static_cast<float*>(out), static_cast<float*>(part), static_cast<int*>(counters),
      M, N, K, G, k_chunk, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PACKED, bool FOLD>
int dispatch_splitk(int mt, const void* x, const void* w, const void* scale,
                    const void* zs, void* out, void* part, void* counters, int M, int N,
                    int K, int G, int k_chunk, int splits, cudaStream_t s) {
  switch (mt) {
    case 8: return launch_splitk<T, 8, PACKED, FOLD>(x, w, scale, zs, out, part, counters, M, N, K, G, k_chunk, splits, s);
    case 16: return launch_splitk<T, 16, PACKED, FOLD>(x, w, scale, zs, out, part, counters, M, N, K, G, k_chunk, splits, s);
    case 32: return launch_splitk<T, 32, PACKED, FOLD>(x, w, scale, zs, out, part, counters, M, N, K, G, k_chunk, splits, s);
    case 64: return launch_splitk<T, 64, PACKED, FOLD>(x, w, scale, zs, out, part, counters, M, N, K, G, k_chunk, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_splitk_form(int packed, int fold, int mt, const void* x, const void* w,
                         const void* scale, const void* zs, void* out, void* part,
                         void* counters, int M, int N, int K, int G, int k_chunk, int splits,
                         cudaStream_t s) {
  auto run = [&](auto kernel_of) {
    return kernel_of(mt, x, w, scale, zs, out, part, counters, M, N, K, G, k_chunk, splits, s);
  };
  if (packed) return fold ? run(dispatch_splitk<T, true, true>) : run(dispatch_splitk<T, true, false>);
  return fold ? run(dispatch_splitk<T, false, true>) : run(dispatch_splitk<T, false, false>);
}

// ---------------------------------------------------------------------------
// wgmma + TMA, swap-AB (f16/bf16, large M, not folded).
// ---------------------------------------------------------------------------

constexpr int WG_BN = 128;  // weight columns a block: two consumer warpgroups x 64
constexpr int WG_BM = 128;  // x rows a block: wgmma's N
constexpr int WG_BK = 64;   // payload rows (k of one half) a stage: one 128B x row
constexpr int WG_STAGES = 8;
constexpr int WG_GROUP = 8;  // x-row tiles a raster group
constexpr int WG_RS_GROUPS = 4;  // row-sum groups a stage carries (64 rows, G >= 16)
constexpr int WG_X_BYTES = WG_BM * WG_BK * 2;
constexpr int WG_W_BYTES = WG_BK * WG_BN;
constexpr int WG_RS_BYTES = WG_RS_GROUPS * WG_BM * 4;
__host__ __device__ constexpr int wg_stage_bytes(bool packed) {
  return WG_X_BYTES + WG_W_BYTES + (packed ? 1024 * ((WG_RS_BYTES + 1023) / 1024) : 0);
}
__host__ __device__ constexpr int wg_smem(bool packed) {
  return 1024 + WG_STAGES * wg_stage_bytes(packed) + 2 * WG_STAGES * 8;
}
constexpr int WG_CONSUMERS = 256;  // warpgroups 0-1; warpgroup 2 is the producer
constexpr int WG_THREADS = WG_CONSUMERS + 128;
// Registers a thread after setmaxnreg: 384 threads start at 168; the
// producer warpgroup gives up 128 a thread, the consumers take 64 more.
constexpr int WG_PRODUCER_REGS = 40;
constexpr int WG_CONSUMER_REGS = 232;
static_assert(WG_PRODUCER_REGS * 128 + WG_CONSUMER_REGS * WG_CONSUMERS <= 168 * WG_THREADS,
              "the register moves fit the block's allocation");

__device__ __forceinline__ void ldmatrix_x2_trans_at(unsigned& r0, unsigned& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

// rowsum(x_g) for the packed form's zero-point term, in f32: rs[g, m] for
// every group g of K (both halves), m < M; rs has `ld` >= M columns.
__global__ void __launch_bounds__(256)
w4_rowsum_kernel(const unsigned short* __restrict__ x, float* __restrict__ rs, int M, int K,
                 int G, int ld, bool bf16) {
  const int m = blockIdx.x * 32 + (threadIdx.x & 31);
  const int grp = blockIdx.y * 8 + (threadIdx.x >> 5);
  if (m >= M || grp >= K / G) return;
  const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)m * K + (size_t)grp * G);
  float sum = 0.f;
  for (int c = 0; c < G / 8; ++c) {
    const uint4 v = __ldg(src + c);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (bf16) {
        sum += __uint_as_float(w[i] << 16);
        sum += __uint_as_float(w[i] & 0xFFFF0000u);
      } else {
        sum += __half2float(__ushort_as_half(w[i] & 0xFFFF));
        sum += __half2float(__ushort_as_half(w[i] >> 16));
      }
    }
  }
  rs[(size_t)grp * ld + m] = sum;
}

// One block: weight columns [tn * 128, + 128) x x rows [tm * 128, + 128),
// the whole K. The stages run half 0's payload rows, then (packed) half 1's,
// 64 rows a stage: a stage is the x box [128 rows x 64 k] of one half, the
// payload box [64 rows x 128 columns] and, packed, the row sums of the x
// rows for the stage's first four groups; packed, every payload box is read
// twice (once a half), which keeps one group partial a thread. Warp w of
// consumer warpgroup c owns weight columns c * 64 + 16 w .. + 16 as wgmma
// rows; its A fragment of a k-step is the split-K kernel's (ldmatrix.x2.trans
// on the payload bytes, dequant_frag), so dequantized weights never go
// through shared memory. x is B, K-major from the swizzled TMA box.
template <typename T, bool PACKED, int GS>
__global__ void __launch_bounds__(WG_THREADS, 1)
w4_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                const __grid_constant__ CUtensorMap tmap_w,
                const __grid_constant__ CUtensorMap tmap_rs, const float* __restrict__ scale,
                const float* __restrict__ zs, float* __restrict__ out, int M, int N, int K,
                int G) {
  constexpr int H = PACKED ? 2 : 1;
  constexpr int STAGE = wg_stage_bytes(PACKED);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + WG_STAGES * STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (WG_STAGES + s); };

  const int rows = PACKED ? K / 2 : K;
  const int cps = (rows + WG_BK - 1) / WG_BK;  // stages a half
  const int nst = H * cps;
  const int tiles_m = (M + WG_BM - 1) / WG_BM;
  const int tiles_n = (N + WG_BN - 1) / WG_BN;
  const int id = blockIdx.x;
  const int first_m = (id / (WG_GROUP * tiles_n)) * WG_GROUP;
  const int group_m = min(tiles_m - first_m, WG_GROUP);
  const int tm = first_m + (id % group_m);
  const int tn = (id % (WG_GROUP * tiles_n)) / group_m;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= WG_CONSUMERS) {
    setmaxnreg_dec<WG_PRODUCER_REGS>();
    if (threadIdx.x == WG_CONSUMERS) {
      tma_prefetch(&tmap_x);
      tma_prefetch(&tmap_w);
      if (PACKED) tma_prefetch(&tmap_rs);
      for (int i = 0; i < nst; ++i) {
        const int s = i % WG_STAGES;
        if (i >= WG_STAGES) mbar_wait(empty(s), ((i / WG_STAGES) - 1) & 1);
        const int h = (PACKED && i >= cps) ? 1 : 0;
        const int r0 = (i - h * cps) * WG_BK;
        const uint32_t dst = base + s * STAGE;
        mbar_arrive_expect_tx(full(s), PACKED ? WG_X_BYTES + WG_W_BYTES + WG_RS_BYTES
                                              : WG_X_BYTES + WG_W_BYTES);
        tma_load_2d(dst, &tmap_x, full(s), h * rows + r0, tm * WG_BM);
        tma_load_2d(dst + WG_X_BYTES, &tmap_w, full(s), tn * WG_BN, r0);
        if (PACKED)  // the row sums of the groups from the stage's first on
          tma_load_2d(dst + WG_X_BYTES + WG_W_BYTES, &tmap_rs, full(s), tm * WG_BM,
                      (h * rows + r0) / G);
      }
    }
    return;
  }
  setmaxnreg_inc<WG_CONSUMER_REGS>();

  const int cw = threadIdx.x >> 5;  // consumer warp 0-7
  const int wg = cw >> 2;
  const int warp = cw & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // wgmma rows g and g + 8 of this warp are weight columns n and n + 1 (the
  // fragment's column order, see dequant_frag); accumulator register
  // 4j + 2hh + e is column n + hh, x row 8j + 2t + e of the block.
  const int n = tn * WG_BN + wg * 64 + warp * 16 + 2 * g;
  const bool n_in = n < N;
  const int chunk = wg * 4 + warp;  // this warp's 16-byte payload chunk of a row
  const int gsteps = G / 16;
  const int groups = K / G;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  auto scales = [&](int grp, float2& s2, float2& z2) {
    s2 = make_float2(0.f, 0.f);
    z2 = make_float2(0.f, 0.f);
    if (n_in && grp < groups) {
      s2 = __ldg(reinterpret_cast<const float2*>(scale + (size_t)grp * N + n));
      if (PACKED) z2 = __ldg(reinterpret_cast<const float2*>(zs + (size_t)grp * N + n));
    }
  };
  float2 s2, z2;  // the next fold's scale and zero term, loaded a group ahead
  scales(0, s2, z2);
  // The stage's A fragments: k-step kk of payload rows from `wt`, payload
  // half HALF.
  unsigned a[WG_BK / 16][4];
  auto dequant = [&](auto half, uint32_t wt, int nk) {
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      if (kk < nk) {
        const int r = kk * 16 + (lane & 15);
        unsigned p0, p1;
        ldmatrix_x2_trans_at(p0, p1, wt + r * 128 + ((chunk ^ (r & 7)) << 4));
        dequant_half<T, PACKED, decltype(half)::value>(a[kk], p0, p1);
      }
    }
  };
  auto slice = [&](uint32_t xt) {  // the stage's row sums (packed)
    return reinterpret_cast<const float*>(smem_raw + (xt - raw) + WG_X_BYTES + WG_W_BYTES);
  };

  // One partial a thread, folded at each group end. Where G % 64 == 0
  // (GS == 4) groups end only on stage ends, and a stage's wgmmas issue as
  // one straight batch, committed before any branch: a branch between two
  // wgmmas, or a commit after one, makes ptxas close the batch early (each
  // wgmma then runs alone, or the wait below waits for the batch just
  // issued). Any other G folds wherever in a stage its groups end.
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  int gleft = gsteps;
  int grp = 0;
  int accumulate = 0;
  // A group ends, its wgmmas committed: acc += part * s (packed: minus
  // rowsum(x_g) * zs, the row sums from the stage's slice, whose first
  // group is g_first), then the next group's scales.
  auto fold_group = [&](const float* rsm, int g_first) {
    wgmma_wait<0>();
    reg_fence(part);
    const float* rb = rsm + (grp - g_first) * WG_BM;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float2 r2 = make_float2(0.f, 0.f);
      if (PACKED) r2 = *reinterpret_cast<const float2*>(rb + 8 * j + 2 * t);
      acc[4 * j + 0] = fmaf(part[4 * j + 0], s2.x, acc[4 * j + 0]);
      acc[4 * j + 1] = fmaf(part[4 * j + 1], s2.x, acc[4 * j + 1]);
      acc[4 * j + 2] = fmaf(part[4 * j + 2], s2.y, acc[4 * j + 2]);
      acc[4 * j + 3] = fmaf(part[4 * j + 3], s2.y, acc[4 * j + 3]);
      if (PACKED) {
        acc[4 * j + 0] = fmaf(-r2.x, z2.x, acc[4 * j + 0]);
        acc[4 * j + 1] = fmaf(-r2.y, z2.x, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(-r2.x, z2.y, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(-r2.y, z2.y, acc[4 * j + 3]);
      }
    }
    scales(++grp, s2, z2);
    gleft = gsteps;
    accumulate = 0;
    reg_fence(part);
  };
  // Stage i of half HALF (packed: half 0's stages, then half 1's).
  auto stage = [&](auto hbuf, int i) {
    constexpr int h = decltype(hbuf)::value;
    const int s = i % WG_STAGES;
    const int r0 = (i - h * cps) * WG_BK;
    const int nk = min(WG_BK, rows - r0) >> 4;  // k-steps here
    const int g_first = (h * rows + r0) / G;   // the row-sum slice's first group
    const uint32_t xt = base + s * STAGE;
    mbar_wait(full(s), (i / WG_STAGES) & 1);
    dequant(hbuf, xt + WG_X_BYTES, nk);
    reg_fence(part);
    wgmma_fence();
    if (GS == WG_BK / 16) {
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        Wgmma<T>::rs_m64n128k16_kb(part, a[kk], desc_sw128(xt + kk * 32),
                                   kk == 0 ? accumulate : 1);
      wgmma_commit();
      accumulate = 1;
      gleft -= WG_BK / 16;
      if (gleft == 0) fold_group(slice(xt), g_first);
    } else {
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        if (kk >= nk) break;  // block-uniform: a half's last, short stage
        Wgmma<T>::rs_m64n128k16_kb(part, a[kk], desc_sw128(xt + kk * 32), accumulate);
        accumulate = 1;
        if (--gleft == 0) {
          wgmma_commit();
          fold_group(slice(xt), g_first);
          wgmma_fence();
        }
      }
      wgmma_commit();
    }
    wgmma_wait<1>();  // the previous stage's wgmmas are done: release it
    reg_fence(part);
    if (i > 0) mbar_arrive(empty((i - 1) % WG_STAGES));
  };
  for (int i = 0; i < cps; ++i) stage(std::integral_constant<int, 0>(), i);
  if (PACKED)
    for (int i = cps; i < nst; ++i) stage(std::integral_constant<int, 1>(), i);
  wgmma_wait<0>();
  reg_fence(part);

#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = tm * WG_BM + 8 * j + 2 * t + e;
      if (m < M && n_in)
        *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
            make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
    }
}

// ---------------------------------------------------------------------------
// wgmma + TMA, swap-AB, folded forms (f16/bf16, large M).
// ---------------------------------------------------------------------------

// One block: weight columns [tn * 128, + 128) x x rows [tm * BM, + BM), the
// whole K, in the raster of w4_wgmma_kernel. A stage is the payload box
// [64 rows x 128 columns] and the x box [BM rows x 64 k] of each half
// (packed: columns r0 and r0 + K/2 of the same payload rows), so the
// payload goes through the ring once. Warp w of consumer warpgroup c owns
// weight columns c * 64 + 16 w .. + 16 as wgmma rows; its A fragment of a
// k-step is dequant_fold's (the scale folded in, rounded once to T), and
// every wgmma adds into the one accumulator: the stage's wgmmas of a half
// issue back to back as one commit group, and the only wait is the one
// that lets the ring slot (and the fragments of the group before) go.
constexpr int WF_BLOCK_SMEM = 232448;  // a block's dynamic shared memory on the H100
__host__ __device__ constexpr int wf_x_bytes(int bm) { return bm * WG_BK * 2; }
__host__ __device__ constexpr int wf_stage_bytes(int bm, bool packed) {
  return WG_W_BYTES + (packed ? 2 : 1) * wf_x_bytes(bm);
}
__host__ __device__ constexpr int wf_stages(int bm, bool packed) {
  const int fit = (WF_BLOCK_SMEM - 1024 - 16 * WG_STAGES) / wf_stage_bytes(bm, packed);
  return fit < WG_STAGES ? fit : WG_STAGES;  // 3 packed, 5 unpacked at 256 rows
}
__host__ __device__ constexpr int wf_smem(int bm, bool packed) {
  return 1024 + wf_stages(bm, packed) * wf_stage_bytes(bm, packed) +
         2 * wf_stages(bm, packed) * 8;
}
static_assert(wf_stages(256, true) >= 3, "three stages of 256 x rows fit");

template <typename T, int BM>
__device__ __forceinline__ void wgmma_fold(float (&acc)[BM / 2], const unsigned (&a)[4],
                                           uint64_t db) {
  if constexpr (BM == 256) Wgmma<T>::rs_m64n256k16_kb(acc, a, db);
  else Wgmma<T>::rs_m64n128k16_kb(acc, a, db, 1);
}

template <typename T, bool PACKED, int BM>
__global__ void __launch_bounds__(WG_THREADS, 1)
w4_wgmma_fold_kernel(const __grid_constant__ CUtensorMap tmap_x,
                     const __grid_constant__ CUtensorMap tmap_w,
                     const float* __restrict__ scale, float* __restrict__ out, int M, int N,
                     int K, int G) {
  constexpr int H = PACKED ? 2 : 1;
  constexpr int STAGE = wf_stage_bytes(BM, PACKED);
  constexpr int STAGES = wf_stages(BM, PACKED);
  constexpr int X_BYTES = wf_x_bytes(BM);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int rows = PACKED ? K / 2 : K;
  // Stages; unpacked an even count (pairs of stages, below): a stage past
  // the payload is all zero fill (TMA) and adds nothing.
  const int nst = PACKED ? (rows + WG_BK - 1) / WG_BK : 2 * ((rows + 2 * WG_BK - 1) / (2 * WG_BK));
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles_n = (N + WG_BN - 1) / WG_BN;
  const int id = blockIdx.x;
  const int first_m = (id / (WG_GROUP * tiles_n)) * WG_GROUP;
  const int group_m = min(tiles_m - first_m, WG_GROUP);
  const int tm = first_m + (id % group_m);
  const int tn = (id % (WG_GROUP * tiles_n)) / group_m;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= WG_CONSUMERS) {
    setmaxnreg_dec<WG_PRODUCER_REGS>();
    if (threadIdx.x == WG_CONSUMERS) {
      tma_prefetch(&tmap_x);
      tma_prefetch(&tmap_w);
      for (int i = 0; i < nst; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), ((i / STAGES) - 1) & 1);
        const uint32_t dst = base + s * STAGE;
        mbar_arrive_expect_tx(full(s), WG_W_BYTES + H * X_BYTES);
        tma_load_2d(dst, &tmap_w, full(s), tn * WG_BN, i * WG_BK);
#pragma unroll
        for (int h = 0; h < H; ++h)
          tma_load_2d(dst + WG_W_BYTES + h * X_BYTES, &tmap_x, full(s), h * rows + i * WG_BK,
                      tm * BM);
      }
    }
    return;
  }
  setmaxnreg_inc<WG_CONSUMER_REGS>();

  const int cw = threadIdx.x >> 5;  // consumer warp 0-7
  const int wg = cw >> 2;
  const int warp = cw & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // wgmma rows g and g + 8 of this warp are weight columns n and n + 1;
  // accumulator register 4j + 2hh + e is column n + hh, x row 8j + 2t + e.
  const int n = tn * WG_BN + wg * 64 + warp * 16 + 2 * g;
  const bool n_in = n < N;
  const int chunk = wg * 4 + warp;  // this warp's 16-byte payload chunk of a row
  const int gsteps = G / 16;
  const int groups = rows / G;      // groups of a half

  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;

  // The scales of a stage's four k-steps for each half, the group counted
  // down a k-step at a time (no division in the loop); zero past the last
  // group (a half's short last stage, whose payload rows TMA fills with 0).
  int grp = 0, gleft = gsteps;
  float2 sc[H][WG_BK / 16];
  auto stage_scales = [&]() {
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < H; ++h)
        sc[h][kk] = n_in && grp < groups
            ? __ldg(reinterpret_cast<const float2*>(scale + (size_t)(h * groups + grp) * N + n))
            : make_float2(0.f, 0.f);
      if (--gleft == 0) {
        ++grp;
        gleft = gsteps;
      }
    }
  };
  // Commit groups run in pairs (u = 0, 1): packed, the two halves of a
  // stage; unpacked, two stages. Group u's A fragments live in registers of
  // their own, which a wgmma reads asynchronously: the next group to write
  // them comes after the wait that retires this one. Nothing may branch out
  // of the pair: ptxas then keeps one fragment set and issues each wgmma
  // alone (its C7513 note).
  stage_scales();
  unsigned p[WG_BK / 16][2];
  for (int q0 = 0; q0 < H * nst; q0 += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = PACKED ? q0 / 2 : q0 + u;  // the stage
      const int h = PACKED ? u : 0;            // its half
      const uint32_t wt = base + (i % STAGES) * STAGE;
      if (!PACKED || u == 0) {
        mbar_wait(full(i % STAGES), (i / STAGES) & 1);
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) {
          const int r = kk * 16 + (lane & 15);
          ldmatrix_x2_trans_at(p[kk][0], p[kk][1], wt + r * 128 + ((chunk ^ (r & 7)) << 4));
        }
      }
      unsigned a[WG_BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        dequant_fold<T, PACKED>(a[kk], p[kk][0], p[kk][1], h, sc[h][kk]);
        // Made here, not sunk between the wgmmas (each would then need its
        // own warpgroup arrive, and the batch would close).
        reg_fence(a[kk]);
      }
      reg_fence(acc);
      wgmma_fence();
      const uint32_t xt = wt + WG_W_BYTES + h * X_BYTES;
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wgmma_fold<T, BM>(acc, a[kk], desc_sw128(xt + kk * 32));
      wgmma_commit();
      if (h == H - 1) stage_scales();  // the next stage's, while these run
      wgmma_wait<1>();  // the group before is done: its fragments (and slot) are free
      reg_fence(acc);
      // The group before was the last of stage i - 1 unless it was this
      // stage's half 0 (packed, u == 1).
      if (h == 0 && i > 0) mbar_arrive(empty((i - 1) % STAGES));
    }
  }
  wgmma_wait<0>();
  reg_fence(acc);

#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = tm * BM + 8 * j + 2 * t + e;
      if (m < M && n_in)
        *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
            make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
    }
}

// A 2-D tensor map of [outer, inner] elements of `elem_bytes` (row stride
// inner * elem_bytes), box box_outer x box_inner, 128B swizzle by default.
int encode_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elem_bytes,
              int inner, int outer, int box_inner, int box_outer,
              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  ct2_encode_tiled_fn encode = ct2_encode_tiled();
  if (encode == nullptr) return CT2_ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1u, 1u};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : CT2_ERR_ENCODE + static_cast<int>(r);
}

template <typename T, bool PACKED>
int launch_wgmma(const void* x, const void* w, const void* scale, const void* zs, void* out,
                 void* rs, int M, int N, int K, int G, cudaStream_t stream) {
  const int rows = PACKED ? K / 2 : K;
  const int ld = (M + 3) & ~3;  // row-sum columns: a 16-byte row stride
  CUtensorMap tx, tw, trs;
  int err = encode_2d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_UINT16, 2, K, M, WG_BK, WG_BM);
  if (err == 0) err = encode_2d(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, rows, WG_BN, WG_BK);
  if (err == 0 && PACKED)
    err = encode_2d(&trs, rs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ld, K / G, WG_BM,
                    WG_RS_GROUPS, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  if (PACKED) {
    dim3 grid((M + 31) / 32, (K / G + 7) / 8);
    w4_rowsum_kernel<<<grid, 256, 0, stream>>>(static_cast<const unsigned short*>(x),
                                               static_cast<float*>(rs), M, K, G, ld,
                                               std::is_same<T, __nv_bfloat16>::value);
  }
  const long long tiles = (long long)((M + WG_BM - 1) / WG_BM) * ((N + WG_BN - 1) / WG_BN);
  auto run = [&](auto kernel, bool& attr_set) {
    if (!attr_set) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg_smem(PACKED));
      attr_set = true;
    }
    kernel<<<(unsigned)tiles, WG_THREADS, wg_smem(PACKED), stream>>>(
        tx, tw, PACKED ? trs : tx, static_cast<const float*>(scale),
        static_cast<const float*>(zs), static_cast<float*>(out), M, N, K, G);
  };
  static bool batched_set = false, single_set = false;
  if (G % (16 * (WG_BK / 16)) == 0)
    run(w4_wgmma_kernel<T, PACKED, WG_BK / 16>, batched_set);
  else
    run(w4_wgmma_kernel<T, PACKED, 1>, single_set);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PACKED, int BM>
int launch_wgmma_fold(const void* x, const void* w, const void* scale, void* out, int M, int N,
                      int K, int G, cudaStream_t stream) {
  const int rows = PACKED ? K / 2 : K;
  CUtensorMap tx, tw;
  int err = encode_2d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_UINT16, 2, K, M, WG_BK, BM);
  if (err == 0) err = encode_2d(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, rows, WG_BN, WG_BK);
  if (err != 0) return err;
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(w4_wgmma_fold_kernel<T, PACKED, BM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, wf_smem(BM, PACKED));
    attr_set = true;
  }
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + WG_BN - 1) / WG_BN);
  w4_wgmma_fold_kernel<T, PACKED, BM><<<(unsigned)tiles, WG_THREADS, wf_smem(BM, PACKED), stream>>>(
      tx, tw, static_cast<const float*>(scale), static_cast<float*>(out), M, N, K, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_wgmma(int packed, int fold, int bm, const void* x, const void* w,
                   const void* scale, const void* zs, void* out, void* rs, int M, int N, int K,
                   int G, cudaStream_t s) {
  if (!fold)
    return bm != WG_BM ? static_cast<int>(cudaErrorInvalidValue)
           : packed    ? launch_wgmma<T, true>(x, w, scale, zs, out, rs, M, N, K, G, s)
                       : launch_wgmma<T, false>(x, w, scale, zs, out, rs, M, N, K, G, s);
  if (bm == 128)
    return packed ? launch_wgmma_fold<T, true, 128>(x, w, scale, out, M, N, K, G, s)
                  : launch_wgmma_fold<T, false, 128>(x, w, scale, out, M, N, K, G, s);
  if (bm == 256)
    return packed ? launch_wgmma_fold<T, true, 256>(x, w, scale, out, M, N, K, G, s)
                  : launch_wgmma_fold<T, false, 256>(x, w, scale, out, M, N, K, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
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

// Path 3. Launches one W4 product on `stream`: x [M, K] (dtype 0 f32, 1 f16,
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

// Path 1 (see the note at the top): x [M, K] f16 (dtype 1) or bf16 (2),
// payload as for ct2_w4_gemm, f32 `out` [M, N]; `fold` (0/1) the folded
// form (zs unused). `part`: f32 [splits, M, N] and `counters`: int32
// [ceil(N / 64) * ceil(M / mt)], zero, when splits > 1 (else unused). `mt`
// (x rows a block) is 8, 16, 32 or 64; k_chunk a multiple of G (payload
// rows a slice). Needs N % 16 == 0 and 16-byte aligned x and payload.
// Returns cudaGetLastError() after the launch.
extern "C" int ct2_w4_gemm_splitk(const void* x, const void* w, const void* scale,
                                  const void* zs, void* out, void* part, void* counters,
                                  int M, int N, int K, int G, int dtype, int packed, int fold,
                                  int mt, int k_chunk, int splits, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_splitk_form<__half>(packed, fold, mt, x, w, scale, zs, out, part, counters,
                                        M, N, K, G, k_chunk, splits, s);
  if (dtype == 2)
    return dispatch_splitk_form<__nv_bfloat16>(packed, fold, mt, x, w, scale, zs, out, part,
                                               counters, M, N, K, G, k_chunk, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Path 2 (see the note at the top): x [M, K] f16 (dtype 1) or bf16 (2),
// payload as for ct2_w4_gemm, f32 `out` [M, N]; `bm` x rows a block (128;
// folded also 256). Not folded and packed, `rs` an f32 workspace [K/G,
// (M + 3) / 4 * 4] for the row sums (else unused), and two launches: the
// row sums, then the product; folded, one launch (zs and rs unused). Needs
// N % 16 == 0 and 16-byte aligned x and payload (TMA's stride and address
// rules). Returns cudaGetLastError() after the launches, or CT2_ERR_* if a
// tensor map could not be made.
extern "C" int ct2_w4_gemm_wgmma(const void* x, const void* w, const void* scale,
                                 const void* zs, void* out, void* rs, int M, int N, int K,
                                 int G, int dtype, int packed, int fold, int bm, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_wgmma<__half>(packed, fold, bm, x, w, scale, zs, out, rs, M, N, K, G, s);
  if (dtype == 2)
    return dispatch_wgmma<__nv_bfloat16>(packed, fold, bm, x, w, scale, zs, out, rs, M, N, K, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
