// W8A8 GEMM for Hopper (sm_90a): int8 x int8 -> int32, f32 dequant epilogue.
//
// Replaces ctranslate2_tpu/kernels/quant_matmul.py::matmul_w8a8 (the Pallas
// kernel _w8a8_kernel). It computes, for q int8 [M, K] (row-major) and
// w int8 [N, K] (row-major, i.e. K-major per output column, the layout
// model.bin stores):
//
//     out[m, n] = float(sum_k q[m, k] * w[n, k]) / (a_scale[m] * w_scale[n])
//
// with a_scale[m] == 0 read as 1. The int32 sum is exact (|sum| < 2^31 up
// to K = 131,000), in any order, so both paths below are bit-equal to the
// plain PyTorch version in quant_matmul.py: the epilogue is one IEEE f32
// multiply and one IEEE f32 divide (no fast math).
//
// What bounds it on the H100: at the decode shapes (M = 4, the Generator;
// M = 128, the Translator's decoder) the weight bytes, N * K read once per
// call, against 3.35 TB/s; at the prefill and encoder shapes (M = 8,192 and
// 2,048) the int8 tensor-core rate, 1,979 TOP/s dense. The wrapper picks a
// path per (M, N, K) with quant_matmul.w8a8_plan:
//
// 1. Split-K, swap-AB, for small M (ct2_w8a8_gemm_splitk). The weights are
//    the A operand of mma.sync.m16n8k32.s8 (16 output columns a warp) and
//    the activations its B operand (8 rows an n-tile, MT/8 n-tiles for
//    MT = 8..64 rows a block), so M = 4 wastes half of each mma and not
//    15/16 of it. A 128-thread block owns 64 output columns x MT rows x one
//    K slice; the plan splits K so that every shape has at least about four
//    blocks an SM. The block streams its 64 x 128-byte weight stages and
//    its activation stages through a 4-stage cp.async.cg ring (up to 27 KB
//    in flight a block). Partial int32 sums of several slices meet in an
//    int32 workspace the wrapper zeroes (atomicAdd, exact in any order);
//    the last block of a tile, found through a per-tile counter behind the
//    workspace, applies the f32 epilogue. One CUDA launch (plus the
//    workspace's memset when K is split). The same kernel, with byte-wise
//    shared-memory stores instead of cp.async (VEC = false), takes any
//    shape: K not a multiple of 16 or operands not 16-byte aligned. That
//    ragged form is slow and is taken only for such shapes.
// 2. wgmma, for large M (ct2_w8a8_gemm_wgmma). 128 x 128 output tiles,
//    one block each (a grouped raster, 8 row tiles to a group, so a wave's
//    weight tiles stay in L2): one producer warp issues TMA loads of
//    128 x 128-byte activation and weight tiles, 128B-swizzled, into a
//    5-stage ring signalled by mbarriers; two consumer warpgroups each run
//    wgmma.mma_async.m64n128k32.s32.s8.s8 on 64 of the rows, with both
//    operands K-major from shared-memory descriptors, one wgmma group kept
//    in flight, and apply the epilogue from their accumulator registers.
//    Ragged M, N and K edges are TMA's zero fill plus a bounds check on the
//    store. It needs K % 16 == 0 and 16-byte aligned operands (TMA's
//    stride and address rules); the plan sends it only K, N >= 128.
//
// ptxas (nvcc 12.8, sm_90a, -Xptxas -v): the wgmma kernel 90 registers; the
// split-K kernels 64 / 64-70-72-96 registers (cp.async form, MT 8 / 16-32-64)
// and 32-56 (ragged form); no spills, no stack; dynamic shared memory
// 164,944 bytes (wgmma) and 41,472-73,728 bytes (split-K, by MT).
//
// Left for later work: a persistent grid that overlaps one tile's epilogue
// with the next one's loads, 128 x 256 tiles, TMA multicast in clusters,
// and a TMA store of the output.

#include "hopper.cuh"

namespace {

using namespace hopper;

__device__ __forceinline__ float dequant(int acc, float a_scale, float w_scale) {
  const float as = a_scale == 0.0f ? 1.0f : a_scale;
  return __int2float_rn(acc) / (as * w_scale);
}

// ---------------------------------------------------------------------------
// 1. Split-K, swap-AB, mma.sync.
// ---------------------------------------------------------------------------

constexpr int SK_BN = 64;             // output columns (weight rows) a block
constexpr int SK_BK = 128;            // bytes of K a stage
constexpr int SK_LDS = SK_BK + 16;    // shared row stride: conflict-free fragments
constexpr int SK_STAGES = 4;
constexpr int SK_THREADS = 128;

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Grid: (ceil(N / 64), ceil(M / MT), splits); slice z covers K bytes
// [z * k_chunk, min(K, (z + 1) * k_chunk)). With splits > 1, `ws` holds the
// int32 sums [M, N] (zeroed) and then one counter per (x, y) tile.
template <int MT, bool VEC>
__global__ void __launch_bounds__(SK_THREADS)
w8a8_splitk_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w,
                   const float* __restrict__ a_scale,
                   const float* __restrict__ w_scale, float* __restrict__ out,
                   int* __restrict__ ws, int M, int N, int K, int k_chunk,
                   int splits) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ int is_last;
  constexpr int ROWS = SK_BN + MT;
  constexpr int STAGE = ROWS * SK_LDS;
  constexpr int CHUNKS = ROWS * (SK_BK / 16);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * SK_BN;
  const int m0 = blockIdx.y * MT;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  const int nsteps = kend > kbeg ? (kend - kbeg + SK_BK - 1) / SK_BK : 0;

  auto load_stage = [&](int slot, int step) {
    int8_t* base = smem + slot * STAGE;
    const int k0 = kbeg + step * SK_BK;
    for (int c = tid; c < CHUNKS; c += SK_THREADS) {
      const int r = c / (SK_BK / 16);
      const int col = (c % (SK_BK / 16)) * 16;
      const bool is_w = r < SK_BN;
      const int row = is_w ? n0 + r : m0 + (r - SK_BN);
      const int8_t* src = is_w ? w : q;
      const int valid = row < (is_w ? N : M) ? min(max(kend - (k0 + col), 0), 16) : 0;
      int8_t* dst = base + r * SK_LDS + col;
      if (VEC) {
        // K % 16 == 0 and k_chunk % 128 == 0: `valid` is 0 or 16.
        cp_async16(smem_u32(dst), valid > 0 ? src + (size_t)row * K + k0 + col : src,
                   valid);
      } else {
        const int8_t* s = src + (size_t)row * K + k0 + col;
#pragma unroll
        for (int b = 0; b < 16; ++b) dst[b] = b < valid ? s[b] : 0;
      }
    }
  };

  int acc[MT / 8][4];
#pragma unroll
  for (int j = 0; j < MT / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0;

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
    const int8_t* Ws = smem + (it % SK_STAGES) * STAGE;
    const int8_t* Qs = Ws + SK_BN * SK_LDS;
#pragma unroll
    for (int kk = 0; kk < SK_BK; kk += 32) {
      unsigned a[4];
      const int8_t* ap = Ws + (warp * 16 + g) * SK_LDS + kk + t * 4;
      a[0] = lds32(ap);
      a[1] = lds32(ap + 8 * SK_LDS);
      a[2] = lds32(ap + 16);
      a[3] = lds32(ap + 8 * SK_LDS + 16);
#pragma unroll
      for (int j = 0; j < MT / 8; ++j) {
        const int8_t* bp = Qs + (j * 8 + g) * SK_LDS + kk + t * 4;
        mma_s8(acc[j], a, lds32(bp), lds32(bp + 16));
      }
    }
  }
  cp_async_wait<0>();

  // acc[j][r] is out[m][n] for n = n0 + warp * 16 + g (+ 8 for r >= 2) and
  // m = m0 + j * 8 + 2t + (r & 1).
  const bool direct = splits == 1;
#pragma unroll
  for (int j = 0; j < MT / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + warp * 16 + g + (r >= 2 ? 8 : 0);
      const int m = m0 + j * 8 + 2 * t + (r & 1);
      if (n < N && m < M) {
        if (direct) {
          out[(size_t)m * N + n] = dequant(acc[j][r], a_scale[m], w_scale[n]);
        } else {
          atomicAdd(ws + (size_t)m * N + n, acc[j][r]);
        }
      }
    }
  }
  if (direct) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = ws + (size_t)M * N + blockIdx.y * gridDim.x + blockIdx.x;
    is_last = atomicAdd(counter, 1) == splits - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // The last slice of this tile: every other slice's sums are in `ws`.
#pragma unroll
  for (int j = 0; j < MT / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + warp * 16 + g + (r >= 2 ? 8 : 0);
      const int m = m0 + j * 8 + 2 * t + (r & 1);
      if (n < N && m < M) {
        out[(size_t)m * N + n] =
            dequant(__ldcg(ws + (size_t)m * N + n), a_scale[m], w_scale[n]);
      }
    }
  }
}

template <int MT, bool VEC>
int launch_splitk(const void* q, const void* w, const void* a_scale,
                  const void* w_scale, void* out, void* ws, int M, int N, int K,
                  int k_chunk, int splits, cudaStream_t stream) {
  const int smem = SK_STAGES * (SK_BN + MT) * SK_LDS;
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(w8a8_splitk_kernel<MT, VEC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr_set = true;
  }
  dim3 grid((N + SK_BN - 1) / SK_BN, (M + MT - 1) / MT, splits);
  w8a8_splitk_kernel<MT, VEC><<<grid, SK_THREADS, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(w),
      static_cast<const float*>(a_scale), static_cast<const float*>(w_scale),
      static_cast<float*>(out), static_cast<int*>(ws), M, N, K, k_chunk, splits);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int dispatch_splitk(int mt, const void* q, const void* w, const void* a_scale,
                    const void* w_scale, void* out, void* ws, int M, int N, int K,
                    int k_chunk, int splits, cudaStream_t s) {
  switch (mt) {
    case 8: return launch_splitk<8, VEC>(q, w, a_scale, w_scale, out, ws, M, N, K, k_chunk, splits, s);
    case 16: return launch_splitk<16, VEC>(q, w, a_scale, w_scale, out, ws, M, N, K, k_chunk, splits, s);
    case 32: return launch_splitk<32, VEC>(q, w, a_scale, w_scale, out, ws, M, N, K, k_chunk, splits, s);
    case 64: return launch_splitk<64, VEC>(q, w, a_scale, w_scale, out, ws, M, N, K, k_chunk, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// 2. wgmma + TMA, warp-specialized.
// ---------------------------------------------------------------------------

constexpr int LG_BM = 128;
constexpr int LG_BN = 128;
constexpr int LG_BK = 128;  // bytes: one 128B swizzle row
constexpr int LG_STAGES = 5;
constexpr int LG_GROUP = 8;  // row tiles a raster group
constexpr int LG_A_BYTES = LG_BM * LG_BK;
constexpr int LG_STAGE_BYTES = LG_A_BYTES + LG_BN * LG_BK;
constexpr int LG_SMEM = LG_STAGES * LG_STAGE_BYTES + 1024 + 2 * LG_STAGES * 8;
constexpr int LG_THREADS = 384;  // consumer warpgroups 0-1, producer warpgroup 2

__global__ void __launch_bounds__(LG_THREADS, 1)
w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                  const __grid_constant__ CUtensorMap tmap_w,
                  const float* __restrict__ a_scale,
                  const float* __restrict__ w_scale, float* __restrict__ out, int M,
                  int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + LG_STAGES * LG_STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (LG_STAGES + s); };

  const int tiles_m = (M + LG_BM - 1) / LG_BM;
  const int tiles_n = (N + LG_BN - 1) / LG_BN;
  const int id = blockIdx.x;
  const int group = id / (LG_GROUP * tiles_n);
  const int first_m = group * LG_GROUP;
  const int group_m = min(tiles_m - first_m, LG_GROUP);
  const int tm = first_m + (id % group_m);
  const int tn = (id % (LG_GROUP * tiles_n)) / group_m;
  const int nk = (K + LG_BK - 1) / LG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < LG_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    if (threadIdx.x == 256) {
      tma_prefetch(&tmap_q);
      tma_prefetch(&tmap_w);
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % LG_STAGES;
        if (kb >= LG_STAGES) mbar_wait(empty(s), ((kb / LG_STAGES) - 1) & 1);
        const uint32_t dst = base + s * LG_STAGE_BYTES;
        mbar_arrive_expect_tx(full(s), LG_STAGE_BYTES);
        tma_load_2d(dst, &tmap_q, full(s), kb * LG_BK, tm * LG_BM);
        tma_load_2d(dst + LG_A_BYTES, &tmap_w, full(s), kb * LG_BK, tn * LG_BN);
      }
    }
    return;
  }

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % LG_STAGES;
    mbar_wait(full(s), (kb / LG_STAGES) & 1);
    const uint32_t a_tile = base + s * LG_STAGE_BYTES + wg * 64 * LG_BK;
    const uint32_t b_tile = base + s * LG_STAGE_BYTES + LG_A_BYTES;
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < LG_BK / 32; ++k) {
      wgmma_s8_m64n128k32(acc, desc_sw128(a_tile + k * 32), desc_sw128(b_tile + k * 32));
    }
    wgmma_commit();
    reg_fence(acc);
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (kb > 0) mbar_arrive(empty((kb - 1) % LG_STAGES));
  }
  wgmma_wait<0>();
  reg_fence(acc);

  // acc[4j + 2h + e] is row 16 * warp + g + 8h, column 8j + 2t + e of this
  // warpgroup's 64 x 128 tile.
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x & 127) >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = tm * LG_BM + wg * 64 + warp * 16 + g + 8 * h;
    if (m >= M) continue;
    const float as = a_scale[m];
    float* orow = out + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = tn * LG_BN + 8 * j + 2 * t;
      if (n + 1 < N && (N & 1) == 0) {
        *reinterpret_cast<float2*>(orow + n) =
            make_float2(dequant(acc[4 * j + 2 * h], as, w_scale[n]),
                        dequant(acc[4 * j + 2 * h + 1], as, w_scale[n + 1]));
      } else {
        if (n < N) orow[n] = dequant(acc[4 * j + 2 * h], as, w_scale[n]);
        if (n + 1 < N) orow[n + 1] = dequant(acc[4 * j + 2 * h + 1], as, w_scale[n + 1]);
      }
    }
  }
}

// A 2-D int8 tensor map of [rows, K] (row stride K bytes), box 128 x 128.
int encode_int8(CUtensorMap* map, const void* ptr, int rows, int K) {
  ct2_encode_tiled_fn encode = ct2_encode_tiled();
  if (encode == nullptr) return CT2_ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)LG_BK, 128u};
  const cuuint32_t elem[2] = {1u, 1u};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : CT2_ERR_ENCODE + static_cast<int>(r);
}

}  // namespace

// Path 1 (see the note at the top). `ws`: int32 [M * N + tiles] zeroed when
// splits > 1, else unused. `mt` is 8, 16, 32 or 64; `vec` (0/1) selects the
// cp.async form, which needs K % 16 == 0, 16-byte aligned operands and
// k_chunk % 128 == 0. Returns cudaGetLastError() after the launch.
extern "C" int ct2_w8a8_gemm_splitk(const void* q, const void* w, const void* a_scale,
                                    const void* w_scale, void* out, void* ws, int M,
                                    int N, int K, int mt, int k_chunk, int splits,
                                    int vec, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? dispatch_splitk<true>(mt, q, w, a_scale, w_scale, out, ws, M, N, K, k_chunk, splits, s)
             : dispatch_splitk<false>(mt, q, w, a_scale, w_scale, out, ws, M, N, K, k_chunk, splits, s);
}

// Path 2. Needs K % 16 == 0 and 16-byte aligned q and w. Returns
// cudaGetLastError() after the launch, or CT2_ERR_* if a tensor map could
// not be made.
extern "C" int ct2_w8a8_gemm_wgmma(const void* q, const void* w, const void* a_scale,
                                   const void* w_scale, void* out, int M, int N, int K,
                                   void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap tq, tw;
  int err = encode_int8(&tq, q, M, K);
  if (err == 0) err = encode_int8(&tw, w, N, K);
  if (err != 0) return err;
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(w8a8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         LG_SMEM);
    attr_set = true;
  }
  const long long tiles = (long long)((M + LG_BM - 1) / LG_BM) * ((N + LG_BN - 1) / LG_BN);
  w8a8_wgmma_kernel<<<(unsigned)tiles, LG_THREADS, LG_SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, tw, static_cast<const float*>(a_scale), static_cast<const float*>(w_scale),
      static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
