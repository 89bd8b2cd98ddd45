// Fused multi-array row gather for Hopper (sm_90a): the beam reorder.
//
// Replaces ctranslate2_tpu/kernels/gather_rows.py::gather_rows_fused (the
// Pallas kernel _copy_kernel). For every array a of the table and every
// output row n it copies
//
//     dst_a[n, ...] = src_a[rows[n], ...]
//
// out of place, in ONE launch for all arrays (the per-layer K/V caches of
// a beam step).
//
// What bounds it on the H100: it is pure data movement, each cache byte
// read once and written once, so the least time is 2 * bytes / 3.35 TB/s.
// Nothing is computed.
//
// Design: one 256-thread block per (output row, array) pair, grid
// (rows, arrays). A block copies its row with 16-byte vector loads and
// stores, four in flight per thread, so neighbouring threads touch
// neighbouring addresses. The table of (source, destination, row bytes)
// travels by value in the kernel's parameter block, so a step needs no
// host-to-device copy of it; rows whose size or addresses are not 16-byte
// aligned take a byte-wise loop. The row indices are trusted: the caller
// guarantees 0 <= rows[n] < number of source rows.

#include <cuda_runtime.h>
#include <stdint.h>

#define CT2_GATHER_MAX_ARRAYS 128

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

struct GatherTable {
  const char* src[CT2_GATHER_MAX_ARRAYS];
  char* dst[CT2_GATHER_MAX_ARRAYS];
  long long row_bytes[CT2_GATHER_MAX_ARRAYS];
};

__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const GatherTable table, const int* __restrict__ rows) {
  const int n = blockIdx.x;
  const int a = blockIdx.y;
  const long long nbytes = table.row_bytes[a];
  const char* src = table.src[a] + (long long)rows[n] * nbytes;
  char* dst = table.dst[a] + (long long)n * nbytes;

  const bool vec = (((uintptr_t)src | (uintptr_t)dst | (uintptr_t)nbytes) & 15) == 0;
  if (vec) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    const long long nvec = nbytes / 16;
    long long i = threadIdx.x;
    for (; i + (UNROLL - 1) * THREADS < nvec; i += UNROLL * THREADS) {
      int4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = s[i + u * THREADS];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) d[i + u * THREADS] = v[u];
    }
    for (; i < nvec; i += THREADS) d[i] = s[i];
  } else {
    for (long long i = threadIdx.x; i < nbytes; i += THREADS) dst[i] = src[i];
  }
}

}  // namespace

extern "C" int ct2_gather_max_arrays() { return CT2_GATHER_MAX_ARRAYS; }

// srcs/dsts/row_bytes: host arrays of `num_arrays` entries; rows: device
// int32 [num_rows]. Returns cudaGetLastError() after the launch.
extern "C" int ct2_gather_rows(const long long* srcs, const long long* dsts,
                               const long long* row_bytes, int num_arrays,
                               const void* rows, int num_rows, void* stream) {
  if (num_arrays < 0 || num_arrays > CT2_GATHER_MAX_ARRAYS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_arrays == 0 || num_rows == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  GatherTable table;
  for (int a = 0; a < num_arrays; ++a) {
    table.src[a] = reinterpret_cast<const char*>(srcs[a]);
    table.dst[a] = reinterpret_cast<char*>(dsts[a]);
    table.row_bytes[a] = row_bytes[a];
  }
  dim3 grid(num_rows, num_arrays);
  gather_rows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<const int*>(rows));
  return static_cast<int>(cudaGetLastError());
}
