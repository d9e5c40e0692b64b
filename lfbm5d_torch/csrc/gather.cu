// Row gather for Hopper (sm_90a), plain C interface for ctypes.
//
// lfbm5d_gather_rows replaces lfbm5d_tpu/kernels/gather.py::gather_rows
//   (TPU: one row DMA per index from HBM, `depth` copies kept in flight by a
//   rotating semaphore window; the table's minor dim a multiple of 128 and
//   the indices padded to whole chunks). Here:
//     out[s, :] = table[idx[s], :]   table [V, W], idx [S], out [S, W]
//   for any W and any 4-byte element type (int32 or float32: the kernel
//   copies 32-bit words). One warp owns one output row at a time (warps
//   stride over S); lane 0 reads the row index once and broadcasts it, and
//   the lanes copy the row with consecutive lanes on consecutive words, so
//   a row of W words is ceil(W / 32) coalesced loads and stores. Rows need
//   no alignment beyond 4 bytes (W = 81: 324-byte rows).
//
// Indices are the caller's guarantee to lie in [0, V), as in the reference:
// the kernel neither clamps nor checks them.
//
// What bounds it on this card: bytes. It reads S*W words of the table at
// random rows plus S indices and writes S*W words; the rows are whole
// 128-byte lines or close to them, so the traffic is within a line per row
// of the bytes the function must move. Nothing is reused, so there is
// nothing to stage in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const int* __restrict__ table, const int* __restrict__ idx,
                   int* __restrict__ out, int S, int W) {
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * WARPS;
  for (int s = blockIdx.x * WARPS + (threadIdx.x >> 5); s < S; s += nwarps) {
    const int row = __shfl_sync(0xffffffffu, lane == 0 ? idx[s] : 0, 0);
    const int* src = table + (size_t)row * W;
    int* dst = out + (size_t)s * W;
    for (int j = lane; j < W; j += 32) dst[j] = src[j];
  }
}

}  // namespace

extern "C" {

// table [V, W] and out [S, W] of 4-byte elements; idx [S] int32 in [0, V).
int lfbm5d_gather_rows(const void* table, const void* idx, void* out, int S,
                       int W, void* stream) {
  if (S <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (S + WARPS - 1) / WARPS;
  const int grid = blocks < 132 * 32 ? blocks : 132 * 32;
  gather_rows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(idx),
      static_cast<int*>(out), S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
