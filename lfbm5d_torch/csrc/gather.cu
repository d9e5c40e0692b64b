// Row gather for Hopper (sm_90a), plain C interface for ctypes.
//
// lfbm5d_gather_rows replaces lfbm5d_tpu/kernels/gather.py::gather_rows
//   (TPU: one row DMA per index from HBM, `depth` copies kept in flight by a
//   rotating semaphore window; the table's minor dim a multiple of 128 and
//   the indices padded to whole chunks). Here:
//     out[s, :] = table[idx[s], :]   table [V, W], idx [S], out [S, W]
//   for any W >= 1, any S >= 0 and any 4-byte element type (int32 or
//   float32: the kernel copies 32-bit words). Rows need no alignment beyond
//   4 bytes (W = 81: 324-byte rows).
//
// Indices are the caller's guarantee to lie in [0, V), as in the reference:
// the kernel neither clamps nor checks them.
//
// What bounds it on this card: bytes, and at the step's sizes (S*W of about
// 2.8M words) the latency of two dependent device-memory reads, since the
// whole gather is a single wave of blocks. The design keeps many reads in
// flight and writes in 16-byte pieces:
//   - a block owns a tile of R consecutive slots (R a multiple of 4, from
//     `make_plan`) and loads their R indices once, coalesced, into shared
//     memory as row offsets;
//   - the tile's output is one contiguous run of R*W words, which starts
//     16-byte aligned (s0*W*4 with s0 a multiple of 4, on an aligned `out`);
//     its threads walk the run in 16-byte vectors, each thread issuing
//     UNROLL vectors (4*UNROLL independent scalar reads of the table,
//     through the read-only path, __ldg) before any store. A thread's 4
//     reads of a vector share 16 bytes, so the warp's second to fourth
//     reads of a line can find it in L1 (a little faster on the card than
//     reads that bypass L1; see PERF.md);
//   - every vector is written with one streaming store (st.global.cs.v4);
//     words before the first 16-byte boundary and after the last whole
//     vector (only where `out` is not 16-byte aligned, or in the last,
//     ragged tile) are scalar stores.
// Table rows are read as scalars: a row starts at any 4-byte offset.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int UNROLL = 4;           // 16-byte vectors in flight per thread
constexpr int TILE_WORDS = 4096;    // output words a tile aims at
constexpr int MAX_ROWS = 1024;      // slots of a tile (shared row offsets)
constexpr int MIN_GRID = 2 * 132;   // blocks to aim for when S allows

struct Plan {
  int rows;     // R: slots per block, a multiple of 4
  int threads;  // a multiple of 32, <= MAX_THREADS
  int grid;     // ceil(S / R)
};

// The launch plan of an [S, W] gather (kernels/gather.py::gather_plan is
// its Python copy): R from the tile's word budget, shrunk (in steps of 4)
// where S is too small to give MIN_GRID blocks; threads to cover the tile's
// vectors UNROLL at a time.
Plan make_plan(int S, int W) {
  int r = TILE_WORDS / W;
  r -= r % 4;
  r = r < 4 ? 4 : (r > MAX_ROWS ? MAX_ROWS : r);
  int fill = S / MIN_GRID;
  fill -= fill % 4;
  if (fill < r) r = fill < 4 ? 4 : fill;
  const int vecs = (r * W + 3) / 4;
  int threads = ((vecs + UNROLL - 1) / UNROLL + 31) / 32 * 32;
  threads = threads > MAX_THREADS ? MAX_THREADS : threads;
  return {r, threads, (S + r - 1) / r};
}

__device__ __forceinline__ void store_cs4(int* p, const int (&v)[4]) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

__global__ void __launch_bounds__(MAX_THREADS)
gather_rows_kernel(const int* __restrict__ table, const int* __restrict__ idx,
                   int* __restrict__ out, int S, int W, int R) {
  __shared__ long long base[MAX_ROWS];
  const int s0 = blockIdx.x * R;
  const int rows = min(R, S - s0);
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    base[r] = (long long)__ldg(idx + s0 + r) * W;
  __syncthreads();

  int* dst = out + (size_t)s0 * W;
  const int n = rows * W;
  // scalar words before the first 16-byte boundary, whole vectors, and the
  // scalar words after the last vector (at most 3 each)
  const int head = min(n, (int)(((16u - ((uintptr_t)dst & 15u)) & 15u) >> 2));
  const int nvec = (n - head) >> 2;
  const int tail = head + nvec * 4;
  if (threadIdx.x < 6) {
    const int p = threadIdx.x < 3 ? threadIdx.x : tail + threadIdx.x - 3;
    if (threadIdx.x < 3 ? p < head : p < n) {
      const int r = p / W;
      dst[p] = __ldg(table + base[r] + (p - r * W));
    }
  }
  const int stride = blockDim.x * UNROLL;
  for (int v0 = threadIdx.x; v0 < nvec; v0 += stride) {
    int vals[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v < nvec) {
        const int p = head + 4 * v;
        int r = p / W;
        int c = p - r * W;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          vals[u][j] = __ldg(table + base[r] + c);
          if (++c == W) {
            c = 0;
            ++r;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v < nvec) store_cs4(dst + head + 4 * v, vals[u]);
    }
  }
}

}  // namespace

extern "C" {

// plan[0..2] = R, threads, grid of an [S, W] gather.
int lfbm5d_gather_plan(int S, int W, int* plan) {
  if (S < 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(S, W);
  plan[0] = p.rows;
  plan[1] = p.threads;
  plan[2] = p.grid;
  return 0;
}

// table [V, W] and out [S, W] of 4-byte elements; idx [S] int32 in [0, V).
int lfbm5d_gather_rows(const void* table, const void* idx, void* out, int S,
                       int W, void* stream) {
  if (S < 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const Plan p = make_plan(S, W);
  gather_rows_kernel<<<p.grid, p.threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(idx),
      static_cast<int*>(out), S, W, p.rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
