// Group-stage kernel for Hopper (sm_90a), plain C interface for ctypes.
//
// lfbm5d_group_step replaces lfbm5d_tpu/kernels/fused.py::fused_group_step
// (TPU: extract by lane mux -> matmul chain -> shrink -> inverse -> banded
// read-modify-write aggregation, per tile of reference patches, with the
// disparity table sampled beforehand by kernels/gather.py::sample_doff).
// Here one block owns one group (reference patch t) at a time and walks its
// channels; blocks are persistent and stride over the T groups.
//
// Per (group, channel):
//   prologue  sample_doff folded in: the origin of every live patch (slot n,
//             SAI a) is sim + displacement(bidx[a, sim_y, sim_x]), with the
//             reference SAI's own patch undisplaced; read once per group.
//             Given a per-slot table doff [T, N, A] (the step's `take` and
//             `dma` modes), the displacement is doff[t, n, a] instead.
//   extract   gather the ns*A patches (ns = 2**lvl live slots) into shared
//             memory B, laid out [pixel][slot*A + SAI] with an odd column
//             stride so every pass below is free of bank conflicts.
//   forward   spatial F2 X F2^T per patch (registers), angular transform
//             along s then t, stack transform by the group's 2**lvl matrix.
//   shrink    HT: keep |c| >= lambda*sigma, weight 1/(sigma^2 max(nnz,1));
//             Wiener: omega = B^2/(B^2+sigma^2) from the basic group, which
//             is transformed first with its omega kept in a per-block
//             device-memory workspace (one plane's group is N*A*k^2 floats,
//             166 KB at the matched preset: two do not fit the 227 KB a block
//             may use), weight 1/(sigma^2 sum omega^2).
//   inverse   stack, angular, spatial.
//   aggregate num += est*w*kaiser at every patch pixel by f32 atomicAdd
//             (consecutive threads on consecutive pixels of a patch row);
//             the denominator is DEFERRED: only w goes to the patch origin,
//             and the caller convolves that field with the Kaiser window once
//             per step (pipeline/engine.py). Order of the atomics varies from
//             run to run, so sums agree with the plain twin to f32 rounding.
// Slots beyond 2**lvl and groups whose mask is all false (flat reference
// positions) add nothing: a dead group is skipped at once.
//
// What bounds it on this card: the transform chain is ~4 M fp32
// multiply-adds per group-channel at N=8, A=81, from shared memory, with one
// 175 KB block per SM (16 warps); the atomics are ns*A*k^2 per group-channel.
// It is bound by instruction throughput and shared memory, with little
// latency hiding. The stack depth is at most 16, the angular grid at most
// 16 x 16, k is 8. The passes live in csrc/group_stage.cuh, shared with the
// banked kernel (csrc/fused_banked.cu), which holds the group in device
// memory for groups beyond the shared memory of one block.

#include "group_stage.cuh"

namespace {

constexpr int MAXG = 16;

__global__ void __launch_bounds__(THREADS, 1) group_kernel(Args p) {
  extern __shared__ float sm[];
  const int ps = (p.N * p.A) | 1;  // odd stride: conflict-free passes
  float* B = sm;                   // [KK][ps]
  float* M = B + KK * ps;          // transform tables
  int* oy = (int*)(M + table_floats(p.N, p.levels, p.aH, p.aW));
  run_groups<MAXG>(p, B, ps, M, oy, oy + p.N * p.A);
}

}  // namespace

extern "C" {

// Dynamic shared memory the group kernel needs, in bytes.
int lfbm5d_group_smem_bytes(int n, int a, int a_h, int a_w) {
  const int msize = table_floats(n, stack_levels(n), a_h, a_w);
  return static_cast<int>(sizeof(float) *
                          (KK * ((n * a) | 1) + msize + 2 * n * a));
}

// doff: [T, N, A] per-slot displacement indices, or null to read them from
// bidx (the step's `direct` mode).
int lfbm5d_group_step(const void* noisy, const void* basic, const void* bidx,
                      const void* doff, const void* sim_y, const void* sim_x,
                      const void* lvl, const void* mask, const void* sigma,
                      const void* mats, void* num, void* wden, void* work,
                      int T, int N, int A, int aH, int aW, int C, int Hp,
                      int Wp, int V0, int V1, int nd, int ref, int wiener,
                      float lambda, int grid, void* stream) {
  if (N > MAXN || aH > MAXG || aW > MAXG || aH * aW != A)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = lfbm5d_group_smem_bytes(N, A, aH, aW);
  cudaError_t err = cudaFuncSetAttribute(
      group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args p = make_args(noisy, basic, bidx, doff, sim_y, sim_x, lvl, mask,
                           sigma, mats, num, wden, work, nullptr, T, N, A,
                           aH, aW, C, Hp, Wp, V0, V1, nd, ref, wiener,
                           lambda);
  group_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
