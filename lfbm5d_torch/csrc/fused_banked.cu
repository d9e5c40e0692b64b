// Group-stage kernel for groups beyond one block's shared memory (sm_90a),
// plain C interface for ctypes.
//
// lfbm5d_group_step_banked replaces lfbm5d_tpu/kernels/fused.py::
// fused_group_step_banked (TPU: the fused group stage for 128 < A <= 384,
// split over 128-lane banks with banks^2 angular block matmuls). "Banked" is
// a TPU notion: nothing here is banked; the name only points at the
// counterpart. The kernel computes exactly what csrc/fused.cu computes (the
// same passes, csrc/group_stage.cuh; same contract, deferred den included)
// for groups that do not fit the 227 KB of shared memory a block may use:
// 17x17 grids at N=8 (N*A*k^2 f32 = 592 KB per plane) and N=16 at 9x9
// (332 KB). Each block owns a slice of a device-memory workspace holding its
// group (N*A*k^2 floats) and, for Wiener, the basic group's factors (as
// many again); the passes stream over it, and only the transform tables and
// the patch origins stay in shared memory. The angular grid side is at most
// MAXG = 19 (items keep their values in registers; 19x19 is the largest
// square grid of at most 384 SAIs), N at most 16, A at most 384.
//
// What bounds it on this card: the workspace traffic. Every pass reads and
// writes the group once, about 16 passes per (group, channel), so ~9 MB per
// group-channel at 17x17 N=8; with grid x 0.6 MB (x 1.2 MB for Wiener) of
// workspace the traffic would stay in the 50 MB L2 for a grid of a few
// dozen blocks; measured, one block per SM (132, 78 MB) is still the
// fastest (PERF.md), so the wrapper (kernels/fused.py) launches that.

#include "group_stage.cuh"

namespace {

constexpr int MAXG = 19;
constexpr int MAXA = 384;

__global__ void __launch_bounds__(THREADS, 1) banked_kernel(Args p) {
  extern __shared__ float sm[];
  const int ps = p.N * p.A;
  float* M = sm;  // transform tables
  int* oy = (int*)(M + table_floats(p.N, p.levels, p.aH, p.aW));
  float* B = p.group + (size_t)blockIdx.x * KK * ps;
  run_groups<MAXG>(p, B, ps, M, oy, oy + ps);
}

// Dynamic shared memory the banked kernel needs, in bytes.
int banked_smem_bytes(int n, int a, int a_h, int a_w) {
  const int msize = table_floats(n, stack_levels(n), a_h, a_w);
  return static_cast<int>(sizeof(float) * (msize + 2 * n * a));
}

}  // namespace

extern "C" {

// As lfbm5d_group_step (doff included), plus `group`: a [grid, k^2 * N * A]
// f32 workspace.
int lfbm5d_group_step_banked(const void* noisy, const void* basic,
                             const void* bidx, const void* doff,
                             const void* sim_y, const void* sim_x,
                             const void* lvl, const void* mask,
                             const void* sigma, const void* mats, void* num,
                             void* wden, void* work, void* group, int T,
                             int N, int A, int aH, int aW, int C, int Hp,
                             int Wp, int V0, int V1, int nd, int ref,
                             int wiener, float lambda, int grid,
                             void* stream) {
  if (N > MAXN || aH > MAXG || aW > MAXG || A > MAXA || aH * aW != A)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = banked_smem_bytes(N, A, aH, aW);
  cudaError_t err = cudaFuncSetAttribute(
      banked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args p = make_args(noisy, basic, bidx, doff, sim_y, sim_x, lvl, mask,
                           sigma, mats, num, wden, work, group, T, N, A, aH,
                           aW, C, Hp, Wp, V0, V1, nd, ref, wiener, lambda);
  banked_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
