// Group-stage kernel for groups beyond one block's shared memory (sm_90a),
// plain C interface for ctypes.
//
// lfbm5d_group_step_banked replaces lfbm5d_tpu/kernels/fused.py::
// fused_group_step_banked (TPU: the fused group stage for 128 < A <= 384,
// split over 128-lane banks with banks^2 angular block matmuls). "Banked" is
// a TPU notion: nothing here is banked; the name only points at the
// counterpart. The kernel computes exactly what csrc/fused.cu computes (same
// contract, deferred den included) for the groups of the step's `banked`
// route: 17x17 grids at N=8 (N*A*k^2 f32 = 592 KB per plane), N=16 at 9x9
// (332 KB), up to aH, aW <= 19 (MAXG; 19x19 is the largest square grid of at
// most 384 SAIs), N <= 16, A <= 384.
//
// Design: the passes of csrc/group_stage.cuh, instantiated for sides up to
// 19. A group is spread over a thread-block cluster large enough to hold it
// in shared memory: 17x17 N=8 HT cs=8, Wiener cs=16; 9x9 N=16 HT cs=4,
// Wiener cs=8; 19x19 N=16 cs=16 (Wiener at one 512-thread CTA per SM, 188 KB
// each; cs=16 is a non-portable cluster size). The workspace the group once
// streamed through L2 for every pass (about 9 MB per group-channel at 17x17
// N=8) is gone: the coefficients cross the cluster once each way.
//
// What bounds it on this card: fp32 operations (the angular passes grow
// with aH + aW: about 8.6 M multiply-adds per transform at 17x17 N=8, two
// transforms per HT group-channel, three per Wiener one), the aggregation
// atomics, and the cluster barriers, which at cs=16 wait on sixteen CTAs.
//
// banked_kernel<true, tiles> is the bfloat16 chain, as group_kernel<true,
// tiles> in csrc/fused.cu; the engine launches it for N=16 groups at grids
// of at most 128 SAIs (the reference's bf16 chain stops at one 128-lane
// bank).

#include "group_stage.cuh"

namespace {

constexpr int MAXG = 19;
constexpr int MAXA = 384;

// BF16: the bfloat16 transform chain (group_stage.cuh), instantiated per
// tile count TILES of its angular table (with_tiles).
template <bool BF16, int TILES = 0>
__global__ void __launch_bounds__(MAX_THREADS, 1) banked_kernel(Args p) {
  extern __shared__ float sm[];
  run_groups<MAXG, BF16, TILES>(p, sm);
}

}  // namespace

extern "C" {

// As lfbm5d_group_occupancy, for the banked kernel.
int lfbm5d_group_occupancy_banked(int N, int aH, int aW, int wiener,
                                  int bf16, int* out) {
  if (!bf16) return occupancy(banked_kernel<false>, N, aH, aW, wiener, 0, out);
  return with_tiles(aH * aW, [&](auto t) {
    constexpr int T = decltype(t)::value;
    return occupancy(banked_kernel<true, T>, N, aH, aW, wiener, 1, out);
  });
}

// As lfbm5d_group_step (doff, bf16 and kang included).
int lfbm5d_group_step_banked(const void* noisy, const void* basic,
                             const void* bidx, const void* doff,
                             const void* sim_y, const void* sim_x,
                             const void* lvl, const void* mask,
                             const void* sigma, const void* tables,
                             const void* kang, void* num, void* wden, int T,
                             int N, int A, int aH, int aW,
                             int C, int Hp, int Wp, int V0, int V1, int nd,
                             int ref, int wiener, int bf16, float lambda,
                             void* stream) {
  if (N > MAXN || aH > MAXG || aW > MAXG || A > MAXA || aH * aW != A ||
      (bf16 && A > KT))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p = make_args(noisy, basic, bidx, doff, sim_y, sim_x, lvl, mask,
                           sigma, kang, num, wden, T, N, A, aH, aW, C, Hp,
                           Wp, V0, V1, nd, ref, wiener, lambda);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16) return launch_groups(banked_kernel<false>, p, tables, 0, st);
  return with_tiles(A, [&](auto t) {
    constexpr int T = decltype(t)::value;
    return launch_groups(banked_kernel<true, T>, p, tables, 1, st);
  });
}

#ifdef LFBM5D_PHASE_CLOCKS
// The phase counters of this library's kernel (group_stage.cuh), u64[NCLOCK]
// to out, zeroed after if reset: the counter build only.
int lfbm5d_group_clocks_banked(void* out, int reset) {
  return read_phase_clocks(out, reset);
}
#endif

}  // extern "C"
