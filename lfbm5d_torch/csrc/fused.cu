// Group-stage kernel for Hopper (sm_90a), plain C interface for ctypes.
//
// lfbm5d_group_step replaces lfbm5d_tpu/kernels/fused.py::fused_group_step
// (TPU: extract by lane mux -> matmul chain -> shrink -> inverse -> banded
// read-modify-write aggregation, per tile of reference patches, with the
// disparity table sampled beforehand by kernels/gather.py::sample_doff).
// It takes the groups the step's `fused` route sends it: aH, aW <= 16,
// N <= 16, and a group whose shared-memory budget fits one block
// (lfbm5d_group_smem_bytes, the route rule of kernels/fused.py::group_fits).
//
// Contract (kernels/fused.py): per (group, channel) the origin of every live
// patch (slot n, SAI a) is sim + displacement(bidx[a, sim_y, sim_x]), or
// doff[t, n, a] when a per-slot table is given, with the reference SAI's own
// patch undisplaced; forward spatial F2 X F2^T, angular along s then t,
// stack by the group's 2**lvl matrix; HT (|c| >= lambda*sigma, weight
// 1/(sigma^2 max(nnz,1))) or Wiener (omega = B^2/(B^2+sigma^2) from the
// basic group, weight 1/(sigma^2 sum omega^2)); inverse; num += est*w*kaiser
// at every patch pixel and wden += w at the patch origin only (the caller
// convolves wden with the Kaiser window once per step). Slots beyond 2**lvl
// and all-masked (flat) groups add nothing; a dead group is skipped at once.
// The atomics' order varies from run to run, so sums agree with the plain
// version to f32 rounding.
//
// Design (csrc/group_stage.cuh): one group per thread-block cluster, the 64
// spatial frequencies split over its cs CTAs; the spatial transform runs in
// registers at gather and at aggregation, the coefficients move once each
// way through distributed shared memory, and the angular and stack passes
// run unrolled per length on each CTA's slice against tables in constant
// memory. Group and Wiener factors never leave the SMs. At the flagship
// (N=8, 9x9) HT runs cs=2, Wiener cs=4, two 256-thread CTAs per SM.
//
// What bounds it on this card: fp32 operations (about 3.5 M multiply-adds
// per group-channel at N=8, A=81 for HT, 5.2 M for Wiener), issued beside
// one shared-memory load per transform line (not per multiply-add), the
// f32 atomics of aggregation (ns*A*64 per group-channel) and three cluster
// barriers per group-channel.
//
// group_kernel<true> is the bfloat16 chain (lfbm5d_tpu/kernels/fused.py with
// cdt = bfloat16, the reference's `pallas_bf16` engine), picked by the
// launch's bf16 argument: the same passes with the rounding points of
// group_stage.cuh, except that the angular transform is one dense
// contraction over the SAIs with the bf16-rounded kron table (kang), as the
// reference's, run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// sums). Its design for this card: the slice is bf16 (every value the
// chain stores is bf16-exact, so it is lossless and halves the DSMEM and
// shared bytes), laid out so ldmatrix builds the B fragments and
// stmatrix.trans writes the outputs straight from and to the item rows;
// both dense tables stay in shared memory for the kernel's life (cp.async
// once per CTA, not per group and channel); and each table fragment a warp
// reads feeds the products of four 8-item tiles (two at A > 112). It is
// instantiated per tile count of the table (group_kernel<true, 1..8>,
// picked by with_tiles), so each instantiation inlines one copy of the
// tensor-core pass and none spills at 128 registers.

#include "group_stage.cuh"

namespace {

constexpr int MAXG = 16;

// BF16: the bfloat16 transform chain (group_stage.cuh), instantiated per
// tile count TILES of its angular table (with_tiles).
template <bool BF16, int TILES = 0>
__global__ void __launch_bounds__(MAX_THREADS, 1) group_kernel(Args p) {
  extern __shared__ float sm[];
  run_groups<MAXG, BF16, TILES>(p, sm);
}

}  // namespace

extern "C" {

// The route budget of the fused route in bytes: the group in one block's
// shared memory ([k^2][(N*A)|1]), the packed tables and the patch origins.
// kernels/fused.py::group_smem_bytes is its copy; routes follow it.
int lfbm5d_group_smem_bytes(int n, int a, int a_h, int a_w) {
  const int levels = 32 - __builtin_clz(n);
  const int tables = 3 * KK + 2 * (a_h * a_h + a_w * a_w) + 2 * levels * n * n;
  return static_cast<int>(sizeof(float) *
                          (KK * ((n * a) | 1) + tables + 2 * n * a));
}

// out[5]: cluster size, threads, dynamic shared bytes per CTA, max active
// clusters and CTAs per SM of the group kernel at this shape;
// bf16: the bfloat16 chain's instantiation.
int lfbm5d_group_occupancy(int N, int aH, int aW, int wiener, int bf16,
                           int* out) {
  if (!bf16) return occupancy(group_kernel<false>, N, aH, aW, wiener, 0, out);
  return with_tiles(aH * aW, [&](auto t) {
    constexpr int T = decltype(t)::value;
    return occupancy(group_kernel<true, T>, N, aH, aW, wiener, 1, out);
  });
}

// doff: [T, N, A] per-slot displacement indices, or null to read them from
// bidx (the step's `direct` mode). tables: kernels/fused.py::kernel_tables
// (bf16-rounded for bf16 = 1, which launches the bfloat16 chain). kang:
// the bfloat16 chain's dense angular tables, bf16 [2][KP][KP] with KP = A
// rounded up to 16 (GroupTables.dense), or null (f32, or no angular
// transform); bf16 takes A <= 128.
int lfbm5d_group_step(const void* noisy, const void* basic, const void* bidx,
                      const void* doff, const void* sim_y, const void* sim_x,
                      const void* lvl, const void* mask, const void* sigma,
                      const void* tables, const void* kang, void* num,
                      void* wden, int T, int N,
                      int A, int aH, int aW, int C, int Hp, int Wp, int V0,
                      int V1, int nd, int ref, int wiener, int bf16,
                      float lambda, void* stream) {
  if (N > MAXN || aH > MAXG || aW > MAXG || aH * aW != A ||
      (bf16 && A > KT))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p = make_args(noisy, basic, bidx, doff, sim_y, sim_x, lvl, mask,
                           sigma, kang, num, wden, T, N, A, aH, aW, C, Hp,
                           Wp, V0, V1, nd, ref, wiener, lambda);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16) return launch_groups(group_kernel<false>, p, tables, 0, st);
  return with_tiles(A, [&](auto t) {
    constexpr int T = decltype(t)::value;
    return launch_groups(group_kernel<true, T>, p, tables, 1, st);
  });
}

#ifdef LFBM5D_PHASE_CLOCKS
// The phase counters of this library's kernel (group_stage.cuh), u64[NCLOCK]
// to out, zeroed after if reset: the counter build only.
int lfbm5d_group_clocks(void* out, int reset) {
  return read_phase_clocks(out, reset);
}
#endif

}  // extern "C"
