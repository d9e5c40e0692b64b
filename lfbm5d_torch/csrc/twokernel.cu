// Two-kernel group path for Hopper (sm_90a), plain C interface for ctypes.
//
// lfbm5d_extract_groups replaces lfbm5d_tpu/kernels/extract.py::extract_groups
//   (TPU: per-slot superpatch slice of an A-on-lanes band and a per-lane
//   (dy, dx) mux). Here the planes stay planar [P, A, Hp, Wp] and each block
//   owns one slot (group g, stack index n) of one plane:
//     out[p, g, n, pix, a] = plane[p, a, sy + dy(a) + pix / k,
//                                        sx + dx(a) + pix % k]
//   with (dy, dx) the displacement of bidx[a, sy, sx] (the reference SAI's
//   own patch undisplaced: kernels/gather.py::sample_doff folded in), or of
//   doff[slot, a] where the step hands a per-slot table over. SAIs
//   go in tiles of 32 through shared memory, so the reads walk patch rows
//   and the writes walk the A axis. Masked slots are written as zeros. A
//   pure copy: bit-equal to its plain version.
//
// lfbm5d_accumulate_groups replaces lfbm5d_tpu/kernels/accumulate.py::
//   accumulate_groups_fused (den != null) and ::accumulate_groups (den ==
//   null): the inverse scatter, num[p, a, y, x] += vals[p, g, n, pix, a] at
//   the same offsets, and with den den[...] += wv[p, g, n] * kaiser[pix]
//   (the direct denominator). Overlapping patches add by f32 atomicAdd, so
//   sums agree with the plain version to f32 rounding in another order
//   (relative 1e-5). Masked slots are skipped (their values are zero).
//
// What bounds them on this card: both move one group tensor (S*k^2*A floats
// per plane) through device memory once and touch the planes at the patch
// footprints; the extract is bound by bytes, the accumulate by the atomics
// (one per value, two with den) in L2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int ATILE = 32;  // SAIs per shared-memory tile
constexpr int TSTRIDE = ATILE + 1;

struct Geo {
  const int* bidx;       // [A, V0, V1]
  const int* doff;       // [S, A] per-slot displacements, or null: bidx
  const int* sim_y;      // [S]
  const int* sim_x;      // [S]
  const uint8_t* mask;   // [S]
  int S, A, Hp, Wp, V0, V1, k, nd, ref;
};

// Plane offset of pixel `pix` of SAI a's patch for slot s.
__device__ __forceinline__ size_t patch_at(const Geo& g, int s, int a,
                                           int pix) {
  const int nsel = 2 * g.nd + 1;
  const int sy = g.sim_y[s], sx = g.sim_x[s];
  const int d = a == g.ref ? g.nd * nsel + g.nd
                : g.doff   ? g.doff[(size_t)s * g.A + a]
                           : g.bidx[((size_t)a * g.V0 + sy) * g.V1 + sx];
  const int y = sy + d / nsel - g.nd + pix / g.k;
  const int x = sx + d % nsel - g.nd + pix % g.k;
  return ((size_t)a * g.Hp + y) * g.Wp + x;
}

__global__ void __launch_bounds__(THREADS)
extract_kernel(const float* __restrict__ planes, float* __restrict__ out,
               Geo g) {
  extern __shared__ float tile[];  // [k*k][TSTRIDE]
  const int s = blockIdx.x, p = blockIdx.y;
  const int kk = g.k * g.k;
  float* o = out + ((size_t)p * g.S + s) * kk * g.A;
  if (!g.mask[s]) {
    for (int i = threadIdx.x; i < kk * g.A; i += THREADS) o[i] = 0.f;
    return;
  }
  const float* pl = planes + (size_t)p * g.A * g.Hp * g.Wp;
  for (int a0 = 0; a0 < g.A; a0 += ATILE) {
    const int na = min(ATILE, g.A - a0);
    for (int i = threadIdx.x; i < na * kk; i += THREADS) {
      const int al = i / kk, pix = i % kk;
      tile[pix * TSTRIDE + al] = pl[patch_at(g, s, a0 + al, pix)];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kk * na; i += THREADS) {
      const int pix = i / na, al = i % na;
      o[(size_t)pix * g.A + a0 + al] = tile[pix * TSTRIDE + al];
    }
    __syncthreads();
  }
}

template <bool kDen>
__global__ void __launch_bounds__(THREADS)
accumulate_kernel(const float* __restrict__ vals,
                  const float* __restrict__ wv,
                  const float* __restrict__ kaiser, float* __restrict__ num,
                  float* __restrict__ den, Geo g) {
  extern __shared__ float tile[];  // [k*k][TSTRIDE]
  const int s = blockIdx.x, p = blockIdx.y;
  if (!g.mask[s]) return;
  const int kk = g.k * g.k;
  const float* v = vals + ((size_t)p * g.S + s) * kk * g.A;
  const size_t plane = (size_t)g.A * g.Hp * g.Wp;
  float* nump = num + p * plane;
  float* denp = kDen ? den + p * plane : nullptr;
  const float w = kDen ? wv[(size_t)p * g.S + s] : 0.f;
  for (int a0 = 0; a0 < g.A; a0 += ATILE) {
    const int na = min(ATILE, g.A - a0);
    for (int i = threadIdx.x; i < kk * na; i += THREADS) {
      const int pix = i / na, al = i % na;
      tile[pix * TSTRIDE + al] = v[(size_t)pix * g.A + a0 + al];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < na * kk; i += THREADS) {
      const int al = i / kk, pix = i % kk;
      const size_t at = patch_at(g, s, a0 + al, pix);
      atomicAdd(nump + at, tile[pix * TSTRIDE + al]);
      if (kDen) atomicAdd(denp + at, w * kaiser[pix]);
    }
    __syncthreads();
  }
}

Geo make_geo(const void* bidx, const void* doff, const void* sim_y,
             const void* sim_x, const void* mask, int S, int A, int Hp,
             int Wp, int V0, int V1, int k, int nd, int ref) {
  Geo g;
  g.bidx = static_cast<const int*>(bidx);
  g.doff = static_cast<const int*>(doff);
  g.sim_y = static_cast<const int*>(sim_y);
  g.sim_x = static_cast<const int*>(sim_x);
  g.mask = static_cast<const uint8_t*>(mask);
  g.S = S;
  g.A = A;
  g.Hp = Hp;
  g.Wp = Wp;
  g.V0 = V0;
  g.V1 = V1;
  g.k = k;
  g.nd = nd;
  g.ref = ref;
  return g;
}

}  // namespace

extern "C" {

// planes [P, A, Hp, Wp] f32; bidx [A, V0, V1]; doff [S, A] int32 or null
// (then displacements come from bidx); sim_y/sim_x [S] int32 and mask [S]
// uint8 (S = G*N slots); out [P, S, k*k, A] f32.
int lfbm5d_extract_groups(const void* planes, const void* bidx,
                          const void* doff, const void* sim_y,
                          const void* sim_x, const void* mask, void* out,
                          int S, int P, int A, int Hp, int Wp, int V0, int V1,
                          int k, int nd, int ref, void* stream) {
  const Geo g = make_geo(bidx, doff, sim_y, sim_x, mask, S, A, Hp, Wp, V0,
                         V1, k, nd, ref);
  const int smem = k * k * TSTRIDE * static_cast<int>(sizeof(float));
  extract_kernel<<<dim3(S, P), THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<float*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

// vals [P, S, k*k, A] f32; wv [P, S] f32 and kaiser [k*k] f32 (den only);
// num, den [P, A, Hp, Wp] f32 accumulated in place; den null: num only.
int lfbm5d_accumulate_groups(const void* vals, const void* wv,
                             const void* kaiser, const void* bidx,
                             const void* doff, const void* sim_y,
                             const void* sim_x, const void* mask, void* num,
                             void* den, int S, int P, int A, int Hp, int Wp,
                             int V0, int V1, int k, int nd, int ref,
                             void* stream) {
  const Geo g = make_geo(bidx, doff, sim_y, sim_x, mask, S, A, Hp, Wp, V0,
                         V1, k, nd, ref);
  const int smem = k * k * TSTRIDE * static_cast<int>(sizeof(float));
  const dim3 grid(S, P);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const float* w = static_cast<const float*>(wv);
  const float* kai = static_cast<const float*>(kaiser);
  if (den)
    accumulate_kernel<true><<<grid, THREADS, smem, st>>>(
        v, w, kai, static_cast<float*>(num), static_cast<float*>(den), g);
  else
    accumulate_kernel<false><<<grid, THREADS, smem, st>>>(
        v, w, kai, static_cast<float*>(num), nullptr, g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
