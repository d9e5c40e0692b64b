// Two-kernel group path for Hopper (sm_90a), plain C interface for ctypes.
//
// lfbm5d_extract_groups replaces lfbm5d_tpu/kernels/extract.py::extract_groups
//   (TPU: per-slot superpatch slice of an A-on-lanes band and a per-lane
//   (dy, dx) mux). Here the planes stay planar [P, A, Hp, Wp]:
//     out[p, s, pix, a] = plane[p, a, sy + dy(a) + pix / k,
//                                     sx + dx(a) + pix % k]
//   with (dy, dx) the displacement of bidx[a, sy, sx] (the reference SAI's
//   own patch undisplaced: kernels/gather.py::sample_doff folded in), or of
//   doff[s, a] where the step hands a per-slot table over. Masked slots are
//   written as zeros. A pure copy: bit-equal to its plain version.
//
// lfbm5d_accumulate_groups replaces lfbm5d_tpu/kernels/accumulate.py::
//   accumulate_groups_fused (den != null) and ::accumulate_groups (den ==
//   null): the inverse scatter, num[p, a, y, x] += vals[p, s, pix, a] at the
//   same offsets, and with den den[...] += wv[p, s] * kaiser[pix] (the direct
//   denominator). Overlapping patches add by f32 reductions in L2, so sums
//   agree with the plain version to f32 rounding in another order (relative
//   1e-5). Masked slots are skipped (their values are zero).
//
// What bounds them on this card. Each moves one group tensor (k*k*A floats
// per slot and plane) through device memory once, as one contiguous run per
// (slot, plane), and touches the planes at the patch footprints through L2
// (neighbouring patches overlap). The extract is bound by those bytes. The
// accumulate is bound by its reductions in L2, where a warp's reductions
// cost about one request per 32-byte sector they touch: 1 or 2 per 8-float
// patch row, twice with den. The design:
//   - one block per (plane, slot), plane-major, so the blocks in flight work
//     on one plane and on a short run of consecutive groups, whose similar
//     patches overlap: their planes' lines stay in L2 (slot-major order, or
//     slots of distant groups in flight together, were slower on the card);
//   - the plane offset of every SAI's patch origin is looked up once per
//     block (bidx or doff) into a shared base table, so a pixel costs
//     base[a] + row * Wp + col, with k a template parameter;
//   - the run goes through a shared stage [rows * k][pitch] (pitch = SAIs of
//     the tile | 1, odd, so a warp on 32 consecutive pixels of one SAI hits
//     32 banks), chunk by chunk of whole patch rows (any run of whole rows
//     is contiguous in the group tensor). Extract gathers patch rows into it
//     (consecutive lanes on consecutive columns, BATCH loads in flight per
//     thread) and writes it out as one linear stream: aligned 16-byte
//     windows whole inside the run as float4 streaming stores, the ragged
//     head and tail as scalars. Accumulate reads its run the same way with
//     float4 loads, then adds it with one scalar reduction per value,
//     consecutive lanes on consecutive pixels of one SAI, so a warp covers
//     whole patch rows in the fewest sectors. (Hopper's vector reductions,
//     red.global.add.v4/.v2.f32, one thread per patch row, split an
//     unaligned row into 3 or 4 requests instead of 1 or 2 sectors, and were
//     slower on the card at every stage budget tried.)
//   - `make_plan` takes as many whole rows per chunk as fit a shared budget
//     that keeps BLOCKS_PER_SM blocks resident, and tiles the SAI axis only
//     where one row of every SAI does not fit (k = 16 beyond about 780
//     SAIs).
// kernels/extract.py::twokernel_plan is the Python copy of the plan, and
// tests/test_torch_twokernel_tiling.py emulates this decomposition.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;     // resident blocks the stage leaves room
constexpr int SMEM_PER_SM = 233472;  // bytes of shared memory of one SM
constexpr int SMEM_RESERVED = 1024;  // bytes the system keeps per block
constexpr int BATCH = 16;            // gathers in flight per thread

struct Geo {
  const int* bidx;      // [A, V0, V1]
  const int* doff;      // [S, A] per-slot displacements, or null: bidx
  const int* sim_y;     // [S]
  const int* sim_x;     // [S]
  const uint8_t* mask;  // [S]
  int S, P, A, Hp, Wp, V0, V1, nd, ref;
};

// rows: patch rows per chunk; tile: SAIs per tile; pitch: stage row pitch
// (floats); smem: dynamic shared bytes (base table, Kaiser window, stage).
struct Plan {
  int rows, tile, pitch, smem;
};

Plan make_plan(int k, int A) {
  const int limit = SMEM_PER_SM / BLOCKS_PER_SM - SMEM_RESERVED;
  Plan p;
  // one row of every SAI of the tile fits: 8 t + 4 k^2 + 4 k (t + 1) <= limit
  p.tile = (limit - 4 * k * k - 4 * k) / (8 + 4 * k);
  if (p.tile > A) p.tile = A;
  p.pitch = p.tile | 1;
  p.rows = (limit - 8 * p.tile - 4 * k * k) / (4 * k * p.pitch);
  if (p.rows > k) p.rows = k;
  p.smem = 8 * p.tile + 4 * k * k + 4 * p.rows * k * p.pitch;
  return p;
}

__device__ __forceinline__ int misalign(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Walks (outer, inner) pairs of an outer x inner grid, inner fastest, with
// the block's threads in turn: no division after the first.
struct Walk {
  int outer, inner, d_outer, d_inner, n_inner;
  __device__ Walk(int n_in) : n_inner(n_in) {
    outer = threadIdx.x / n_in;
    inner = threadIdx.x - outer * n_in;
    d_outer = THREADS / n_in;
    d_inner = THREADS - d_outer * n_in;
  }
  __device__ __forceinline__ void next() {
    inner += d_inner;
    outer += d_outer;
    if (inner >= n_inner) {
      inner -= n_inner;
      ++outer;
    }
  }
};

// Writes nrun runs of len floats, run r from st + r * spitch (zeros when st
// is null) to dst + r * gstride: aligned 16-byte windows whole inside a run
// as one float4 streaming store, the partial ones at a run's ends scalar.
__device__ void store_runs(float* dst, const float* st, int nrun, int len,
                           size_t gstride, int spitch) {
  const int nw = (len + 6) >> 2;  // windows per run at any misalignment
  for (Walk w(nw); w.outer < nrun; w.next()) {
    float* g = dst + w.outer * gstride;
    const int e = 4 * w.inner - misalign(g);
    if (e >= len) continue;
    const float* s = st + w.outer * spitch;
    if (e >= 0 && e + 4 <= len) {
      const float4 v = st ? make_float4(s[e], s[e + 1], s[e + 2], s[e + 3])
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      __stcs(reinterpret_cast<float4*>(g + e), v);
    } else {
      for (int j = e < 0 ? -e : 0; j < 4 && e + j < len; ++j)
        __stcs(g + e + j, st ? s[e + j] : 0.f);
    }
  }
}

// The inverse of store_runs: streaming float4 loads from src into st.
__device__ void load_runs(const float* src, float* st, int nrun, int len,
                          size_t gstride, int spitch) {
  const int nw = (len + 6) >> 2;
  for (Walk w(nw); w.outer < nrun; w.next()) {
    const float* g = src + w.outer * gstride;
    const int e = 4 * w.inner - misalign(g);
    if (e >= len) continue;
    float* s = st + w.outer * spitch;
    if (e >= 0 && e + 4 <= len) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(g + e));
      s[e] = v.x;
      s[e + 1] = v.y;
      s[e + 2] = v.z;
      s[e + 3] = v.w;
    } else {
      for (int j = e < 0 ? -e : 0; j < 4 && e + j < len; ++j)
        s[e + j] = __ldcs(g + e + j);
    }
  }
}

// The writes of a chunk (rows [r0, r0 + nr) of tile [a0, a0 + na)) within
// the (slot, plane) run o: one run when the stage rows follow each other as
// the group tensor's do, else one run per pixel.
__device__ __forceinline__ void chunk_runs(int k, int A, int na, int pitch,
                                           int nr, int* nrun, int* len) {
  if (na == A && pitch == A) {
    *nrun = 1;
    *len = nr * k * A;
  } else {
    *nrun = nr * k;
    *len = na;
  }
}

// base[al] = plane offset of the patch origin of SAI a0 + al in slot s.
__device__ void fill_base(const Geo& g, int s, int a0, int na,
                          long long* base) {
  const int nsel = 2 * g.nd + 1;
  const int sy = g.sim_y[s], sx = g.sim_x[s];
  for (int al = threadIdx.x; al < na; al += THREADS) {
    const int a = a0 + al;
    const int d = a == g.ref ? g.nd * nsel + g.nd
                  : g.doff   ? g.doff[static_cast<size_t>(s) * g.A + a]
                             : g.bidx[(static_cast<size_t>(a) * g.V0 + sy) *
                                          g.V1 + sx];
    const int dy = d / nsel;
    base[al] = (static_cast<long long>(a) * g.Hp + sy + dy - g.nd) * g.Wp +
               sx + (d - dy * nsel) - g.nd;
  }
}

// stage[pl * pitch + al] = plane[base[al] + (r0 + pl / K) * Wp + pl % K] for
// pixels pl of the chunk's nr rows: consecutive threads on consecutive
// pixels of one SAI (patch rows), BATCH loads in flight per thread.
template <int K>
__device__ __forceinline__ void gather(const float* __restrict__ pl0,
                                       const long long* base, float* stage,
                                       int na, int nr, int r0, int pitch,
                                       int Wp) {
  Walk w(nr * K);
  for (;;) {
    float v[BATCH];
    int at[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      at[u] = -1;
      if (w.outer < na) {
        const int r = r0 + w.inner / K, c = w.inner - (w.inner / K) * K;
        v[u] = __ldg(pl0 + base[w.outer] + static_cast<long long>(r) * Wp + c);
        at[u] = w.inner * pitch + w.outer;
      }
      w.next();
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (at[u] >= 0) stage[at[u]] = v[u];
    if (at[BATCH - 1] < 0) break;
  }
}

__device__ __forceinline__ void red1(float* p, float a) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(p), "f"(a));
}

template <int K>
__global__ void __launch_bounds__(THREADS)
extract_kernel(const float* __restrict__ planes, float* __restrict__ out,
               Geo g, Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* base = reinterpret_cast<long long*>(smem);
  float* stage = reinterpret_cast<float*>(smem + 8 * pl.tile + 4 * K * K);
  const int p = blockIdx.x / g.S, s = blockIdx.x - p * g.S;
  const int kkA = K * K * g.A;
  float* o = out + (static_cast<size_t>(p) * g.S + s) * kkA;
  if (!g.mask[s]) {
    store_runs(o, nullptr, 1, kkA, 0, 0);
    return;
  }
  const float* src = planes + static_cast<size_t>(p) * g.A * g.Hp * g.Wp;
  for (int a0 = 0; a0 < g.A; a0 += pl.tile) {
    const int na = min(pl.tile, g.A - a0);
    __syncthreads();  // the previous tile's base table is read
    fill_base(g, s, a0, na, base);
    for (int r0 = 0; r0 < K; r0 += pl.rows) {
      const int nr = min(pl.rows, K - r0);
      __syncthreads();  // base written; the previous chunk's stage written out
      gather<K>(src, base, stage, na, nr, r0, pl.pitch, g.Wp);
      __syncthreads();
      int nrun, len;
      chunk_runs(K, g.A, na, pl.pitch, nr, &nrun, &len);
      store_runs(o + static_cast<size_t>(r0) * K * g.A + a0, stage, nrun, len,
                 g.A, pl.pitch);
    }
  }
}

template <int K, bool kDen>
__global__ void __launch_bounds__(THREADS)
accumulate_kernel(const float* __restrict__ vals,
                  const float* __restrict__ wv,
                  const float* __restrict__ kaiser, float* __restrict__ num,
                  float* __restrict__ den, Geo g, Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* base = reinterpret_cast<long long*>(smem);
  float* kai = reinterpret_cast<float*>(smem + 8 * pl.tile);
  float* stage = kai + K * K;
  const int p = blockIdx.x / g.S, s = blockIdx.x - p * g.S;
  if (!g.mask[s]) return;
  const int kkA = K * K * g.A;
  const float* v = vals + (static_cast<size_t>(p) * g.S + s) * kkA;
  const size_t plane = static_cast<size_t>(g.A) * g.Hp * g.Wp;
  float* nump = num + p * plane;
  float* denp = kDen ? den + p * plane : nullptr;
  const float w = kDen ? wv[static_cast<size_t>(p) * g.S + s] : 0.f;
  if (kDen)
    for (int i = threadIdx.x; i < K * K; i += THREADS) kai[i] = w * kaiser[i];
  for (int a0 = 0; a0 < g.A; a0 += pl.tile) {
    const int na = min(pl.tile, g.A - a0);
    __syncthreads();  // the previous tile's base table is read
    fill_base(g, s, a0, na, base);
    for (int r0 = 0; r0 < K; r0 += pl.rows) {
      const int nr = min(pl.rows, K - r0);
      int nrun, len;
      chunk_runs(K, g.A, na, pl.pitch, nr, &nrun, &len);
      __syncthreads();  // the previous chunk's stage is read
      load_runs(v + static_cast<size_t>(r0) * K * g.A + a0, stage, nrun, len,
                g.A, pl.pitch);
      __syncthreads();
      // consecutive threads on consecutive pixels of one SAI: a warp's
      // reductions cover whole patch rows in the fewest sectors
      for (Walk it(nr * K); it.outer < na; it.next()) {
        const int pix = it.inner, al = it.outer;
        const int r = r0 + pix / K, c = pix - (pix / K) * K;
        const long long at = base[al] + static_cast<long long>(r) * g.Wp + c;
        red1(nump + at, stage[pix * pl.pitch + al]);
        if (kDen) red1(denp + at, kai[r0 * K + pix]);
      }
    }
  }
}

Geo make_geo(const void* bidx, const void* doff, const void* sim_y,
             const void* sim_x, const void* mask, int S, int P, int A, int Hp,
             int Wp, int V0, int V1, int nd, int ref) {
  Geo g;
  g.bidx = static_cast<const int*>(bidx);
  g.doff = static_cast<const int*>(doff);
  g.sim_y = static_cast<const int*>(sim_y);
  g.sim_x = static_cast<const int*>(sim_x);
  g.mask = static_cast<const uint8_t*>(mask);
  g.S = S;
  g.P = P;
  g.A = A;
  g.Hp = Hp;
  g.Wp = Wp;
  g.V0 = V0;
  g.V1 = V1;
  g.nd = nd;
  g.ref = ref;
  return g;
}

template <typename Kernel>
int prepare(Kernel kernel, const Plan& p) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem));
}

template <int K>
int launch_extract(const float* planes, float* out, const Geo& g,
                   cudaStream_t stream) {
  const Plan p = make_plan(K, g.A);
  if (const int e = prepare(extract_kernel<K>, p)) return e;
  extract_kernel<K><<<g.P * g.S, THREADS, p.smem, stream>>>(planes, out,
                                                                 g, p);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_accumulate(const float* vals, const float* wv, const float* kaiser,
                      float* num, float* den, const Geo& g,
                      cudaStream_t stream) {
  const Plan p = make_plan(K, g.A);
  const dim3 grid(g.P * g.S);
  if (den) {
    if (const int e = prepare(accumulate_kernel<K, true>, p)) return e;
    accumulate_kernel<K, true><<<grid, THREADS, p.smem, stream>>>(
        vals, wv, kaiser, num, den, g, p);
  } else {
    if (const int e = prepare(accumulate_kernel<K, false>, p)) return e;
    accumulate_kernel<K, false><<<grid, THREADS, p.smem, stream>>>(
        vals, wv, kaiser, num, nullptr, g, p);
  }
  return static_cast<int>(cudaGetLastError());
}

#define LFBM5D_TK_SWITCH(k, CALL)                                        \
  switch (k) {                                                           \
    case 1: return CALL(1); case 2: return CALL(2);                      \
    case 3: return CALL(3); case 4: return CALL(4);                      \
    case 5: return CALL(5); case 6: return CALL(6);                      \
    case 7: return CALL(7); case 8: return CALL(8);                      \
    case 9: return CALL(9); case 10: return CALL(10);                    \
    case 11: return CALL(11); case 12: return CALL(12);                  \
    case 13: return CALL(13); case 14: return CALL(14);                  \
    case 15: return CALL(15); case 16: return CALL(16);                  \
    default: return static_cast<int>(cudaErrorInvalidValue);             \
  }

}  // namespace

extern "C" {

// The launch plan of both kernels at (k, A): out[4] = patch rows per chunk,
// SAIs per tile, stage pitch (floats), dynamic shared bytes.
int lfbm5d_twokernel_plan(int k, int A, int* out) {
  if (k < 1 || k > 16 || A < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(k, A);
  out[0] = p.rows;
  out[1] = p.tile;
  out[2] = p.pitch;
  out[3] = p.smem;
  return 0;
}

// planes [P, A, Hp, Wp] f32; bidx [A, V0, V1]; doff [S, A] int32 or null
// (then displacements come from bidx); sim_y/sim_x [S] int32 and mask [S]
// uint8 (S = G*N slots); out [P, S, k*k, A] f32.
int lfbm5d_extract_groups(const void* planes, const void* bidx,
                          const void* doff, const void* sim_y,
                          const void* sim_x, const void* mask, void* out,
                          int S, int P, int A, int Hp, int Wp, int V0, int V1,
                          int k, int nd, int ref, void* stream) {
  const Geo g = make_geo(bidx, doff, sim_y, sim_x, mask, S, P, A, Hp, Wp, V0,
                         V1, nd, ref);
  const auto st = static_cast<cudaStream_t>(stream);
#define LFBM5D_EXTRACT(K)                                                  \
  launch_extract<K>(static_cast<const float*>(planes),                     \
                    static_cast<float*>(out), g, st)
  LFBM5D_TK_SWITCH(k, LFBM5D_EXTRACT)
#undef LFBM5D_EXTRACT
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
  const Geo g = make_geo(bidx, doff, sim_y, sim_x, mask, S, P, A, Hp, Wp, V0,
                         V1, nd, ref);
  const auto st = static_cast<cudaStream_t>(stream);
#define LFBM5D_ACCUMULATE(K)                                               \
  launch_accumulate<K>(static_cast<const float*>(vals),                    \
                       static_cast<const float*>(wv),                      \
                       static_cast<const float*>(kaiser),                  \
                       static_cast<float*>(num), static_cast<float*>(den), \
                       g, st)
  LFBM5D_TK_SWITCH(k, LFBM5D_ACCUMULATE)
#undef LFBM5D_ACCUMULATE
}

}  // extern "C"
