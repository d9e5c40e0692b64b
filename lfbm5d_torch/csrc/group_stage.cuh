// The group stage shared by csrc/fused.cu and csrc/fused_banked.cu: one
// group (reference patch t) at a time per thread-block cluster, its 64
// spatial frequencies split over the cluster's cs CTAs.
//
// The 5D transform is separable, and after the spatial 2D transform every
// coefficient (u, v) goes through the angular, stack and shrink steps on its
// own. So CTA `rank` of a cluster owns cpc = 64/cs consecutive coefficients
// cf = u*8 + v (cf / cpc == rank) for every slot and SAI of the group, in a
// slice of its own shared memory:
//
//   slice [region][lc][ps]   region 0 the noisy group, 1 (Wiener) the basic
//                            group; lc = cf % cpc; column n*ap + s*awp + t
//                            for slot n, SAI (s, t), with awp = aW|1,
//                            ap = aH*awp and ps = (N*ap)|1: odd strides keep
//                            every pass free of bank conflicts.
//
// Per (group, channel), with three cluster barriers:
//   scatter   each CTA gathers 1/cs of the group's patches (and keeps their
//             origins), 8 lanes a patch, lane j loading column j (each warp
//             load covers 4 patch rows of 8 floats); the spatial transform
//             runs in registers (column transform, an 8x8 shuffle
//             transpose, row transform: 1,024 multiply-adds a patch, as
//             before), and lane u stores coefficient row u into the slices
//             of its owners through distributed shared memory; the next
//             patch's loads are issued before this one is transformed.
//   local     angular s and t, the stack transform, the shrink and the
//             inverse stack, angular s and t, all on the CTA's own slice,
//             __syncthreads between passes. Each pass is instantiated per
//             length (angular 1..MAXG, stack 1..16), fully unrolled, with
//             its table read from constant memory as an operand.
//   weights   the HT count and the Wiener sum of omega^2 are summed over the
//             cluster from the CTAs' partials in rank order, so every CTA
//             gets the same weight in every run.
//   gather    lane u reads coefficient row u from the owners, inverts the
//             spatial transform in registers (row, transpose, column), and
//             adds est*w*kaiser to num and w to wden at the patch origin by
//             f32 atomics (each warp atomic covers 4 patch rows of 8), the
//             next patch's coefficients already in flight.
// The passes step their item indices instead of dividing, and the Wiener
// stack pass holds omega and the coefficients, never both groups, at once.
// Nothing of the group leaves the SMs. The launch plan (cs, threads, shared
// bytes) follows from N, aH, aW and Wiener alone (make_plan; Python copy in
// kernels/fused.py::group_plan).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int K = 8;
constexpr int KK = K * K;
constexpr int MAXN = 16;
constexpr int MAX_SIDE = 19;
constexpr int MAX_THREADS = 512;
constexpr int MAX_CLUSTER = 16;
constexpr int SMEM_PER_SM = 233472;     // 228 KB of shared memory per SM
constexpr int SMEM_PER_BLOCK = 232448;  // 227 KB a block may use
constexpr int SMEM_RESERVED = 1024;     // the system's share per block
constexpr int STATIC_SMEM = 256;        // bound on run_groups' static arrays
constexpr int STACK_FLOATS = 341;       // levels 1, 2, 4, 8, 16: sum of s^2

// Transform tables in constant memory (kernels/fused.py::kernel_tables):
// matrices row-major [out][in], angular ones [len][len] at the head of their
// slot, stack level s = 2^l at (s*s - 1)/3 as [s][s].
struct Tables {
  float f2[KK], i2[KK], kai[KK];
  float f4s[MAX_SIDE * MAX_SIDE], i4s[MAX_SIDE * MAX_SIDE];
  float f4t[MAX_SIDE * MAX_SIDE], i4t[MAX_SIDE * MAX_SIDE];
  float stf[STACK_FLOATS], sti[STACK_FLOATS];
};

__constant__ Tables ctab;

struct Args {
  const float* noisy;    // [C, A, Hp, Wp]
  const float* basic;    // [C, A, Hp, Wp] (Wiener) or null
  const int* bidx;       // [A, V0, V1]
  const int* doff;       // [T, N, A] per-slot displacements, or null: bidx
  const int* sim_y;      // [T, N]
  const int* sim_x;      // [T, N]
  const int* lvl;        // [T]
  const uint8_t* mask;   // [T, N]
  const float* sigma;    // [C]
  float* num;            // [C, A, Hp, Wp]
  float* wden;           // [C, A, Hp, Wp] deferred denominator weights
  int T, N, A, aH, aW, C, Hp, Wp, V0, V1, nd, ref, wiener;
  float lambda;
};

struct Plan {
  int cs, threads, smem;
};

__host__ __device__ inline int slice_stride(int n, int a_h, int a_w) {
  return (n * a_h * (a_w | 1)) | 1;
}

// Dynamic shared memory at cluster size cs: the slice and the origins of
// the CTA's share of the patches.
inline int plan_smem(int n, int a_h, int a_w, int wiener, int cs) {
  const int patches = (n * a_h * a_w + cs - 1) / cs;
  return 4 * ((wiener ? 2 : 1) * (KK / cs) * slice_stride(n, a_h, a_w) +
              2 * patches);
}

// The fewest CTAs whose slice fits two CTAs (256 threads each) on an SM,
// else one CTA of 512 threads: 16 warps per SM either way.
inline bool make_plan(int n, int a_h, int a_w, int wiener, Plan* out) {
  for (int per_sm = 2; per_sm >= 1; --per_sm) {
    int limit = SMEM_PER_SM / per_sm - SMEM_RESERVED;
    if (limit > SMEM_PER_BLOCK) limit = SMEM_PER_BLOCK;
    limit -= STATIC_SMEM;
    for (int cs = 1; cs <= MAX_CLUSTER; cs *= 2) {
      const int smem = plan_smem(n, a_h, a_w, wiener, cs);
      if (smem <= limit) {
        *out = Plan{cs, MAX_THREADS / per_sm, smem};
        return true;
      }
    }
  }
  return false;
}

// Sum over the block; every thread returns the same value (fixed order).
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

// 8x8 transpose over the 8 lanes of a patch: lane L's a[R] = M[R][L] on
// entry, M[L][R] on exit (three butterfly stages of 4 shuffles).
__device__ __forceinline__ void transpose8(float (&a)[K], int lane8) {
#pragma unroll
  for (int m = 1; m < K; m <<= 1) {
    const bool hi = lane8 & m;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if (r & m) continue;
      const float send = hi ? a[r] : a[r | m];
      const float recv = __shfl_xor_sync(0xffffffffu, send, m);
      if (hi) {
        a[r] = recv;
      } else {
        a[r | m] = recv;
      }
    }
  }
}

// Lane j: x = column j of the patch X -> row u = j of Z = F2 X F2^T.
__device__ __forceinline__ void spatial_fwd(float (&x)[K], int lane8) {
  float y[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) acc = fmaf(ctab.f2[u * K + i], x[i], acc);
    y[u] = acc;
  }
  transpose8(y, lane8);
#pragma unroll
  for (int v = 0; v < K; ++v) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) acc = fmaf(ctab.f2[v * K + j], y[j], acc);
    x[v] = acc;
  }
}

// Lane u: z = row u of Z -> column j = u of X = I2 Z I2^T.
__device__ __forceinline__ void spatial_inv(float (&z)[K], int lane8) {
  float r[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int v = 0; v < K; ++v) acc = fmaf(ctab.i2[j * K + v], z[v], acc);
    r[j] = acc;
  }
  transpose8(r, lane8);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < K; ++u) acc = fmaf(ctab.i2[i * K + u], r[u], acc);
    z[i] = acc;
  }
}

// Angular tables: 0 f4s, 1 i4s, 2 f4t, 3 i4t.
template <int WHICH>
__device__ __forceinline__ float ang_tab(int i) {
  if constexpr (WHICH == 0) return ctab.f4s[i];
  if constexpr (WHICH == 1) return ctab.i4s[i];
  if constexpr (WHICH == 2) return ctab.f4t[i];
  return ctab.i4t[i];
}

// LEN-point transform along one angular axis of `rows` rows of the slice,
// in place. Items (row, slot, o), o fastest; element l at
// row*ps + n*ap + o*os + l*es. ns = 2^lg_ns; each thread steps its item
// indices by blockDim without dividing.
template <int LEN, int WHICH>
__device__ void angular(float* S, int rows, int ps, int lg_ns, int ap,
                        int no, int os, int es) {
  const int items = (rows * no) << lg_ns;
  const int step_o = blockDim.x % no, step_r = blockDim.x / no;
  int o = threadIdx.x % no, rest = threadIdx.x / no;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    float* b = S + (rest >> lg_ns) * ps + (rest & ((1 << lg_ns) - 1)) * ap +
               o * os;
    float v[LEN];
#pragma unroll
    for (int l = 0; l < LEN; ++l) v[l] = b[l * es];
#pragma unroll
    for (int q = 0; q < LEN; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int l = 0; l < LEN; ++l)
        acc = fmaf(ang_tab<WHICH>(q * LEN + l), v[l], acc);
      b[q * es] = acc;
    }
    o += step_o;
    rest += step_r;
    if (o >= no) {
      o -= no;
      ++rest;
    }
  }
}

template <int WHICH, int MAXG, int L = 1>
__device__ __forceinline__ void angular_pass(int len, float* S, int rows,
                                             int ps, int lg_ns, int ap,
                                             int no, int os, int es) {
  if constexpr (L <= MAXG) {
    if (len == L) {
      angular<L, WHICH>(S, rows, ps, lg_ns, ap, no, os, es);
    } else {
      angular_pass<WHICH, MAXG, L + 1>(len, S, rows, ps, lg_ns, ap, no, os,
                                       es);
    }
  }
}

// Stack transform of NS live slots, shrink, inverse stack, on the noisy
// region (the basic region guides Wiener). Items (lc, s, t), t fastest,
// stepped by blockDim without dividing. Returns this thread's part of the
// HT count or of the Wiener sum of omega^2.
template <int NS, bool WIENER>
__device__ float stack_shrink(float* S, int cpc, int ps, int ap, int aH,
                              int aW, int awp, float sig2, float thr) {
  constexpr int LOFF = (NS * NS - 1) / 3;
  const int a = aH * aW, step = blockDim.x;
  const int st_t = step % aW, st_s = step / aW % aH, st_l = step / a;
  int t = threadIdx.x % aW, s = threadIdx.x / aW % aH;
  int lc = threadIdx.x / a;
  float part = 0.f;
  for (; lc < cpc;) {
    float* col = S + lc * ps + s * awp + t;
    t += st_t;
    s += st_s;
    lc += st_l;
    if (t >= aW) {
      t -= aW;
      ++s;
    }
    if (s >= aH) {
      s -= aH;
      ++lc;
    }
    float y[NS];  // Wiener: omega, then the shrunk coefficients
    if constexpr (WIENER) {
      float vb[NS];
#pragma unroll
      for (int n = 0; n < NS; ++n) vb[n] = col[cpc * ps + n * ap];
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        float b = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n)
          b = fmaf(ctab.stf[LOFF + q * NS + n], vb[n], b);
        const float b2 = b * b;
        y[q] = b2 / (b2 + sig2);
        part += y[q] * y[q];
      }
    }
    float v[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) v[n] = col[n * ap];
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        acc = fmaf(ctab.stf[LOFF + q * NS + n], v[n], acc);
      if constexpr (WIENER) {
        acc *= y[q];
      } else if (fabsf(acc) >= thr) {
        part += 1.f;
      } else {
        acc = 0.f;
      }
      y[q] = acc;
    }
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        acc = fmaf(ctab.sti[LOFF + q * NS + n], y[n], acc);
      col[q * ap] = acc;
    }
  }
  return part;
}

template <bool WIENER>
__device__ float stack_pass(int ns, float* S, int cpc, int ps, int ap, int aH,
                            int aW, int awp, float sig2, float thr) {
  switch (ns) {
    case 1: return stack_shrink<1, WIENER>(S, cpc, ps, ap, aH, aW, awp, sig2, thr);
    case 2: return stack_shrink<2, WIENER>(S, cpc, ps, ap, aH, aW, awp, sig2, thr);
    case 4: return stack_shrink<4, WIENER>(S, cpc, ps, ap, aH, aW, awp, sig2, thr);
    case 8: return stack_shrink<8, WIENER>(S, cpc, ps, ap, aH, aW, awp, sig2, thr);
    default: return stack_shrink<16, WIENER>(S, cpc, ps, ap, aH, aW, awp, sig2, thr);
  }
}

// The group stage of one reference SAI; sm: the dynamic shared memory
// (slice, then the origins of this CTA's patches).
template <int MAXG>
__device__ void run_groups(const Args& p, float* sm) {
  __shared__ float red[MAX_THREADS / 32];
  __shared__ uint8_t smask[MAXN];
  __shared__ int s_lvl;
  __shared__ float s_part, s_w;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cpc = KK / cs;
  const int awp = p.aW | 1, ap = p.aH * awp;
  const int ps = slice_stride(p.N, p.aH, p.aW);
  const int region = cpc * ps;
  int* oy = reinterpret_cast<int*>(sm + (p.wiener ? 2 : 1) * region);
  int* ox = oy + (p.N * p.A + cs - 1) / cs;

  // lane8 is this lane's column of a patch (gather, aggregation) and its
  // row u of coefficients (scatter, read back): cf = u*8 + v, owned by
  // CTA cf / cpc; a CTA owning half a row (cs = 16) splits it at v = 4.
  const int lane8 = threadIdx.x & 7;
  const int sub = threadIdx.x >> 3, per_round = blockDim.x >> 3;
  const int cf0 = lane8 * K;
  float* own0 = cluster.map_shared_rank(sm, cf0 / cpc);
  float* own1 = cluster.map_shared_rank(sm, (cf0 + K - 1) / cpc);
  float kcol[K];
#pragma unroll
  for (int i = 0; i < K; ++i) kcol[i] = ctab.kai[i * K + lane8];

  const int nsel = 2 * p.nd + 1;
  const int c_ang = p.nd * nsel + p.nd;
  const size_t plane = (size_t)p.A * p.Hp * p.Wp;
  const int clusters = gridDim.x / cs;

  for (int t = blockIdx.x / cs; t < p.T; t += clusters) {
    __syncthreads();  // the previous group is done with smask/s_lvl/origins
    if (threadIdx.x < p.N) smask[threadIdx.x] = p.mask[t * p.N + threadIdx.x];
    if (threadIdx.x == 0) s_lvl = p.lvl[t];
    __syncthreads();
    bool live = false;
    for (int n = 0; n < p.N; ++n) live |= smask[n] != 0;
    if (!live) continue;  // the same for every CTA of the cluster
    const int ns = 1 << s_lvl;
    const int np = ns * p.A;
    const int p0 = rank * ((np + cs - 1) / cs);
    const int nloc = max(0, min((np + cs - 1) / cs, np - p0));
    const int rounds = (nloc + per_round - 1) / per_round;

    for (int i = threadIdx.x; i < nloc; i += blockDim.x) {
      const int n = (p0 + i) / p.A, a = (p0 + i) % p.A;
      const int sy = p.sim_y[t * p.N + n], sx = p.sim_x[t * p.N + n];
      const int d = a == p.ref ? c_ang
                    : p.doff ? p.doff[((size_t)t * p.N + n) * p.A + a]
                             : p.bidx[((size_t)a * p.V0 + sy) * p.V1 + sx];
      oy[i] = sy + d / nsel - p.nd;
      ox[i] = sx + d % nsel - p.nd;
    }
    __syncthreads();

    for (int c = 0; c < p.C; ++c) {
      const float sig = p.sigma[c];
      const float sig2 = sig * sig;
      cluster.sync();  // every CTA is done reading the slices (last channel)
      // steps (round, region), basic first; the next step's loads are in
      // flight while this one is transformed and stored
      const int steps = rounds << p.wiener;
      auto load = [&](int st, float (&x)[K]) {
        const int i = (st >> p.wiener) * per_round + sub;
        const int g = p.wiener - (st & p.wiener);
        if (st < steps && i < nloc) {
          const int a = (p0 + i) % p.A;
          const float* src = (g ? p.basic : p.noisy) + c * plane +
                             ((size_t)a * p.Hp + oy[i]) * p.Wp + ox[i] + lane8;
#pragma unroll
          for (int r = 0; r < K; ++r) x[r] = __ldg(src + r * p.Wp);
        } else {
#pragma unroll
          for (int r = 0; r < K; ++r) x[r] = 0.f;
        }
      };
      float x[K];
      load(0, x);
      for (int st = 0; st < steps; ++st) {
        float nx[K];
        load(st + 1, nx);
        const int i = (st >> p.wiener) * per_round + sub;
        const int g = p.wiener - (st & p.wiener);
        spatial_fwd(x, lane8);
        if (i < nloc) {
          const int n = (p0 + i) / p.A, a = (p0 + i) % p.A;
          const int colx = n * ap + (a / p.aW) * awp + a % p.aW;
#pragma unroll
          for (int v = 0; v < K; ++v)
            (v < K / 2 ? own0 : own1)[g * region + (cf0 + v) % cpc * ps +
                                      colx] = x[v];
        }
#pragma unroll
        for (int r = 0; r < K; ++r) x[r] = nx[r];
      }
      cluster.sync();  // the slices are complete

      const int rows = (p.wiener ? 2 : 1) * cpc;
      angular_pass<0, MAXG>(p.aH, sm, rows, ps, s_lvl, ap, p.aW, 1, awp);
      __syncthreads();
      angular_pass<2, MAXG>(p.aW, sm, rows, ps, s_lvl, ap, p.aH, awp, 1);
      __syncthreads();
      const float part =
          p.wiener ? stack_pass<true>(ns, sm, cpc, ps, ap, p.aH, p.aW, awp,
                                      sig2, 0.f)
                   : stack_pass<false>(ns, sm, cpc, ps, ap, p.aH, p.aW, awp,
                                       sig2, p.lambda * sig);
      const float tot = block_sum(part, red);  // orders the stack pass too
      if (threadIdx.x == 0) s_part = tot;
      angular_pass<1, MAXG>(p.aH, sm, cpc, ps, s_lvl, ap, p.aW, 1, awp);
      __syncthreads();
      angular_pass<3, MAXG>(p.aW, sm, cpc, ps, s_lvl, ap, p.aH, awp, 1);
      cluster.sync();  // inverse slices and partials are complete

      if (threadIdx.x == 0) {
        float s = 0.f;  // rank order: the same weight in every CTA and run
        for (int r = 0; r < cs; ++r) s += *cluster.map_shared_rank(&s_part, r);
        s_w = p.wiener ? (s > 0.f ? 1.f / (sig2 * fmaxf(s, 1e-30f)) : 1.f)
                       : (s > 0.f ? 1.f / (sig2 * fmaxf(s, 1.f)) : 1.f);
      }
      __syncthreads();
      const float w = s_w;
      float* num = p.num + c * plane;
      float* wden = p.wden + c * plane;
      // one round ahead, as the scatter
      auto fetch = [&](int rd, float (&z)[K]) {
        const int i = rd * per_round + sub;
        if (rd < rounds && i < nloc) {
          const int n = (p0 + i) / p.A, a = (p0 + i) % p.A;
          const int colx = n * ap + (a / p.aW) * awp + a % p.aW;
#pragma unroll
          for (int v = 0; v < K; ++v)
            z[v] = (v < K / 2 ? own0 : own1)[(cf0 + v) % cpc * ps + colx];
        } else {
#pragma unroll
          for (int v = 0; v < K; ++v) z[v] = 0.f;
        }
      };
      float z[K];
      fetch(0, z);
      for (int rd = 0; rd < rounds; ++rd) {
        float nz[K];
        fetch(rd + 1, nz);
        const int i = rd * per_round + sub;
        spatial_inv(z, lane8);
        const int n = (p0 + i) / p.A;
        if (i < nloc && smask[n]) {
          const int a = (p0 + i) % p.A;
          const size_t o = ((size_t)a * p.Hp + oy[i]) * p.Wp + ox[i];
#pragma unroll
          for (int r = 0; r < K; ++r)
            atomicAdd(num + o + r * p.Wp + lane8, z[r] * (w * kcol[r]));
          if (lane8 == 0) atomicAdd(wden + o, w);
        }
#pragma unroll
        for (int v = 0; v < K; ++v) z[v] = nz[v];
      }
    }
  }
  cluster.sync();  // no CTA leaves while another may read its slice
}

// Fills the Args shared by both launchers.
inline Args make_args(const void* noisy, const void* basic, const void* bidx,
                      const void* doff, const void* sim_y, const void* sim_x,
                      const void* lvl, const void* mask, const void* sigma,
                      void* num, void* wden, int T, int N, int A, int aH,
                      int aW, int C, int Hp, int Wp, int V0, int V1, int nd,
                      int ref, int wiener, float lambda) {
  Args p;
  p.noisy = static_cast<const float*>(noisy);
  p.basic = static_cast<const float*>(basic);
  p.bidx = static_cast<const int*>(bidx);
  p.doff = static_cast<const int*>(doff);
  p.sim_y = static_cast<const int*>(sim_y);
  p.sim_x = static_cast<const int*>(sim_x);
  p.lvl = static_cast<const int*>(lvl);
  p.mask = static_cast<const uint8_t*>(mask);
  p.sigma = static_cast<const float*>(sigma);
  p.num = static_cast<float*>(num);
  p.wden = static_cast<float*>(wden);
  p.T = T;
  p.N = N;
  p.A = A;
  p.aH = aH;
  p.aW = aW;
  p.C = C;
  p.Hp = Hp;
  p.Wp = Wp;
  p.V0 = V0;
  p.V1 = V1;
  p.nd = nd;
  p.ref = ref;
  p.wiener = wiener;
  p.lambda = lambda;
  return p;
}

// Sets the kernel's attributes for this plan; the launch config (grid
// still one cluster) for it.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, const Plan& plan, cudaStream_t stream,
                    cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = plan.cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(plan.cs);
  cfg->blockDim = dim3(plan.threads);
  cfg->dynamicSmemBytes = plan.smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// out: cs, threads, shared bytes, max active clusters, CTAs per SM.
template <typename Kernel>
int occupancy(Kernel kernel, int N, int aH, int aW, int wiener, int* out) {
  Plan plan;
  if (!make_plan(N, aH, aW, wiener, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = prepare(kernel, plan, nullptr, &attr, &cfg);
  int clusters = 0, blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, plan.threads, plan.smem);
  out[0] = plan.cs;
  out[1] = plan.threads;
  out[2] = plan.smem;
  out[3] = clusters;
  out[4] = blocks;
  return static_cast<int>(err);
}

// Copies the tables to constant memory and launches as many clusters as fit
// on the card at once (at most one per group); they stride over the groups.
// A plan that cannot launch a single cluster raises (no fallback).
template <typename Kernel>
int launch_groups(Kernel kernel, const Args& p, const void* tables,
                  cudaStream_t stream) {
  Plan plan;
  if (!make_plan(p.N, p.aH, p.aW, p.wiener, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = prepare(kernel, plan, stream, &attr, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidClusterSize);
  err = cudaMemcpyToSymbolAsync(ctab, tables, sizeof(Tables), 0,
                                cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3((p.T < clusters ? p.T : clusters) * plan.cs);
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
