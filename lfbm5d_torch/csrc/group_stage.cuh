// The group stage shared by csrc/fused.cu (group in shared memory) and
// csrc/fused_banked.cu (group in a per-block device-memory workspace).
//
// run_groups<MAXG> walks the groups of one reference SAI (persistent blocks
// striding over T) and, per (group, channel), runs extract -> spatial ->
// angular along s then t -> stack -> shrink -> inverse -> aggregate on the
// group buffer B, laid out [pixel][slot*A + SAI] with column stride ps. B
// may lie in shared or in device memory: every pass is separated by
// __syncthreads, which orders both for the block. The pass design and the
// deferred denominator are described in csrc/fused.cu.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int K = 8;
constexpr int KK = K * K;
constexpr int MAXN = 16;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

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
  const float* mats;     // packed transform tables, see matrix offsets below
  float* num;            // [C, A, Hp, Wp]
  float* wden;           // [C, A, Hp, Wp] deferred denominator weights
  float* work;           // [gridDim.x, k^2 * N * A] (Wiener)
  float* group;          // [gridDim.x, k^2 * N * A] group workspace or null
  int T, N, A, aH, aW, C, Hp, Wp, V0, V1, nd, ref, wiener, levels;
  float lambda;
};

// Floats of the packed transform tables (kernels/fused.py::GroupTables):
// f2 i2 f4s i4s f4t i4t stack_f stack_i kaiser.
__host__ __device__ inline int table_floats(int n, int levels, int a_h,
                                            int a_w) {
  return 3 * KK + 2 * (a_h * a_h + a_w * a_w) + 2 * levels * n * n;
}

inline int stack_levels(int n) { return 32 - __builtin_clz(n); }

// Sum over the block; every thread returns the same value (fixed order).
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) s += red[i];
  return s;
}

// Z = F X F^T for the patch in column `col` of B (pixel p = i*K + j).
__device__ __forceinline__ void spatial(float* B, int ps, int col,
                                        const float* F) {
  float y[KK];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float x[K];
#pragma unroll
    for (int i = 0; i < K; ++i) x[i] = B[(i * K + j) * ps + col];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) acc = fmaf(F[u * K + i], x[i], acc);
      y[u * K + j] = acc;
    }
  }
#pragma unroll
  for (int u = 0; u < K; ++u) {
#pragma unroll
    for (int v = 0; v < K; ++v) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) acc = fmaf(F[v * K + j], y[u * K + j], acc);
      B[(u * K + v) * ps + col] = acc;
    }
  }
}

__device__ void spatial_pass(float* B, int ps, int npatch, const float* F) {
  for (int col = threadIdx.x; col < npatch; col += THREADS)
    spatial(B, ps, col, F);
}

// 1D transform F [len x len] along one angular axis, in place. Items are
// (pixel, slot, o); element l of an item sits at column n*A + o*os + l*es.
// len <= MAXG: the item's values stay in registers.
template <int MAXG>
__device__ void angular_pass(float* B, int ps, int ns, int A, int len, int es,
                             int no, int os, const float* F) {
  const int items = KK * ns * no;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int o = it % no, rest = it / no;
    float* base = B + (rest / ns) * ps + (rest % ns) * A + o * os;
    float v[MAXG];
#pragma unroll
    for (int l = 0; l < MAXG; ++l) v[l] = l < len ? base[l * es] : 0.f;
    for (int q = 0; q < len; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int l = 0; l < MAXG; ++l)
        if (l < len) acc = fmaf(F[q * len + l], v[l], acc);
      base[q * es] = acc;
    }
  }
}

__device__ void gather_group(float* B, int ps, const float* src, int npatch,
                             const int* oy, const int* ox, const Args& p) {
  for (int it = threadIdx.x; it < npatch * KK; it += THREADS) {
    const int pix = it % KK, col = it / KK;
    const int a = col % p.A;
    B[pix * ps + col] =
        src[((size_t)a * p.Hp + oy[col] + pix / K) * p.Wp + ox[col] + pix % K];
  }
}

// The group stage of one reference SAI. B: this block's group buffer
// [KK][ps]; M: the transform tables in shared memory; oy/ox: shared [N*A].
template <int MAXG>
__device__ void run_groups(const Args& p, float* B, int ps, float* M,
                           int* oy, int* ox) {
  __shared__ float red[WARPS];
  __shared__ uint8_t smask[MAXN];
  __shared__ int s_lvl;

  const int NA = p.N * p.A;
  const int nn = p.N * p.N;
  const int msize = table_floats(p.N, p.levels, p.aH, p.aW);
  const float* f2 = M;
  const float* i2 = f2 + KK;
  const float* f4s = i2 + KK;
  const float* i4s = f4s + p.aH * p.aH;
  const float* f4t = i4s + p.aH * p.aH;
  const float* i4t = f4t + p.aW * p.aW;
  const float* stf = i4t + p.aW * p.aW;
  const float* sti = stf + p.levels * nn;
  const float* kai = sti + p.levels * nn;

  for (int i = threadIdx.x; i < msize; i += THREADS) M[i] = p.mats[i];
  float* work = p.work + (size_t)blockIdx.x * KK * NA;
  const int nsel = 2 * p.nd + 1;
  const int c_ang = p.nd * nsel + p.nd;
  const size_t plane = (size_t)p.A * p.Hp * p.Wp;

  for (int t = blockIdx.x; t < p.T; t += gridDim.x) {
    __syncthreads();  // the previous group is done with smask/s_lvl/B
    if (threadIdx.x < p.N) smask[threadIdx.x] = p.mask[t * p.N + threadIdx.x];
    if (threadIdx.x == 0) s_lvl = p.lvl[t];
    __syncthreads();
    bool live = false;
    for (int n = 0; n < p.N; ++n) live |= smask[n] != 0;
    if (!live) continue;
    const int ns = 1 << s_lvl;
    const int np = ns * p.A;
    const float* S = stf + s_lvl * nn;
    const float* Si = sti + s_lvl * nn;

    for (int it = threadIdx.x; it < np; it += THREADS) {
      const int n = it / p.A, a = it % p.A;
      const int sy = p.sim_y[t * p.N + n], sx = p.sim_x[t * p.N + n];
      const int d = a == p.ref ? c_ang
                    : p.doff ? p.doff[((size_t)t * p.N + n) * p.A + a]
                             : p.bidx[((size_t)a * p.V0 + sy) * p.V1 + sx];
      oy[it] = sy + d / nsel - p.nd;
      ox[it] = sx + d % nsel - p.nd;
    }
    __syncthreads();

    for (int c = 0; c < p.C; ++c) {
      const float sig = p.sigma[c];
      const float sig2 = sig * sig;
      float w = 1.f;
      __syncthreads();  // the previous channel's aggregation is done with B
      if (p.wiener) {
        gather_group(B, ps, p.basic + c * plane, np, oy, ox, p);
        __syncthreads();
        spatial_pass(B, ps, np, f2);
        __syncthreads();
        angular_pass<MAXG>(B, ps, ns, p.A, p.aH, p.aW, p.aW, 1, f4s);
        __syncthreads();
        angular_pass<MAXG>(B, ps, ns, p.A, p.aW, 1, p.aH, p.aW, f4t);
        __syncthreads();
        float part = 0.f;
        for (int it = threadIdx.x; it < p.A * KK; it += THREADS) {
          const int a = it % p.A, pix = it / p.A;
          const float* col = B + pix * ps + a;
          float v[MAXN];
#pragma unroll
          for (int n = 0; n < MAXN; ++n) v[n] = n < ns ? col[n * p.A] : 0.f;
          for (int q = 0; q < ns; ++q) {
            float y = 0.f;
#pragma unroll
            for (int n = 0; n < MAXN; ++n)
              if (n < ns) y = fmaf(S[q * p.N + n], v[n], y);
            const float b2 = y * y;
            const float om = b2 / (b2 + sig2);
            work[(size_t)(pix * p.N + q) * p.A + a] = om;
            part += om * om;
          }
        }
        const float wsum = block_sum(part, red);
        w = wsum > 0.f ? 1.f / (sig2 * fmaxf(wsum, 1e-30f)) : 1.f;
      }
      gather_group(B, ps, p.noisy + c * plane, np, oy, ox, p);
      __syncthreads();
      spatial_pass(B, ps, np, f2);
      __syncthreads();
      angular_pass<MAXG>(B, ps, ns, p.A, p.aH, p.aW, p.aW, 1, f4s);
      __syncthreads();
      angular_pass<MAXG>(B, ps, ns, p.A, p.aW, 1, p.aH, p.aW, f4t);
      __syncthreads();
      const float thr = p.lambda * sig;
      float nnz = 0.f;
      for (int it = threadIdx.x; it < p.A * KK; it += THREADS) {
        const int a = it % p.A, pix = it / p.A;
        float* col = B + pix * ps + a;
        float v[MAXN];
#pragma unroll
        for (int n = 0; n < MAXN; ++n) v[n] = n < ns ? col[n * p.A] : 0.f;
        for (int q = 0; q < ns; ++q) {
          float y = 0.f;
#pragma unroll
          for (int n = 0; n < MAXN; ++n)
            if (n < ns) y = fmaf(S[q * p.N + n], v[n], y);
          if (p.wiener) {
            y *= work[(size_t)(pix * p.N + q) * p.A + a];
          } else if (fabsf(y) >= thr) {
            nnz += 1.f;
          } else {
            y = 0.f;
          }
          col[q * p.A] = y;
        }
#pragma unroll
        for (int n = 0; n < MAXN; ++n) v[n] = n < ns ? col[n * p.A] : 0.f;
        for (int q = 0; q < ns; ++q) {
          float x = 0.f;
#pragma unroll
          for (int n = 0; n < MAXN; ++n)
            if (n < ns) x = fmaf(Si[q * p.N + n], v[n], x);
          col[q * p.A] = x;
        }
      }
      if (!p.wiener) {
        const float cnt = block_sum(nnz, red);  // exact: counts < 2^24
        w = cnt > 0.f ? 1.f / (sig2 * fmaxf(cnt, 1.f)) : 1.f;
      }
      __syncthreads();
      angular_pass<MAXG>(B, ps, ns, p.A, p.aH, p.aW, p.aW, 1, i4s);
      __syncthreads();
      angular_pass<MAXG>(B, ps, ns, p.A, p.aW, 1, p.aH, p.aW, i4t);
      __syncthreads();
      spatial_pass(B, ps, np, i2);
      __syncthreads();

      float* num = p.num + c * plane;
      float* wden = p.wden + c * plane;
      for (int it = threadIdx.x; it < np * KK; it += THREADS) {
        const int pix = it % KK, col = it / KK;
        if (!smask[col / p.A]) continue;
        const int a = col % p.A;
        atomicAdd(num + ((size_t)a * p.Hp + oy[col] + pix / K) * p.Wp +
                      ox[col] + pix % K,
                  B[pix * ps + col] * (w * kai[pix]));
      }
      for (int col = threadIdx.x; col < np; col += THREADS) {
        if (!smask[col / p.A]) continue;
        const int a = col % p.A;
        atomicAdd(wden + ((size_t)a * p.Hp + oy[col]) * p.Wp + ox[col], w);
      }
    }
  }
}

// Fills the Args shared by both launchers.
inline Args make_args(const void* noisy, const void* basic, const void* bidx,
                      const void* doff, const void* sim_y, const void* sim_x,
                      const void* lvl, const void* mask, const void* sigma,
                      const void* mats, void* num, void* wden, void* work,
                      void* group, int T, int N, int A, int aH, int aW, int C,
                      int Hp, int Wp, int V0, int V1, int nd, int ref,
                      int wiener, float lambda) {
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
  p.mats = static_cast<const float*>(mats);
  p.num = static_cast<float*>(num);
  p.wden = static_cast<float*>(wden);
  p.work = static_cast<float*>(work);
  p.group = static_cast<float*>(group);
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
  p.levels = stack_levels(N);
  p.lambda = lambda;
  return p;
}

}  // namespace
