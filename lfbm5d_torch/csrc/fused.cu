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
// 16 x 16, k is 8.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int K = 8;
constexpr int KK = K * K;
constexpr int MAXN = 16;
constexpr int MAXG = 16;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

struct Args {
  const float* noisy;    // [C, A, Hp, Wp]
  const float* basic;    // [C, A, Hp, Wp] (Wiener) or null
  const int* bidx;       // [A, V0, V1]
  const int* sim_y;      // [T, N]
  const int* sim_x;      // [T, N]
  const int* lvl;        // [T]
  const uint8_t* mask;   // [T, N]
  const float* sigma;    // [C]
  const float* mats;     // packed transform tables, see matrix offsets below
  float* num;            // [C, A, Hp, Wp]
  float* wden;           // [C, A, Hp, Wp] deferred denominator weights
  float* work;           // [gridDim.x, k^2 * N * A] (Wiener)
  int T, N, A, aH, aW, C, Hp, Wp, V0, V1, nd, ref, wiener, levels;
  float lambda;
};

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

__global__ void __launch_bounds__(THREADS, 1) group_kernel(Args p) {
  extern __shared__ float sm[];
  __shared__ float red[WARPS];
  __shared__ uint8_t smask[MAXN];
  __shared__ int s_lvl;

  const int NA = p.N * p.A;
  const int ps = NA | 1;
  const int nn = p.N * p.N;
  const int msize = 3 * KK + 2 * (p.aH * p.aH + p.aW * p.aW) +
                    2 * p.levels * nn;
  float* B = sm;                    // [KK][ps]
  float* M = B + KK * ps;           // transform tables
  int* oy = (int*)(M + msize);      // [N*A] patch origins
  int* ox = oy + NA;
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
        angular_pass(B, ps, ns, p.A, p.aH, p.aW, p.aW, 1, f4s);
        __syncthreads();
        angular_pass(B, ps, ns, p.A, p.aW, 1, p.aH, p.aW, f4t);
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
      angular_pass(B, ps, ns, p.A, p.aH, p.aW, p.aW, 1, f4s);
      __syncthreads();
      angular_pass(B, ps, ns, p.A, p.aW, 1, p.aH, p.aW, f4t);
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
      angular_pass(B, ps, ns, p.A, p.aH, p.aW, p.aW, 1, i4s);
      __syncthreads();
      angular_pass(B, ps, ns, p.A, p.aW, 1, p.aH, p.aW, i4t);
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

}  // namespace

extern "C" {

// Dynamic shared memory the group kernel needs, in bytes.
int lfbm5d_group_smem_bytes(int n, int a, int a_h, int a_w) {
  const int levels = 32 - __builtin_clz(n);
  const int msize = 3 * KK + 2 * (a_h * a_h + a_w * a_w) + 2 * levels * n * n;
  return static_cast<int>(sizeof(float) *
                          (KK * ((n * a) | 1) + msize + 2 * n * a));
}

int lfbm5d_group_step(const void* noisy, const void* basic, const void* bidx,
                      const void* sim_y, const void* sim_x, const void* lvl,
                      const void* mask, const void* sigma, const void* mats,
                      void* num, void* wden, void* work, int T, int N, int A,
                      int aH, int aW, int C, int Hp, int Wp, int V0, int V1,
                      int nd, int ref, int wiener, float lambda, int grid,
                      void* stream) {
  if (N > MAXN || aH > MAXG || aW > MAXG || aH * aW != A)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = lfbm5d_group_smem_bytes(N, A, aH, aW);
  cudaError_t err = cudaFuncSetAttribute(
      group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args p;
  p.noisy = static_cast<const float*>(noisy);
  p.basic = static_cast<const float*>(basic);
  p.bidx = static_cast<const int*>(bidx);
  p.sim_y = static_cast<const int*>(sim_y);
  p.sim_x = static_cast<const int*>(sim_x);
  p.lvl = static_cast<const int*>(lvl);
  p.mask = static_cast<const uint8_t*>(mask);
  p.sigma = static_cast<const float*>(sigma);
  p.mats = static_cast<const float*>(mats);
  p.num = static_cast<float*>(num);
  p.wden = static_cast<float*>(wden);
  p.work = static_cast<float*>(work);
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
  p.levels = 32 - __builtin_clz(N);
  p.lambda = lambda;
  group_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
