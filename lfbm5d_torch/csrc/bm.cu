// Block-matching kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// lfbm5d_cross_argmin replaces lfbm5d_tpu/kernels/bm.py:223
//   (cross_argmin_all_kernel; TPU: a VMEM-resident displacement loop with
//   doubling-tree box sums). For every patch position of the reference plane
//   and every SAI plane, the first-occurrence argmin over (2nd+1)^2
//   displacements of the quantized k x k SSD. Work per output and
//   displacement is one squared difference, k-1 vertical and k-1 horizontal
//   adds, the quantization and a compare: about 17 fp32 operations for 4
//   bytes of output per reference and SAI, so on this card it is bound by
//   instruction issue (the adds may not be fused), not by HBM.
//   Design: a block owns a TY x (VC-k+1) output tile and walks a chunk of the
//   SAIs (bm_plan: the chunk fills two waves of three blocks per SM). The
//   reference tile is read once per block into registers: each thread of
//   the vertical pass holds a column strip of RV+k-1 values. The SAI tiles
//   (tile + k-1 + 2nd halo) are double-buffered in shared memory by cp.async
//   with zero fill outside the plane, so SAI s+1 loads while s is matched.
//   Per displacement each thread squares its strip's differences and forms
//   RV vertical k-tap sums in registers, writes them to shared memory once,
//   and after one barrier forms WH horizontal k-tap sums of its row segment
//   from float4 loads, quantizes them and keeps best and bidx in registers.
//   For a fixed dx up to DYB values of dy (all 2nd+1 for nd <= 2) reuse one
//   column load of RV+k-1+DYB-1 SAI values; the dy loop is unrolled over
//   those DYB only (unrolled over every dy of nd <= 8 the body was 19%
//   slower). Shared-memory pitches are compile-time, so every load takes an
//   immediate offset, and three blocks fit an SM (80 registers). The argmin
//   map goes out through a per-warp staging copy, as contiguous row runs.
//   Ties: dx is visited outer and dy inner, so a tie is broken on the
//   displacement index, which keeps the row-major first occurrence.
//
// lfbm5d_self_distances replaces lfbm5d_tpu/kernels/bm.py:134
//   (self_distances_kernel; TPU: banded 0/1 selection matmuls on the MXU).
//   The quantized SSDs of every reference patch against its (2n+1)^2 search
//   window: 3 k^2 fp32 operations per distance (4345 * 1089 * 192 = 0.9 G at
//   the matched flagship) against 4 bytes written, so bound by instruction
//   issue and, in the old design, by two shared-memory loads per term.
//   Design: one block per reference patch; the (k+2n)-square window goes to
//   shared memory (odd pitch, zero outside the plane), the k x k reference
//   patch to registers (k <= 8; read from the window for larger k). Each
//   thread owns a run of SELF_R adjacent dx at one dy: it walks the
//   k+SELF_R-1 window columns, loads each column of k values once and adds
//   it into every box of the run it belongs to, so a distance costs about
//   k(k+SELF_R-1)/SELF_R shared loads instead of 2k^2. A block takes the
//   (2n+1) x ceil((2n+1)/SELF_R) items of its patch in rounds, each but the
//   last full: few rounds (more threads) where the grid is small, up to
//   one round per SELF_MIN_THREADS where it fills the card (make_self_plan).
//
// Both kernels use exact fp32 arithmetic in the plain twins' order
// (lfbm5d_torch/ops/distances.py): squared difference (__fsub_rn,
// __fmul_rn), vertical taps first, each k-tap sum sequential (__fadd_rn: no
// FMA contraction, no sliding-window subtraction, no tree), values outside
// the plane zero; distances are rounded half to even (__float2int_rn) after
// the k^2 normalisation, and the argmin keeps the first occurrence in
// row-major displacement order. So each kernel agrees with its
// plain twin bit for bit. k is a template parameter (1..16); n and nd stay
// loop bounds, and no loop over elements divides by a runtime value.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstddef>

namespace {

constexpr int NUM_SMS = 132;            // H100 SXM: the plan's wave size
constexpr int CROSS_BLOCKS_PER_SM = 3;  // __launch_bounds__ below
constexpr int CROSS_THREADS = 256;
constexpr int TY = 32;     // output rows of a cross-argmin tile
constexpr int VC = 64;     // vertical-sum columns of a tile (TX = VC-k+1)
constexpr int RV = 8;      // rows of a vertical strip (VC x TY/RV threads)
constexpr int WH = 8;      // columns of a horizontal segment (TY x VC/WH)
constexpr int ND_MAX = 8;  // largest nd the cross-argmin kernel takes
constexpr int SWP = VC + 2 * ND_MAX;  // row pitch of the SAI tiles
constexpr int DYB = 5;     // dy per column load (all of nd <= 2)
constexpr int SELF_R = 8;  // adjacent dx per self-BM thread
constexpr int SELF_MAX_THREADS = 256;
constexpr int SELF_MIN_THREADS = 64;
constexpr int SELF_THREADS_PER_SM = 1024;  // resident threads the plan aims at

static_assert(VC * (TY / RV) == CROSS_THREADS, "vertical pass layout");
static_assert(TY * (VC / WH) == CROSS_THREADS, "horizontal pass layout");

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

struct CrossPlan {
  int tx, tiles_x, tiles, chunk, grid;
  size_t smem;
};

// Row pitch of the vertical sums: room for the last segment's float4 loads,
// a multiple of 4 floats with an odd number of float4s, so the 8 lanes of a
// quarter-warp (two rows, four segments) hit distinct 16-byte bank groups.
__host__ __device__ constexpr int sv_need(int k) {
  return (VC - WH) + 4 * cdiv(WH + k - 1, 4);
}
__host__ __device__ constexpr int sv_pitch(int k) {
  return sv_need(k) / 4 % 2 ? sv_need(k) : sv_need(k) + 4;
}

// Launch plan of the cross-argmin kernel (kernels/bm.py::bm_plan is its
// copy). The chunk minimises waves * (2 chunk + 1) -- a block's SAIs plus
// half an SAI of set-up -- among the chunks whose grid fills at least two
// waves of CROSS_BLOCKS_PER_SM blocks on each of NUM_SMS SMs (any chunk when
// none does); ties keep the larger chunk.
CrossPlan make_cross_plan(int hp, int wp, int a, int k, int nd) {
  CrossPlan p{};
  const int v0 = hp - k + 1, v1 = wp - k + 1;
  p.tx = VC - k + 1;
  p.tiles_x = cdiv(v1, p.tx);
  p.tiles = cdiv(v0, TY) * p.tiles_x;
  const int slots = NUM_SMS * CROSS_BLOCKS_PER_SM;
  long long best_cost = 0;
  bool best_fills = false;
  for (int chunk = a; chunk >= 1; --chunk) {
    const int nch = cdiv(a, chunk);
    if (cdiv(a, nch) != chunk) continue;  // the same split as a larger chunk
    const int grid = p.tiles * nch;
    const bool fills = grid >= 2 * slots;
    const long long cost =
        static_cast<long long>(cdiv(grid, slots)) * (2 * chunk + 1);
    if (p.chunk == 0 || (fills && !best_fills) ||
        (fills == best_fills && cost < best_cost)) {
      p.chunk = chunk;
      p.grid = grid;
      best_cost = cost;
      best_fills = fills;
    }
  }
  const int sh = TY + k - 1 + 2 * nd;
  p.smem = sizeof(float) * (2 * TY * sv_pitch(k) + 2 * sh * SWP);
  return p;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

template <int K>
__global__ void __launch_bounds__(CROSS_THREADS, CROSS_BLOCKS_PER_SM)
cross_argmin_kernel(const float* __restrict__ ref,
                    const float* __restrict__ planes, int* __restrict__ out,
                    int a, int hp, int wp, int nd, int tiles_x, int tiles,
                    int chunk, float scale) {
  constexpr int TX = VC - K + 1;
  constexpr int NR = RV + K - 1;             // strip rows of the vertical pass
  constexpr int NCOL = NR + DYB - 1;         // column registers (DYB dy)
  constexpr int NH = 4 * ((WH + K + 2) / 4);  // sums a segment loads
  constexpr int PITCH = sv_pitch(K);
  extern __shared__ __align__(16) float sm[];
  float* sv = sm;                    // [2][TY][PITCH] vertical sums
  float* sai = sm + 2 * TY * PITCH;  // [2][sh][SWP] SAI tiles with halo
  const int nsel = 2 * nd + 1, sw = VC + 2 * nd, sh = TY + K - 1 + 2 * nd;
  const int v0 = hp - K + 1, v1 = wp - K + 1;
  const int c = blockIdx.x / tiles, t = blockIdx.x - c * tiles;
  const int tyi = t / tiles_x;
  const int by = tyi * TY, bx = (t - tyi * tiles_x) * TX;
  const int s0 = c * chunk, s1 = min(a, s0 + chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // vertical pass: column vcol, rows vrow .. vrow+RV-1
  const int vcol = tid & (VC - 1), vrow = (tid >> 6) * RV;
  // horizontal pass: row hrow, columns hseg*WH ..; a warp owns rows
  // 4*warp .. 4*warp+3, a quarter-warp two rows of four segments
  const int hseg = (tid & 3) | ((tid >> 1) & 4);
  const int hrow = ((tid >> 2) & 1) | ((tid >> 3) & ~1);

  float rr[NR];  // the reference strip, for every SAI and displacement
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int y = by + vrow + i, x = bx + vcol;
    rr[i] = (y < hp && x < wp) ? __ldg(ref + static_cast<size_t>(y) * wp + x)
                               : 0.f;
  }
  for (int r = warp; r < 2 * TY; r += CROSS_THREADS / 32)
    for (int x = VC + lane; x < PITCH; x += 32) sv[r * PITCH + x] = 0.f;

  auto load = [&](int s, float* dst) {
    const float* src = planes + static_cast<size_t>(s) * hp * wp;
    for (int yy = warp; yy < sh; yy += CROSS_THREADS / 32) {
      const int y = by - nd + yy;
      const bool yin = y >= 0 && y < hp;
      for (int xx = lane; xx < sw; xx += 32) {
        const int x = bx - nd + xx;
        const bool in = yin && x >= 0 && x < wp;
        cp_async4(dst + yy * SWP + xx,
                  in ? src + static_cast<size_t>(y) * wp + x : src, in);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  load(s0, sai);
  int b = 0;  // vertical-sum buffer of the next displacement
  for (int s = s0; s < s1; ++s) {
    const float* cur = sai + ((s - s0) & 1) * sh * SWP;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // SAI s is in; every reader of the other buffer is done
    if (s + 1 < s1) load(s + 1, sai + ((s + 1 - s0) & 1) * sh * SWP);
    int best[WH], bidx[WH];
#pragma unroll
    for (int w = 0; w < WH; ++w) {
      best[w] = INT_MAX;
      bidx[w] = 0;
    }
    for (int dxi = 0; dxi < nsel; ++dxi) {
      for (int dy0 = 0; dy0 < nsel; dy0 += DYB) {
        float col[NCOL];
        const float* cp = cur + (vrow + dy0) * SWP + vcol + dxi;
        const int rows = NR - 1 + min(DYB, nsel - dy0);
#pragma unroll
        for (int r = 0; r < NCOL; ++r) col[r] = r < rows ? cp[r * SWP] : 0.f;
#pragma unroll
        for (int jy = 0; jy < DYB; ++jy) {
          const int dyi = dy0 + jy;
          if (dyi >= nsel) break;
          float* svb = sv + b * TY * PITCH;
          float e[NR];
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            const float df = __fsub_rn(rr[r], col[jy + r]);
            e[r] = __fmul_rn(df, df);
          }
#pragma unroll
          for (int r = 0; r < RV; ++r) {
            float v = e[r];
#pragma unroll
            for (int i = 1; i < K; ++i) v = __fadd_rn(v, e[r + i]);
            svb[(vrow + r) * PITCH + vcol] = v;
          }
          __syncthreads();
          float h[NH];
          const float4* h4 = reinterpret_cast<const float4*>(
              svb + hrow * PITCH + hseg * WH);
#pragma unroll
          for (int q = 0; q < NH / 4; ++q) {
            const float4 f = h4[q];
            h[4 * q] = f.x;
            h[4 * q + 1] = f.y;
            h[4 * q + 2] = f.z;
            h[4 * q + 3] = f.w;
          }
          const int m = dyi * nsel + dxi;
#pragma unroll
          for (int w = 0; w < WH; ++w) {
            float box = h[w];
#pragma unroll
            for (int j = 1; j < K; ++j) box = __fadd_rn(box, h[w + j]);
            const int q = __float2int_rn(__fmul_rn(box, scale));
            if (q < best[w] || (q == best[w] && m < bidx[w])) {
              best[w] = q;
              bidx[w] = m;
            }
          }
          // the next displacement writes the other buffer; this one is
          // rewritten only after the next barrier, which every reader of it
          // reaches after this pass
          b ^= 1;
        }
      }
    }
    // stage the warp's four rows in the idle vertical-sum buffer (its last
    // readers passed the last barrier), then write contiguous row runs
    int* st = reinterpret_cast<int*>(sv + b * TY * PITCH);
#pragma unroll
    for (int w = 0; w < WH; ++w) st[hrow * PITCH + hseg * WH + w] = bidx[w];
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * warp + r, y = by + row;
      if (y >= v0) break;
      int* orow = out + (static_cast<size_t>(s) * v0 + y) * v1 + bx;
      for (int x = lane; x < TX && bx + x < v1; x += 32)
        orow[x] = st[row * PITCH + x];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(SELF_MAX_THREADS)
self_distances_kernel(const float* __restrict__ plane,
                      const int* __restrict__ ys, const int* __restrict__ xs,
                      int* __restrict__ out, int hp, int wp, int tx, int n,
                      int pitch, int nruns, float scale) {
  constexpr bool REF_IN_REGS = K <= 8;
  extern __shared__ float wnd[];  // [win][pitch], zero outside the plane
  const int t = blockIdx.x;
  const int ti = t / tx;
  const int y0 = ys[ti], x0 = xs[t - ti * tx];
  const int win = K + 2 * n, nsel = 2 * n + 1;
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int yy = threadIdx.x >> 5; yy < win; yy += nwarps) {
    const int y = y0 - n + yy;
    const bool yin = y >= 0 && y < hp;
    for (int xx = lane; xx < pitch; xx += 32) {
      const int x = x0 - n + xx;
      wnd[yy * pitch + xx] = (yin && xx < win && x >= 0 && x < wp)
                                 ? plane[static_cast<size_t>(y) * wp + x]
                                 : 0.f;
    }
  }
  __syncthreads();
  const float* rp = wnd + n * pitch + n;  // the reference patch
  float rr[REF_IN_REGS ? K * K : 1];
  if constexpr (REF_IN_REGS) {
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) rr[i * K + j] = rp[i * pitch + j];
  }
  auto refv = [&](int i, int j) -> float {
    if constexpr (REF_IN_REGS) return rr[i * K + j];
    else return rp[i * pitch + j];
  };

  const int items = nsel * nruns, step = blockDim.x;
  const int sdy = step / nruns, srun = step - sdy * nruns;
  int dy = threadIdx.x / nruns, run = threadIdx.x - dy * nruns;
  int* orow = out + static_cast<size_t>(t) * nsel * nsel;
  for (int item = threadIdx.x; item < items; item += step) {
    const float* w0 = wnd + dy * pitch + run * SELF_R;
    float box[SELF_R];
#pragma unroll
    for (int c = 0; c < K + SELF_R - 1; ++c) {
      float w[K];
#pragma unroll
      for (int i = 0; i < K; ++i) w[i] = w0[i * pitch + c];
#pragma unroll
      for (int r = 0; r < SELF_R; ++r) {
        const int j = c - r;
        if (j < 0 || j >= K) continue;
        float v = 0.f;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const float df = __fsub_rn(refv(i, j), w[i]);
          const float e = __fmul_rn(df, df);
          v = i ? __fadd_rn(v, e) : e;
        }
        box[r] = j ? __fadd_rn(box[r], v) : v;
      }
    }
    int* o = orow + dy * nsel + run * SELF_R;
#pragma unroll
    for (int r = 0; r < SELF_R; ++r)
      if (run * SELF_R + r < nsel)
        o[r] = __float2int_rn(__fmul_rn(box[r], scale));
    run += srun;
    dy += sdy;
    if (run >= nruns) {
      run -= nruns;
      ++dy;
    }
  }
}

struct SelfPlan {
  int threads, pitch, nruns;
};

// Launch plan of the self-BM kernel at t reference patches (kernels/bm.py::
// self_plan is its copy): a block takes the nsel * nruns items of its patch
// in rounds, each but the last full, as few rounds as keep
// SELF_THREADS_PER_SM threads on every SM for this grid, between
// SELF_MAX_THREADS and SELF_MIN_THREADS threads a block; the window rows
// have room for the last, ragged run.
SelfPlan make_self_plan(int k, int n, int t) {
  const int nsel = 2 * n + 1, nruns = cdiv(nsel, SELF_R);
  const int items = nsel * nruns;
  const int lo = cdiv(items, SELF_MAX_THREADS);
  const int hi = std::max(lo, cdiv(items, SELF_MIN_THREADS));
  const long long fill = static_cast<long long>(t) * items /
                         (NUM_SMS * SELF_THREADS_PER_SM);
  const int rounds = static_cast<int>(std::clamp<long long>(fill, lo, hi));
  return {32 * cdiv(cdiv(items, rounds), 32), (nruns * SELF_R + k - 1) | 1,
          nruns};
}

template <int K>
int launch_cross(const float* ref, const float* planes, int* out, int a,
                 int hp, int wp, int nd, float scale, cudaStream_t stream) {
  const CrossPlan p = make_cross_plan(hp, wp, a, K, nd);
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cross_argmin_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cross_argmin_kernel<K><<<p.grid, CROSS_THREADS, p.smem, stream>>>(
      ref, planes, out, a, hp, wp, nd, p.tiles_x, p.tiles, p.chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_self(const float* plane, const int* ys, const int* xs, int* out,
                int hp, int wp, int ty, int tx, int n, float scale,
                cudaStream_t stream) {
  const SelfPlan p = make_self_plan(K, n, ty * tx);
  const size_t smem = sizeof(float) * (K + 2 * n) * p.pitch;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  self_distances_kernel<K><<<ty * tx, p.threads, smem, stream>>>(
      plane, ys, xs, out, hp, wp, tx, n, p.pitch, p.nruns, scale);
  return static_cast<int>(cudaGetLastError());
}

#define LFBM5D_K_SWITCH(k, CALL)                                         \
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

const char* lfbm5d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The cross-argmin launch plan: out[5] = tile rows, tile columns, SAI chunk,
// grid (blocks), dynamic shared bytes. 0, or cudaErrorInvalidValue for
// shapes the kernel does not take.
int lfbm5d_bm_plan(int hp, int wp, int a, int k, int nd, int* out) {
  if (k < 1 || k > 16 || nd < 0 || nd > ND_MAX || a < 1 || hp < k || wp < k)
    return static_cast<int>(cudaErrorInvalidValue);
  const CrossPlan p = make_cross_plan(hp, wp, a, k, nd);
  out[0] = TY;
  out[1] = p.tx;
  out[2] = p.chunk;
  out[3] = p.grid;
  out[4] = static_cast<int>(p.smem);
  return 0;
}

// The self-BM launch plan at t reference patches: out[3] = threads, window
// pitch, runs per dy.
int lfbm5d_self_plan(int k, int n, int t, int* out) {
  if (k < 1 || k > 16 || n < 0 || t < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const SelfPlan p = make_self_plan(k, n, t);
  out[0] = p.threads;
  out[1] = p.pitch;
  out[2] = p.nruns;
  return 0;
}

// plane [hp, wp] f32; ys [ty], xs [tx] int32; out [ty*tx, (2n+1)^2] int32.
int lfbm5d_self_distances(const void* plane, const void* ys, const void* xs,
                          void* out, int hp, int wp, int ty, int tx, int k,
                          int n, float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define LFBM5D_SELF(K)                                                     \
  launch_self<K>(static_cast<const float*>(plane),                         \
                 static_cast<const int*>(ys), static_cast<const int*>(xs), \
                 static_cast<int*>(out), hp, wp, ty, tx, n, scale, s)
  LFBM5D_K_SWITCH(k, LFBM5D_SELF)
#undef LFBM5D_SELF
}

// ref [hp, wp] f32; planes [a, hp, wp] f32; out [a, hp-k+1, wp-k+1] int32.
int lfbm5d_cross_argmin(const void* ref, const void* planes, void* out, int a,
                        int hp, int wp, int k, int nd, float scale,
                        void* stream) {
  if (nd < 0 || nd > ND_MAX || a < 1 || hp < k || wp < k)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define LFBM5D_CROSS(K)                                                    \
  launch_cross<K>(static_cast<const float*>(ref),                          \
                  static_cast<const float*>(planes), static_cast<int*>(out), \
                  a, hp, wp, nd, scale, s)
  LFBM5D_K_SWITCH(k, LFBM5D_CROSS)
#undef LFBM5D_CROSS
}

}  // extern "C"
