// Block-matching kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// lfbm5d_self_distances replaces lfbm5d_tpu/kernels/bm.py::self_distances_kernel
//   (TPU: banded 0/1 selection matmuls on the MXU at HIGHEST precision).
//   One block per reference patch: the (k+2n)^2 search window and the k x k
//   reference patch go to shared memory, and each thread computes the box SSD
//   of one displacement at a time. Work is T*(2n+1)^2*k^2 multiply-adds
//   (4345 * 1089 * 64 = 0.3 G at the matched flagship); reads are one window
//   per block, so shared-memory reads and instruction throughput bound it,
//   not HBM.
//
// lfbm5d_cross_argmin replaces lfbm5d_tpu/kernels/bm.py::cross_argmin_all_kernel
//   (TPU: a VMEM-resident displacement loop with doubling-tree box sums).
//   One block per (TY x TX output tile, SAI): the reference and SAI tiles
//   (plus the k-1 and nd halos) go to shared memory once; per displacement
//   the squared differences, the vertical k-tap sums and the horizontal
//   k-tap sums are three shared-memory passes, and the running argmin stays
//   in registers. Each plane is read once per reference, and the argmin map
//   written once (97 MB per reference at the flagship): bound by HBM traffic
//   and shared-memory passes.
//
// Both kernels use exact fp32 arithmetic in the plain twins' order
// (lfbm5d_torch/ops/distances.py): squared difference, vertical taps first,
// each sum sequential, no fused multiply-add; distances are rounded half to
// even (__float2int_rn) after the k^2 normalisation and the argmin keeps the
// first occurrence (strict <) in row-major displacement order. So each
// kernel agrees with its plain twin bit for bit.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int SELF_THREADS = 256;
constexpr int TY = 16;
constexpr int TX = 32;
constexpr int CROSS_THREADS = 256;
constexpr int OUT_PER_THREAD = TY * TX / CROSS_THREADS;

__global__ void __launch_bounds__(SELF_THREADS)
self_distances_kernel(const float* __restrict__ plane,
                      const int* __restrict__ ys, const int* __restrict__ xs,
                      int* __restrict__ out, int hp, int wp, int tx, int k,
                      int n, float scale) {
  extern __shared__ float sm[];
  const int t = blockIdx.x;
  const int y0 = ys[t / tx], x0 = xs[t % tx];
  const int win = k + 2 * n;
  float* ref = sm;          // [k][k]
  float* wnd = sm + k * k;  // [win][win], zero outside the plane
  for (int i = threadIdx.x; i < k * k; i += blockDim.x)
    ref[i] = plane[(y0 + i / k) * wp + x0 + i % k];
  for (int i = threadIdx.x; i < win * win; i += blockDim.x) {
    const int y = y0 - n + i / win, x = x0 - n + i % win;
    wnd[i] = (y >= 0 && y < hp && x >= 0 && x < wp) ? plane[y * wp + x] : 0.f;
  }
  __syncthreads();
  const int nsel = 2 * n + 1, ds = nsel * nsel;
  for (int d = threadIdx.x; d < ds; d += blockDim.x) {
    const float* w = wnd + (d / nsel) * win + d % nsel;
    float box = 0.f;
    for (int j = 0; j < k; ++j) {
      float v = 0.f;
      for (int i = 0; i < k; ++i) {
        const float df = __fsub_rn(ref[i * k + j], w[i * win + j]);
        const float e = __fmul_rn(df, df);
        v = i ? __fadd_rn(v, e) : e;
      }
      box = j ? __fadd_rn(box, v) : v;
    }
    out[(size_t)t * ds + d] = __float2int_rn(__fmul_rn(box, scale));
  }
}

__global__ void __launch_bounds__(CROSS_THREADS)
cross_argmin_kernel(const float* __restrict__ ref,
                    const float* __restrict__ planes, int* __restrict__ out,
                    int hp, int wp, int k, int nd, float scale) {
  extern __shared__ float sm[];
  const int ry = TY + k - 1, rx = TX + k - 1;  // reference / e tile
  const int oh = ry + 2 * nd, ow = rx + 2 * nd;  // SAI tile with nd halo
  float* sref = sm;
  float* soth = sref + ry * rx;
  float* se = soth + oh * ow;
  float* sv = se + ry * rx;  // [TY][rx] vertical sums
  const int v0 = hp - k + 1, v1 = wp - k + 1;
  const int by = blockIdx.y * TY, bx = blockIdx.x * TX;
  const float* oth = planes + (size_t)blockIdx.z * hp * wp;

  for (int i = threadIdx.x; i < ry * rx; i += blockDim.x) {
    const int y = by + i / rx, x = bx + i % rx;
    sref[i] = (y < hp && x < wp) ? ref[(size_t)y * wp + x] : 0.f;
  }
  for (int i = threadIdx.x; i < oh * ow; i += blockDim.x) {
    const int y = by - nd + i / ow, x = bx - nd + i % ow;
    soth[i] = (y >= 0 && y < hp && x >= 0 && x < wp)
                  ? oth[(size_t)y * wp + x] : 0.f;
  }
  int best[OUT_PER_THREAD], bidx[OUT_PER_THREAD];
#pragma unroll
  for (int o = 0; o < OUT_PER_THREAD; ++o) {
    best[o] = INT_MAX;
    bidx[o] = 0;
  }
  __syncthreads();

  const int nsel = 2 * nd + 1;
  for (int m = 0; m < nsel * nsel; ++m) {
    const float* sh = soth + (m / nsel) * ow + m % nsel;
    for (int i = threadIdx.x; i < ry * rx; i += blockDim.x) {
      const float df = __fsub_rn(sref[i], sh[(i / rx) * ow + i % rx]);
      se[i] = __fmul_rn(df, df);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TY * rx; i += blockDim.x) {
      float v = se[i];
      for (int r = 1; r < k; ++r) v = __fadd_rn(v, se[i + r * rx]);
      sv[i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int o = 0; o < OUT_PER_THREAD; ++o) {
      const int idx = threadIdx.x + o * CROSS_THREADS;
      const float* row = sv + (idx / TX) * rx + idx % TX;
      float box = row[0];
      for (int j = 1; j < k; ++j) box = __fadd_rn(box, row[j]);
      const int q = __float2int_rn(__fmul_rn(box, scale));
      if (q < best[o]) {
        best[o] = q;
        bidx[o] = m;
      }
    }
    // the next displacement's first pass writes only se, which every
    // thread finished reading before the barrier above
  }
#pragma unroll
  for (int o = 0; o < OUT_PER_THREAD; ++o) {
    const int idx = threadIdx.x + o * CROSS_THREADS;
    const int y = by + idx / TX, x = bx + idx % TX;
    if (y < v0 && x < v1)
      out[((size_t)blockIdx.z * v0 + y) * v1 + x] = bidx[o];
  }
}

}  // namespace

extern "C" {

const char* lfbm5d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// plane [hp, wp] f32; ys [ty], xs [tx] int32; out [ty*tx, (2n+1)^2] int32.
int lfbm5d_self_distances(const void* plane, const void* ys, const void* xs,
                          void* out, int hp, int wp, int ty, int tx, int k,
                          int n, float scale, void* stream) {
  const int win = k + 2 * n;
  const size_t smem = sizeof(float) * (k * k + win * win);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  self_distances_kernel<<<ty * tx, SELF_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(plane), static_cast<const int*>(ys),
      static_cast<const int*>(xs), static_cast<int*>(out), hp, wp, tx, k, n,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ref [hp, wp] f32; planes [a, hp, wp] f32; out [a, hp-k+1, wp-k+1] int32.
int lfbm5d_cross_argmin(const void* ref, const void* planes, void* out, int a,
                        int hp, int wp, int k, int nd, float scale,
                        void* stream) {
  const int ry = TY + k - 1, rx = TX + k - 1;
  const int oh = ry + 2 * nd, ow = rx + 2 * nd;
  const size_t smem = sizeof(float) * (2 * ry * rx + oh * ow + TY * rx);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int v0 = hp - k + 1, v1 = wp - k + 1;
  const dim3 grid((v1 + TX - 1) / TX, (v0 + TY - 1) / TY, a);
  cross_argmin_kernel<<<grid, CROSS_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ref), static_cast<const float*>(planes),
      static_cast<int*>(out), hp, wp, k, nd, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
