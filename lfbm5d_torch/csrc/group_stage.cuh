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
// bytes) follows from N, aH, aW, Wiener and the chain alone (make_plan;
// Python copy in kernels/fused.py::group_plan).
//
// BF16 instantiates the bfloat16 transform chain (the reference kernels with
// cdt = bfloat16; transforms/apply.py states the rounding points and
// tables): the caller's spatial tables are the bf16-rounded 1-D factors;
// `load` rounds the group to bf16; the spatial pass rounds its result after
// the second 1-D transform; the angular transform is one dense contraction
// with the bf16-rounded kron table on the tensor cores (`angular_dense`,
// Args::kang: rounding the two 1-D factors instead would double the chain's
// gain on the mean), rounded; the stack transform, the Wiener product and the inverse stack
// each round theirs (round to nearest even). Every product accumulates in
// f32, and the shrink, the weights, the Kaiser weighting and the atomics
// stay f32. The group stays in f32 shared memory holding bf16-rounded
// values, so the slices and the plan are the f32 chain's.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
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
constexpr int KT = 128;  // largest A of the BF16 chain's dense angular table

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
  const uint32_t* kang;  // BF16: [2][KP][KP] bf16 dense angular tables, or null
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

// Words of the BF16 chain's shared angular table: one direction's dense
// table at a time, 16 * tiles rows of 8 * tiles bf16 pairs padded by 4
// (tiles = A / 16 rounded up), so A-fragment reads hit 32 banks, and 4
// words to align it to 16 bytes.
__host__ __device__ inline int table_words(int a) {
  const int tiles = (a + 15) / 16;
  return 16 * tiles * (8 * tiles + 4) + 4;
}

// Dynamic shared memory at cluster size cs: the slice, the origins of the
// CTA's share of the patches and, for the BF16 chain, its angular table.
inline int plan_smem(int n, int a_h, int a_w, int wiener, int bf16, int cs) {
  const int patches = (n * a_h * a_w + cs - 1) / cs;
  return 4 * ((wiener ? 2 : 1) * (KK / cs) * slice_stride(n, a_h, a_w) +
              2 * patches + (bf16 ? table_words(a_h * a_w) : 0));
}

// The fewest CTAs whose slice fits two CTAs (256 threads each) on an SM,
// else one CTA of 512 threads: 16 warps per SM either way.
inline bool make_plan(int n, int a_h, int a_w, int wiener, int bf16,
                      Plan* out) {
  for (int per_sm = 2; per_sm >= 1; --per_sm) {
    int limit = SMEM_PER_SM / per_sm - SMEM_RESERVED;
    if (limit > SMEM_PER_BLOCK) limit = SMEM_PER_BLOCK;
    limit -= STATIC_SMEM;
    for (int cs = 1; cs <= MAX_CLUSTER; cs *= 2) {
      const int smem = plan_smem(n, a_h, a_w, wiener, bf16, cs);
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

// x rounded to bfloat16 (nearest even) in the BF16 chain, else x.
template <bool BF16>
__device__ __forceinline__ float chain_round(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
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
template <bool BF16>
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
    x[v] = chain_round<BF16>(acc);
  }
}

// Lane u: z = row u of Z -> column j = u of X = I2 Z I2^T.
template <bool BF16>
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
    z[i] = chain_round<BF16>(acc);
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

// One tensor-core product D += A B, m16n8k16, bf16 inputs, f32 accumulate:
// lane (g = lane / 4, c = lane % 4) holds A rows g, g+8 at columns 2c, 2c+1,
// 2c+8, 2c+9 (a[0..3]), B rows 2c, 2c+1 (b0) and 2c+8, 2c+9 (b1) of column
// g, and D rows g, g+8 at columns 2c, 2c+1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as the bf16 pair of one fragment register (lo first).
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The BF16 chain's angular transform: out = K v over the A SAIs of every
// item (row, slot) of the slice, in place, rounded to bf16, on the tensor
// cores. K is the dense bf16-rounded table (kron of the two angular DCTs, as
// the reference's), kt [KP][KP] bf16 row-major (q, a) in shared memory
// (`load_table`: rows of 8 * TILES + 4 pairs), zero padded to KP = 16 *
// TILES >= A. The items hold bf16 values, so the products are exact and the
// sums f32, as the reference's bf16 x bf16 -> f32 dot products. A warp
// takes 8 items (one n8 tile) at a time: it loads their values as B
// fragments for every k tile first, then runs the m tiles, each
// accumulating over the k tiles from A fragments, and writes its outputs.
// SAI a sits at column a, or a + a / aW when aW is even (PAD: awp = aW +
// 1). TILES and PAD are template parameters so the fragments stay in
// registers and odd grids skip the division.
template <int TILES, bool PAD>
__device__ void angular_mma(float* S, int rows, int ps, int lg_ns, int ap,
                            int aW, int A, const uint32_t* kt) {
  constexpr int KP2 = TILES * 8 + 4;  // words per shared table row
  const int items = rows << lg_ns;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const float inv_aw = 1.f / aW;
  auto col = [&](int a) {
    if constexpr (PAD) return a + __float2int_rz((a + 0.5f) * inv_aw);
    return a;
  };
  auto base = [&](int it) {
    return (it >> lg_ns) * ps + (it & ((1 << lg_ns) - 1)) * ap;
  };
  for (int ib = 8 * (threadIdx.x >> 5); ib < items;
       ib += 8 * (blockDim.x >> 5)) {
    uint32_t b[TILES][2];
    {
      const int it = ib + g;
      const int bs = it < items ? base(it) : 0;
#pragma unroll
      for (int k = 0; k < TILES; ++k) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int a = 16 * k + 2 * c + (j & 1) + 8 * (j >> 1);
          v[j] = it < items && a < A ? S[bs + col(a)] : 0.f;
        }
        b[k][0] = bf16_pair(v[0], v[1]);
        b[k][1] = bf16_pair(v[2], v[3]);
      }
    }
    __syncwarp();  // every lane holds its inputs before any output lands
    const int out_it[2] = {ib + 2 * c, ib + 2 * c + 1};  // D columns
    const int out_base[2] = {base(out_it[0]), base(out_it[1])};
#pragma unroll 2
    for (int m = 0; m < TILES; ++m) {
      float d[4] = {};
      const uint32_t* r0 = kt + (16 * m + g) * KP2 + c;
      const uint32_t* r1 = r0 + 8 * KP2;
#pragma unroll
      for (int k = 0; k < TILES; ++k) {
        const uint32_t a[4] = {r0[8 * k], r1[8 * k], r0[8 * k + 4],
                               r1[8 * k + 4]};
        mma_bf16(d, a, b[k][0], b[k][1]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = 16 * m + g + 8 * (r >> 1);
        if (q < A && out_it[r & 1] < items)
          S[out_base[r & 1] + col(q)] = chain_round<true>(d[r]);
      }
    }
  }
}

// Copies one direction's dense table of Args::kang (forward, or inverse:
// the second) into the CTA's shared table (16-byte aligned), rows padded as
// angular_mma reads them, in 16-byte words with four loads in flight per
// thread. The caller orders it against the table's readers.
__device__ void load_table(uint32_t* dst, const uint32_t* kang, int A,
                           bool inverse) {
  const int tiles = (A + 15) >> 4, row4 = 2 * tiles, n4 = 16 * tiles * row4;
  const uint4* src = reinterpret_cast<const uint4*>(kang) + (inverse ? n4 : 0);
#pragma unroll 4
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    *reinterpret_cast<uint4*>(dst + i / row4 * (4 * row4 + 4) +
                              i % row4 * 4) = __ldg(src + i);
}

// angular_mma at the table's tile count (A <= 128: 1..8 tiles) and column
// padding; kt: the shared table (load_table).
template <bool PAD>
__device__ void angular_tiles(float* S, int rows, int ps, int lg_ns, int ap,
                              int aW, int A, const uint32_t* kt) {
  switch ((A + 15) >> 4) {
    case 1: return angular_mma<1, PAD>(S, rows, ps, lg_ns, ap, aW, A, kt);
    case 2: return angular_mma<2, PAD>(S, rows, ps, lg_ns, ap, aW, A, kt);
    case 3: return angular_mma<3, PAD>(S, rows, ps, lg_ns, ap, aW, A, kt);
    case 4: return angular_mma<4, PAD>(S, rows, ps, lg_ns, ap, aW, A, kt);
    case 5: return angular_mma<5, PAD>(S, rows, ps, lg_ns, ap, aW, A, kt);
    case 6: return angular_mma<6, PAD>(S, rows, ps, lg_ns, ap, aW, A, kt);
    case 7: return angular_mma<7, PAD>(S, rows, ps, lg_ns, ap, aW, A, kt);
    default: return angular_mma<8, PAD>(S, rows, ps, lg_ns, ap, aW, A, kt);
  }
}

__device__ void angular_dense(float* S, int rows, int ps, int lg_ns, int ap,
                              int aH, int aW, const uint32_t* kt) {
  if (aW & 1) {
    angular_tiles<false>(S, rows, ps, lg_ns, ap, aW, aH * aW, kt);
  } else {
    angular_tiles<true>(S, rows, ps, lg_ns, ap, aW, aH * aW, kt);
  }
}

// Stack transform of NS live slots, shrink, inverse stack, on the noisy
// region (the basic region guides Wiener). Items (lc, s, t), t fastest,
// stepped by blockDim without dividing. Returns this thread's part of the
// HT count or of the Wiener sum of omega^2. The BF16 chain rounds both
// forward stack results, the Wiener product and the inverse stack's.
template <int NS, bool WIENER, bool BF16>
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
        b = chain_round<BF16>(b);
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
      acc = chain_round<BF16>(acc);
      if constexpr (WIENER) {
        acc = chain_round<BF16>(acc * y[q]);
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
      col[q * ap] = chain_round<BF16>(acc);
    }
  }
  return part;
}

template <bool WIENER, bool BF16>
__device__ float stack_pass(int ns, float* S, int cpc, int ps, int ap, int aH,
                            int aW, int awp, float sig2, float thr) {
  switch (ns) {
    case 1: return stack_shrink<1, WIENER, BF16>(S, cpc, ps, ap, aH, aW, awp, sig2, thr);
    case 2: return stack_shrink<2, WIENER, BF16>(S, cpc, ps, ap, aH, aW, awp, sig2, thr);
    case 4: return stack_shrink<4, WIENER, BF16>(S, cpc, ps, ap, aH, aW, awp, sig2, thr);
    case 8: return stack_shrink<8, WIENER, BF16>(S, cpc, ps, ap, aH, aW, awp, sig2, thr);
    default: return stack_shrink<16, WIENER, BF16>(S, cpc, ps, ap, aH, aW, awp, sig2, thr);
  }
}

// The group stage of one reference SAI; sm: the dynamic shared memory
// (slice, then the origins of this CTA's patches). BF16: the chain.
template <int MAXG, bool BF16>
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
  uint32_t* ktab = reinterpret_cast<uint32_t*>(
      (reinterpret_cast<uintptr_t>(ox + (p.N * p.A + cs - 1) / cs) + 15) &
      ~uintptr_t{15});

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
      if constexpr (BF16) {  // ready at the barrier after the scatter
        if (p.kang) load_table(ktab, p.kang, p.A, false);
      }
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
          for (int r = 0; r < K; ++r)
            x[r] = chain_round<BF16>(__ldg(src + r * p.Wp));
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
        spatial_fwd<BF16>(x, lane8);
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
      if constexpr (BF16) {
        if (p.kang) {
          angular_dense(sm, rows, ps, s_lvl, ap, p.aH, p.aW, ktab);
          __syncthreads();  // the forward table is read; block_sum orders
          load_table(ktab, p.kang, p.A, true);  // the inverse before use
        }
      } else {
        angular_pass<0, MAXG>(p.aH, sm, rows, ps, s_lvl, ap, p.aW, 1, awp);
        __syncthreads();
        angular_pass<2, MAXG>(p.aW, sm, rows, ps, s_lvl, ap, p.aH, awp, 1);
      }
      __syncthreads();
      const float part =
          p.wiener ? stack_pass<true, BF16>(ns, sm, cpc, ps, ap, p.aH, p.aW,
                                            awp, sig2, 0.f)
                   : stack_pass<false, BF16>(ns, sm, cpc, ps, ap, p.aH, p.aW,
                                             awp, sig2, p.lambda * sig);
      const float tot = block_sum(part, red);  // orders the stack pass too
      if (threadIdx.x == 0) s_part = tot;
      if constexpr (BF16) {
        if (p.kang)
          angular_dense(sm, cpc, ps, s_lvl, ap, p.aH, p.aW, ktab);
      } else {
        angular_pass<1, MAXG>(p.aH, sm, cpc, ps, s_lvl, ap, p.aW, 1, awp);
        __syncthreads();
        angular_pass<3, MAXG>(p.aW, sm, cpc, ps, s_lvl, ap, p.aH, awp, 1);
      }
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
        spatial_inv<BF16>(z, lane8);
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
                      const void* kang, void* num, void* wden, int T, int N,
                      int A, int aH, int aW, int C, int Hp, int Wp, int V0,
                      int V1, int nd, int ref, int wiener, float lambda) {
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
  p.kang = static_cast<const uint32_t*>(kang);
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
int occupancy(Kernel kernel, int N, int aH, int aW, int wiener, int bf16,
              int* out) {
  Plan plan;
  if (!make_plan(N, aH, aW, wiener, bf16, &plan))
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
int launch_groups(Kernel kernel, const Args& p, const void* tables, int bf16,
                  cudaStream_t stream) {
  Plan plan;
  if (!make_plan(p.N, p.aH, p.aW, p.wiener, bf16, &plan))
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
