// Shared device helpers of the port's kernels: compensated sums, the
// double-single walk state, the Hastings normal CDF, the walk drivers, the
// Heston Euler steps, the fixed-order block reductions (two sums per
// thread, or N sums per iteration) and the asset-major Greek kernels'
// per-path sums.
//
// Every compensated operation is written with __fadd_rn/__fsub_rn/__fmul_rn,
// which nvcc never contracts into an FMA nor reassociates, so the error-free
// transformations stay error-free (counterparts: mctpu/utils/accum.py and
// mctpu_torch/utils/accum.py).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "philox.cuh"

namespace mct {

constexpr int LANES = 128;

// Shared-memory loads the compiler may not move: a kernel that stages
// loop-invariant operands (a correlation factor, per-asset rows) reads them
// at each use instead of holding them in registers across its loops.
__device__ __forceinline__ float4 lds4(const float4* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

__device__ __forceinline__ float lds1(const float* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];"
               : "=f"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

// Neumaier compensated add of x into (s, c).
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float t = __fadd_rn(s, x);
  const float lost = (fabsf(s) >= fabsf(x)) ? __fadd_rn(__fsub_rn(s, t), x)
                                            : __fadd_rn(__fsub_rn(x, t), s);
  s = t;
  c = __fadd_rn(c, lost);
}

// Per-thread (sum p, sum p^2) accumulator, compensated when KAHAN.
template <bool KAHAN>
struct Acc2 {
  float s = 0.0f, c = 0.0f, s2 = 0.0f, c2 = 0.0f;

  __device__ __forceinline__ void add(float p) {
    const float pp = __fmul_rn(p, p);
    if (KAHAN) {
      kahan_add(s, c, p);
      kahan_add(s2, c2, pp);
    } else {
      s = __fadd_rn(s, p);
      s2 = __fadd_rn(s2, pp);
    }
  }
  __device__ __forceinline__ float sum() const { return __fadd_rn(s, c); }
  __device__ __forceinline__ float sum2() const { return __fadd_rn(s2, c2); }
};

// Normalized double-single add: (hi, lo) += x.
__device__ __forceinline__ void ds_add(float& hi, float& lo, float x) {
  const float s = __fadd_rn(hi, x);
  const float bb = __fsub_rn(s, hi);
  const float e = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)), __fsub_rn(x, bb));
  const float l = __fadd_rn(lo, e);
  const float hi2 = __fadd_rn(s, l);
  lo = __fsub_rn(l, __fsub_rn(hi2, s));
  hi = hi2;
}

// Hastings approximation of the standard normal CDF (Abramowitz & Stegun
// 26.2.17), the reference's `cnd` (mctpu/math.py, norm_cdf_hastings), given
// e = expf(-0.5 d d), which a caller that also needs the density shares.
__device__ __forceinline__ float norm_cdf_hastings_e(float d, float e) {
  const float k = 1.0f / (1.0f + MCT_F32(0.2316419) * fabsf(d));
  const float poly =
      k * (MCT_F32(0.31938153) +
           k * (MCT_F32(-0.356563782) +
                k * (MCT_F32(1.781477937) +
                     k * (MCT_F32(-1.821255978) + k * MCT_F32(1.330274429)))));
  const float cnd = MCT_F32(0.39894228040143267793994605993438) * e * poly;
  return d > 0.0f ? 1.0f - cnd : cnd;
}

__device__ __forceinline__ float norm_cdf_hastings(float d) {
  return norm_cdf_hastings_e(d, expf(MCT_F32(-0.5) * d * d));
}

// Drives a walk of n_steps over tile element e that consumes both
// Box-Muller branches (mctpu_torch/kernels/common.py, walk_pairwise): pair jj
// draws Philox block (e, jj, 0, 0), its cosine branch feeds step 2jj and its
// sine branch step 2jj+1; an odd n_steps takes the cosine branch of pair
// n_steps/2 last.  step(j, z) advances the caller's state.
template <typename Step>
__device__ __forceinline__ void walk_pairwise(Key key, uint32_t e, int n_steps,
                                              Step&& step) {
  const int half = n_steps / 2;
  for (int jj = 0; jj < half; ++jj) {
    float z1, z2;
    draw_normal_pair(key, e, static_cast<uint32_t>(jj), z1, z2);
    step(2 * jj, z1);
    step(2 * jj + 1, z2);
  }
  if (n_steps & 1) {
    float z1, z2;
    draw_normal_pair(key, e, static_cast<uint32_t>(half), z1, z2);
    step(n_steps - 1, z1);
  }
}

// Drives an asset-major walk of n_steps over tile element e that takes A
// normals a step and consumes both Box-Muller branches
// (mctpu_torch/kernels/common.py, walk_pairwise_multi): pair jj draws Philox
// blocks (e, jj*A + i, 0, 0) for i < A, their cosine branches feed step 2jj
// and their sine branches step 2jj+1; an odd n_steps takes the cosine
// branches of counters (n_steps/2)*A + i last.  step(j, z) advances the
// caller's state from z[A].
template <int A, typename Step>
__device__ __forceinline__ void walk_pairwise_multi(Key key, uint32_t e,
                                                    int n_steps, Step&& step) {
  const int half = n_steps / 2;
  float z1[A], z2[A];
  for (int jj = 0; jj < half; ++jj) {
#pragma unroll
    for (int i = 0; i < A; ++i) {
      draw_normal_pair(key, e, static_cast<uint32_t>(jj * A + i), z1[i],
                       z2[i]);
    }
    step(2 * jj, z1);
    step(2 * jj + 1, z2);
  }
  if (n_steps & 1) {
#pragma unroll
    for (int i = 0; i < A; ++i) {
      draw_normal_pair(key, e, static_cast<uint32_t>(half * A + i), z1[i],
                       z2[i]);
    }
    step(n_steps - 1, z1);
  }
}

// Drives a walk of n_steps over tile element e that takes one Box-Muller
// pair per step (mctpu_torch/kernels/common.py, walk_steps): step j draws
// Philox block (e, j, 0, 0) and gets both branches.  step(j, z1, z2)
// advances the caller's state.
template <typename Step>
__device__ __forceinline__ void walk_steps(Key key, uint32_t e, int n_steps,
                                           Step&& step) {
  for (int j = 0; j < n_steps; ++j) {
    float z1, z2;
    draw_normal_pair(key, e, static_cast<uint32_t>(j), z1, z2);
    step(j, z1, z2);
  }
}

// The constants of one full-truncation Euler step of the Heston walk
// (mctpu_torch/kernels/heston.py), read from seven consecutive scalars.
struct HestonStep {
  float k_dt, th, xi, rho_c, rho_s, r_dt, sqdt;
};

__device__ __forceinline__ HestonStep heston_consts(const float* p) {
  return HestonStep{p[0], p[1], p[2], p[3], p[4], p[5], p[6]};
}

// One Euler step of (x, v), x = log(S / S0), in mctpu's _heston_step order:
// vp = max(v, 0), x += r dt - vp dt / 2 + sqrt(vp) sqrt(dt) z_s,
// v += kappa dt (theta - vp) + xi sqrt(vp) sqrt(dt) z_v.  Its translation
// unit builds with -fmad=false, so every path rounds as the plain version's
// separate operations do and max(v, 0) falls on the same side.
__device__ __forceinline__ void heston_step(const HestonStep& c, float z_v,
                                            float z_perp, float& x,
                                            float& v) {
  const float vp = fmaxf(v, 0.0f);
  const float sq_v = sqrtf(vp) * c.sqdt;
  const float z_s = c.rho_c * z_v + c.rho_s * z_perp;
  x = x + c.r_dt - 0.5f * vp * (c.sqdt * c.sqdt) + sq_v * z_s;
  v = v + c.k_dt * (c.th - vp) + c.xi * sq_v * z_v;
}

// One Euler step of (x, v) and of the tangent pairs tg = (al, av) for
// p = v0, theta, kappa, xi (mctpu's _greek_step): dvp = 1{v > 0} av,
// al += dvp cA, av += dvp cB + e_p.  mctpu's (0.5 sqdt) rsqrt(vp) is
// (0.5 sqdt) (1 / sqrt(vp)) here, an IEEE root and division as in the plain
// version (rsqrtf is not correctly rounded), and 0 at vp = 0.
__device__ __forceinline__ void heston_greek_step(const HestonStep& c,
                                                  float half_dt, float dt,
                                                  float z_v, float z_perp,
                                                  float& x, float& v,
                                                  float (&tg)[8]) {
  const float vp = fmaxf(v, 0.0f);
  const float sq = sqrtf(vp);
  const float sq_v = sq * c.sqdt;
  const float dsq = vp > 0.0f ? (0.5f * c.sqdt) * __fdiv_rn(1.0f, sq) : 0.0f;
  const bool m = v > 0.0f;
  const float z_s = c.rho_c * z_v + c.rho_s * z_perp;
  x = x + c.r_dt - half_dt * vp + sq_v * z_s;
  const float c_a = z_s * dsq - half_dt;
  const float c_b = c.xi * dsq * z_v - c.k_dt;
  const float extra[4] = {0.0f, c.k_dt, dt * (c.th - vp), sq_v * z_v};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float dvp = m ? tg[2 * i + 1] : 0.0f;
    tg[2 * i] = tg[2 * i] + dvp * c_a;
    tg[2 * i + 1] = tg[2 * i + 1] + dvp * c_b + extra[i];
  }
  v = v + c.k_dt * (c.th - vp) + c.xi * sq_v * z_v;
}

// Sum of (a, b) over the block's THREADS threads, in a fixed shared-memory
// tree; every thread returns the block totals.  Deterministic: the same
// inputs give the same bits on every launch.
template <int THREADS>
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[THREADS];
  __shared__ float sb[THREADS];
  const int t = threadIdx.x;
  sa[t] = a;
  sb[t] = b;
  __syncthreads();
#pragma unroll
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
    if (t < stride) {
      sa[t] = __fadd_rn(sa[t], sa[t + stride]);
      sb[t] = __fadd_rn(sb[t], sb[t + stride]);
    }
    __syncthreads();
  }
  a = sa[0];
  b = sb[0];
}

// Writes one simulation block's (sum_p, sum_p2) row.
template <int THREADS, bool KAHAN>
__device__ __forceinline__ void write_block_sums(const Acc2<KAHAN>& acc,
                                                 float* out) {
  float s = acc.sum();
  float s2 = acc.sum2();
  block_sum2<THREADS>(s, s2);
  if (threadIdx.x == 0) {
    out[2 * blockIdx.x] = s;
    out[2 * blockIdx.x + 1] = s2;
  }
}

// N per-iteration sums of a block, as the JAX kernels' acc_add_n: each
// thread sums its elements of an iteration plainly into v[]; add() reduces
// every v[k] over the block in a fixed order (warp-shuffle tree, then the
// warps in order), scales it by scale[k] when scale is given, and adds it
// into the carry of thread k (k < N), Neumaier-compensated when KAHAN.
// Deterministic, no atomics.  Every thread of the block calls add() and
// write().
template <int THREADS, int N, bool KAHAN>
struct BlockAccN {
  static_assert(N <= THREADS, "one carrying thread per sum");
  static constexpr int WARPS = THREADS / 32;
  float s = 0.0f, c = 0.0f;  // carry of sum threadIdx.x

  // sh: WARPS * N floats of shared memory; v is zeroed on return.
  __device__ __forceinline__ void add(float (&v)[N], const float* scale,
                                      float* sh) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float r = v[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        r = __fadd_rn(r, __shfl_down_sync(0xffffffffu, r, o));
      }
      if (lane == 0) sh[warp * N + k] = r;
      v[k] = 0.0f;
    }
    __syncthreads();
    if (threadIdx.x < N) {
      float t = sh[threadIdx.x];
      for (int w = 1; w < WARPS; ++w) t = __fadd_rn(t, sh[w * N + threadIdx.x]);
      if (scale != nullptr) t = __fmul_rn(t, scale[threadIdx.x]);
      if (KAHAN) {
        kahan_add(s, c, t);
      } else {
        s = __fadd_rn(s, t);
      }
    }
    __syncthreads();
  }

  // The block's row of N partials (compensation folded in).
  __device__ __forceinline__ void write(float* out) const {
    if (threadIdx.x < N) {
      out[static_cast<size_t>(blockIdx.x) * N + threadIdx.x] = __fadd_rn(s, c);
    }
  }

  // The first n <= N partials, to dst[0 .. n) (compensation folded in).
  __device__ __forceinline__ void write_n(float* dst, int n) const {
    if (threadIdx.x < n) dst[threadIdx.x] = __fadd_rn(s, c);
  }
};

// The split walks (K4, K5, K43's and K44's runtime-m kernels) cut a
// simulation block's rows into slices, one CUDA block per (block, slice)
// item.  A slice writes per iteration its N per-thread sums reduced over
// the block (block_row) into scratch [B][iters][S][N], and at the end its
// profile row into [B][S][gp] after them; slice_fold adds the slices in
// order.  The order depends on the plan alone, so two launches and any
// block offset give the same bits.

// The N per-thread sums v reduced over the block (BlockAccN's tree and warp
// order, no carry) into dst; v is zeroed.  sh: WARPS * N floats.
template <int THREADS, int N>
__device__ __forceinline__ void block_row(float (&v)[N], float* sh,
                                          float* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float r = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      r = __fadd_rn(r, __shfl_down_sync(0xffffffffu, r, o));
    }
    if (lane == 0) sh[warp * N + k] = r;
    v[k] = 0.0f;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float t = sh[threadIdx.x];
    for (int w = 1; w < THREADS / 32; ++w) {
      t = __fadd_rn(t, sh[w * N + threadIdx.x]);
    }
    dst[threadIdx.x] = t;
  }
  __syncthreads();
}

// The fold's carry between groups of iterations (a split kernel whose
// scratch is grouped, K44's runtime-m): carry holds (s, c) of each (block,
// sum) of the group's blocks; the first group starts from zero, the last
// writes out.  No carry: one group.
struct FoldCarry {
  float* carry;
  int first, last;
};

// Item idx of a fold over n_blocks * (n + gp) items: for k < n, block b's
// sum k, per iteration its slices added in order and carried over the
// iterations (Kahan under KAHAN, as BlockAccN carries) into out (B, n);
// past n, node k - n of its profile, the slices' rows added in order, into
// prof_out (B, gp).
template <bool KAHAN>
__device__ __forceinline__ void slice_fold_n(
    const float* __restrict__ scratch, int n_blocks, int iters, int slices,
    int n, int gp, int idx, float* __restrict__ out,
    float* __restrict__ prof_out, const FoldCarry& fc = FoldCarry{nullptr, 1,
                                                                    1}) {
  const int items = n_blocks * slices, per = n + gp;
  const float* sums = scratch;
  const float* sprof = sums + static_cast<size_t>(items) * iters * n;
  if (idx >= n_blocks * per) return;
  const int b = idx / per, k = idx - b * per;
  if (k < n) {
    float s = 0.0f, c = 0.0f;
    float* cs = fc.carry == nullptr
                    ? nullptr
                    : fc.carry + 2 * (static_cast<size_t>(b) * n + k);
    if (!fc.first) {
      s = cs[0];
      c = cs[1];
    }
    for (int i = 0; i < iters; ++i) {
      const float* row =
          sums + (static_cast<size_t>(b) * iters + i) * slices * n + k;
      float t = row[0];
      for (int sl = 1; sl < slices; ++sl) t = __fadd_rn(t, row[sl * n]);
      if (KAHAN) {
        kahan_add(s, c, t);
      } else {
        s = __fadd_rn(s, t);
      }
    }
    if (fc.last) {
      out[static_cast<size_t>(b) * n + k] = __fadd_rn(s, c);
    } else {
      cs[0] = s;
      cs[1] = c;
    }
  } else {
    const float* col = sprof + static_cast<size_t>(b) * slices * gp + (k - n);
    float total = 0.0f;
    for (int sl = 0; sl < slices; ++sl) {
      total = __fadd_rn(total, col[static_cast<size_t>(sl) * gp]);
    }
    prof_out[static_cast<size_t>(b) * gp + (k - n)] = total;
  }
}

// slice_fold_n at a compile-time count of sums N, in one group.
template <int N, bool KAHAN>
__device__ __forceinline__ void slice_fold(const float* __restrict__ scratch,
                                           int n_blocks, int iters,
                                           int slices, int gp, int idx,
                                           float* __restrict__ out,
                                           float* __restrict__ prof_out) {
  slice_fold_n<KAHAN>(scratch, n_blocks, iters, slices, N, gp, idx, out,
                      prof_out);
}

// The split kernels that keep per-(block, iteration) rows in scratch until
// an ordered fold (K40, K43, K44, K8) bound it by a cap in floats: simulation
// blocks go in groups of `blocks`, each block taking `carry` floats (the
// fold's carry between groups) and `per_item` a (block, iteration) item;
// where one block with all its iterations exceeds the cap, one block goes
// at a time with its iterations in groups of `iters`.  The groups are
// balanced (their sizes differ by at most one block); the bits do not
// depend on them.
struct ScratchGroups {
  int blocks, iters;
  size_t total;  // floats of scratch a launch needs
};

inline ScratchGroups scratch_groups(int n_blocks, int iters, size_t carry,
                                    size_t per_item, size_t cap) {
  ScratchGroups G{};
  const size_t block = carry + per_item * iters;
  const size_t most = cap / block < 1 ? 1 : cap / block;
  const int fit = static_cast<int>(
      most < static_cast<size_t>(n_blocks) ? most : n_blocks);
  const int groups = (n_blocks + fit - 1) / fit;
  G.blocks = (n_blocks + groups - 1) / groups;
  G.iters = iters;
  if (block > cap) {
    const size_t room = cap > carry ? cap - carry : 0;
    const size_t it = room / per_item;
    G.iters = it < 1 ? 1 : (it < static_cast<size_t>(iters)
                                ? static_cast<int>(it) : iters);
  }
  G.total = G.blocks * (carry + per_item * G.iters);
  return G;
}

// The split walks (K10, K11, K12, K15, K19, K27, K29, K30):
// walk_split_kernel runs one thread per path element of every (simulation
// block, iteration) item on the unsplit kernel's key and counters and
// writes the element's N_OUT outputs (each the antithetic pair's mean
// under ANTI) to scratch [block][iteration][N_OUT][rows * 128];
// walk_fold_kernel, one CUDA block of the unsplit kernel's THREADS per
// simulation block, adds them in the unsplit kernel's order: thread t takes
// elements t, t + THREADS, .. of each iteration, either into its own Acc2
// over (iteration, element) and then write_block_sums' tree (PER_ITER
// false, one output: K11, K12, K15, K19, K27, K29) or, output k by output
// k, into v[2k], v[2k + 1] that BlockAccN reduces once per iteration
// (PER_ITER true: K30, K10 at 5 outputs, K20's Heston leg at 6, K34 at
// 2 + 2a).  Under PER_ITER output k's two sums go to the slots
// Walk::Slots names in the block's row (PairSlots, (2k, 2k + 1), unless
// the Walk declares others: K34 keeps add_greek_sums' row), and
// BlockAccN reduces each slot on its own, so the order of the slots does
// not touch the bits.
// So the block sums equal the unsplit kernel's bit for bit.  The scratch
// is grouped under WALK_SCRATCH_CAP by scratch_groups, the fold's carry
// (each thread's Acc2, or BlockAccN's slots) kept between the groups.
//
// A Walk provides Params (by value: pointers to its device operands and
// ints), SHARED (floats it stages a CUDA block), MIN_BLOCKS (its
// __launch_bounds__ occupancy), stage(P, sh) and either pay<ANTI>(P, sh,
// key, e) -> its one output or, where it declares N_OUT > 1 outputs an
// element, pay<ANTI>(P, sh, key, e, q) filling q[N_OUT] (the antithetic
// pair's mean 0.5 (q + m) under ANTI).
constexpr int WALK_SPLIT_THREADS = 128;  // a (rows, 128) tile's row
constexpr size_t WALK_SCRATCH_CAP = size_t{64} << 20;  // floats: 256 MB

// A group's items: simulation blocks b0 .. b0 + nb, iterations i0 .. i0 +
// ni of a launch of `iters`, n_elems elements an item.
struct WalkItems {
  uint32_t seed, off;
  int iters, n_elems, b0, nb, i0, ni;
};

// A Walk's outputs an element: its N_OUT where it declares one, else 1.
template <class Walk, class = void>
struct WalkOutputs {
  static constexpr int N = 1;
};
template <class Walk>
struct WalkOutputs<Walk, std::void_t<decltype(Walk::N_OUT)>> {
  static constexpr int N = Walk::N_OUT;
};

// The fold's slots of output k's (sum q, sum q^2) in a block's row: (2k,
// 2k + 1) unless the Walk declares Slots.
struct PairSlots {
  __host__ __device__ static constexpr int sum(int k) { return 2 * k; }
  __host__ __device__ static constexpr int sq(int k) { return 2 * k + 1; }
};
template <class Walk, class = void>
struct WalkSlots {
  using type = PairSlots;
};
template <class Walk>
struct WalkSlots<Walk, std::void_t<typename Walk::Slots>> {
  using type = typename Walk::Slots;
};

// Grid (nb * ni items, rows): CUDA block (item, row) walks the row's 128
// elements.
template <class Walk, bool ANTI>
__global__ void __launch_bounds__(WALK_SPLIT_THREADS, Walk::MIN_BLOCKS)
    walk_split_kernel(const typename Walk::Params P, const WalkItems I,
                      float* __restrict__ split) {
  __shared__ float sh[Walk::SHARED > 0 ? Walk::SHARED : 1];
  if (Walk::SHARED > 0) {
    Walk::stage(P, sh);
    __syncthreads();
  }
  const int item = blockIdx.x;
  const int bl = item / I.ni, il = item - bl * I.ni;
  const int e = blockIdx.y * WALK_SPLIT_THREADS + threadIdx.x;
  const Key key = seed_key(
      I.seed, (I.off + static_cast<uint32_t>(I.b0 + bl)) *
                      static_cast<uint32_t>(I.iters) +
                  static_cast<uint32_t>(I.i0 + il));
  constexpr int N_OUT = WalkOutputs<Walk>::N;
  float* dst = split + static_cast<size_t>(item) * N_OUT * I.n_elems + e;
  if constexpr (N_OUT == 1) {
    *dst = Walk::template pay<ANTI>(P, sh, key, static_cast<uint32_t>(e));
  } else {
    float q[N_OUT];
    Walk::template pay<ANTI>(P, sh, key, static_cast<uint32_t>(e), q);
#pragma unroll
    for (int k = 0; k < N_OUT; ++k) {
      dst[static_cast<size_t>(k) * I.n_elems] = q[k];
    }
  }
}

// Floats of a simulation block's fold carry between groups: BlockAccN's
// (s, c) of each of 2 N_OUT slots, or each thread's Acc2.
template <int THREADS, bool PER_ITER, int N_OUT = 1>
__host__ __device__ constexpr size_t walk_carry() {
  return PER_ITER ? 4 * static_cast<size_t>(N_OUT)
                  : 4 * static_cast<size_t>(THREADS);
}

// Loads a fold thread issues ahead of its adds.
constexpr int FOLD_BATCH = 8;

// Calls f(x) on elements t, t + THREADS, .. (< n) of each of the ni rows of
// n floats at rows, row by row and in that order, the loads issued
// FOLD_BATCH at a time ahead of the calls (across rows too).
template <int THREADS, class F>
__device__ __forceinline__ void fold_rows(const float* __restrict__ rows,
                                          int ni, int n, F&& f) {
  const int t = threadIdx.x;
  const int m = t < n ? (n - 1 - t) / THREADS + 1 : 0;  // elements a row
  const int total = ni * m;
  int il = 0, j = 0;  // the next load's row and element
  for (int k = 0; k < total; k += FOLD_BATCH) {
    float x[FOLD_BATCH];
#pragma unroll
    for (int u = 0; u < FOLD_BATCH; ++u) {
      x[u] = 0.0f;
      if (k + u < total) {
        x[u] = rows[static_cast<size_t>(il) * n + t + j * THREADS];
        if (++j == m) {
          j = 0;
          ++il;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < FOLD_BATCH; ++u) {
      if (k + u < total) f(x[u]);
    }
  }
}

// Simulation block b0 + blockIdx.x of a group of ni iterations; out is
// offset to b0's row (2 N_OUT sums a block, at Slots' places).
template <int THREADS, bool KAHAN, bool PER_ITER, int N_OUT = 1,
          class Slots = PairSlots>
__global__ void __launch_bounds__(THREADS)
    walk_fold_kernel(const float* __restrict__ split,
                     float* __restrict__ carry, int n_elems, int ni,
                     int first, int last, float* __restrict__ out) {
  static_assert(PER_ITER || N_OUT == 1, "one Acc2 a thread: one output");
  const int t = threadIdx.x;
  const float* items =
      split + static_cast<size_t>(blockIdx.x) * ni * N_OUT * n_elems;
  float* cb = carry + blockIdx.x * walk_carry<THREADS, PER_ITER, N_OUT>();
  if constexpr (PER_ITER) {
    constexpr int N = 2 * N_OUT;
    __shared__ float sh[(THREADS / 32) * N];
    BlockAccN<THREADS, N, KAHAN> acc;
    if (!first && t < N) {
      acc.s = cb[2 * t];
      acc.c = cb[2 * t + 1];
    }
    float v[N];
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = 0.0f;
    for (int il = 0; il < ni; ++il) {
#pragma unroll
      for (int k = 0; k < N_OUT; ++k) {
        fold_rows<THREADS>(
            items + (static_cast<size_t>(il) * N_OUT + k) * n_elems, 1,
            n_elems, [&](float p) {
              v[Slots::sum(k)] = __fadd_rn(v[Slots::sum(k)], p);
              v[Slots::sq(k)] = __fadd_rn(v[Slots::sq(k)], __fmul_rn(p, p));
            });
      }
      acc.add(v, nullptr, sh);
    }
    if (last) {
      acc.write(out);
    } else if (t < N) {
      cb[2 * t] = acc.s;
      cb[2 * t + 1] = acc.c;
    }
  } else {
    Acc2<KAHAN> acc;
    if (!first) {
      acc.s = cb[t];
      acc.c = cb[THREADS + t];
      acc.s2 = cb[2 * THREADS + t];
      acc.c2 = cb[3 * THREADS + t];
    }
    fold_rows<THREADS>(items, ni, n_elems, [&](float p) { acc.add(p); });
    if (last) {
      write_block_sums<THREADS, KAHAN>(acc, out);
    } else {
      cb[t] = acc.s;
      cb[THREADS + t] = acc.c;
      cb[2 * THREADS + t] = acc.s2;
      cb[3 * THREADS + t] = acc.c2;
    }
  }
}

// The groups of a split walk launch of N_OUT outputs an element (cap 0:
// WALK_SCRATCH_CAP floats).
template <int THREADS, bool PER_ITER, int N_OUT = 1>
inline ScratchGroups walk_groups(int n_blocks, int rows, int iters,
                                 size_t cap) {
  return scratch_groups(n_blocks, iters,
                        walk_carry<THREADS, PER_ITER, N_OUT>(),
                        static_cast<size_t>(rows) * LANES * N_OUT,
                        cap > 0 ? cap : WALK_SCRATCH_CAP);
}

// Every group in order, its split and then its fold, into out (n_blocks,
// 2 N_OUT); scratch holds walk_groups(..).total floats.  Returns a CUDA
// error.
template <class Walk, int THREADS, bool PER_ITER, bool ANTI, bool KAHAN>
int walk_split_launch(const typename Walk::Params& P, uint32_t seed,
                      uint32_t off, int n_blocks, int rows, int iters,
                      size_t cap, float* scratch, float* out,
                      cudaStream_t s) {
  constexpr int N_OUT = WalkOutputs<Walk>::N;
  const ScratchGroups G =
      walk_groups<THREADS, PER_ITER, N_OUT>(n_blocks, rows, iters, cap);
  const int n_elems = rows * LANES;
  float* carry = scratch;
  float* items =
      scratch + G.blocks * walk_carry<THREADS, PER_ITER, N_OUT>();
  for (int b0 = 0; b0 < n_blocks; b0 += G.blocks) {
    const int nb = n_blocks - b0 < G.blocks ? n_blocks - b0 : G.blocks;
    for (int i0 = 0; i0 < iters; i0 += G.iters) {
      const int ni = iters - i0 < G.iters ? iters - i0 : G.iters;
      const WalkItems I{seed, off, iters, n_elems, b0, nb, i0, ni};
      walk_split_kernel<Walk, ANTI><<<dim3(nb * ni, rows),
                                      WALK_SPLIT_THREADS, 0, s>>>(P, I,
                                                                  items);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      walk_fold_kernel<THREADS, KAHAN, PER_ITER, N_OUT,
                       typename WalkSlots<Walk>::type><<<nb, THREADS, 0,
                                                         s>>>(
          items, carry, n_elems, ni, i0 == 0, i0 + ni >= iters,
          out + 2 * N_OUT * static_cast<size_t>(b0));
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

// Adds one path's outputs q [S scalars, d.., v..] (the asset-major Greek
// kernels' scalars, two but for K44's seven, and A-vectors) to the
// per-thread sums, in the row order [p, p2, gr, gr2, .., d.., d2.., v..,
// v2..] that the port's split_vec reads.
template <int A, int S = 2>
__device__ __forceinline__ void add_greek_sums(const float (&q)[S + 2 * A],
                                               float (&v)[2 * S + 4 * A]) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    v[2 * k] += q[k];
    v[2 * k + 1] += q[k] * q[k];
  }
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const float d = q[S + i], w = q[S + A + i];
    v[2 * S + i] += d;
    v[2 * S + A + i] += d * d;
    v[2 * S + 2 * A + i] += w;
    v[2 * S + 3 * A + i] += w * w;
  }
}

// The antithetic pair's mean of each output, into q.
template <int A, int S = 2>
__device__ __forceinline__ void mirror_mean(float (&q)[S + 2 * A],
                                            const float (&m)[S + 2 * A]) {
#pragma unroll
  for (int j = 0; j < S + 2 * A; ++j) q[j] = 0.5f * (q[j] + m[j]);
}

}  // namespace mct
