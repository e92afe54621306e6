// K30-K35: the correlated multi-asset walks, basket-Asian and
// basket-barrier calls and their Greeks at every basket size.
//
// K30 replaces mctpu/kernels/multi_walk.py::_mw_am_kernel (<= 8 assets),
// K31 ::_mw_kernel (> 8 assets, lane-packed), K32 ::_mw_am_greeks_kernel
// (basket-Asian pathwise delta/vega vectors and rho), K33
// ::_mw_greeks_kernel (the same Greeks on K31's packed walk), K34
// ::_mw_am_bar_greeks_kernel (basket-barrier likelihood-ratio Greeks) and
// K35 ::_mw_bar_greeks_kernel (the same on K31's packed walk).
//
// Stream: per simulation block b and iteration i the key is reseeded with
// (seed, (off + b) * iters + i) in int32 wrap; the antithetic mirror
// replays it with the signs flipped, and the two mirrored outputs are
// averaged before they are summed.  Asset-major (K30, K32, K34): tile
// element e of a (rows, 128) tile is a path; pair jj draws Philox blocks
// (e, jj*A + i) for asset i (mct::walk_pairwise_multi), cosine branches for
// date 2jj, sine branches for date 2jj+1.  Packed (K31, K33, K35): the
// tile is (rows, width), element row*width + lane, path (row, p) owning
// lanes p*a_tile .. p*a_tile + a - 1; pair jj draws block (element, jj).
//
// Each date: x_i += drift_i + vol_i * bt_i, s_i = expf(x_i), basket B =
// sum_i w_i s_i, in mctpu's operand order: asset-major bt_i = d_i + sum_{j
// <= i} L_ij z_j (from d_i, j = 0..i), packed bt_i = (sum_{j <= i} L_ij z_j)
// + d_i (the product first).  The monitor is the Asian running sum,
// payoff max(sum B / n - k, 0), or the knock-out flag alive *= (B < H) up-
// and-out, (B > H) down-and-out, payoff alive * max(B_T - k, 0).  K32 and
// K33 add the tangents dxv_i += sqrt(dt) bt_i - v_i dt, AS_i += s_i, AV_i +=
// s_i dxv_i, tb += t_j B with t_j = dt (j + 1); K34 and K35 the scores q_m
// = sum_{j >= m} Linv[j, m] z_j, their first-date value, sum q and sum q
// (bt / v - sqrt(dt)) (mctpu's _am_greek_step, _greek_step_mw,
// _am_bar_greek_step and _bar_greek_step).  K33 and K35 write, beside their
// four scalar sums, the (4, width) lane rows (dval, dval^2, vval, vval^2)
// of each block: each iteration's column sums by mctpu's halving tree over
// the rows (det_col_sums), added in plain float32; the engine folds the
// packed groups onto the assets.
//
// This file is built with -fmad=false (mctpu_torch/_build.py): the knock-out
// compare and the in-the-money indicator are discontinuous, so each path must
// round as the plain PyTorch version's separate multiplies and adds do, or a
// path that grazes the barrier or the strike flips and a block sum moves by a
// whole payoff.  With the same libm expf/logf/sqrtf each path equals the
// plain version's to the bit; only the block sums' order differs.  K30, K32
// and K34 share am_core, the thread count and BlockAccN's reduction (K30's
// in its fold), so a Greek kernel's price sums equal K30's bit for bit
// wherever its payoff is formed the same way (the barrier; the Asian when
// 1/n_obs is a power of two, since K32 takes acc * (1/n) where K30 takes
// acc / n).
//
// Bound on the H100: arithmetic.  Per path-date: a/2 Philox blocks and
// Box-Muller pairs, a expf and the a(a+1)/2 multiply-adds of L z (twice
// that for K34's and K35's L^-1 z), each a separate multiply and add here;
// Philox's 32-bit multiplies (int32) bind K31 at 16 assets.
// K30 and K34 are split walks (mct::walk_split_kernel, csrc/common.cuh): one
// thread per path element of every (simulation block, iteration) item walks
// both signs of its path on one draw of each pair of dates, L (and K34's
// L^-1) and the per-asset rows staged in shared memory, and writes its payoff
// (K34: its 2 + 2a outputs); mct::walk_fold_kernel adds them in the simple
// design's order (am_threads<A>() threads a simulation block, BlockAccN per
// iteration; K34's 4 + 4a sums in add_greek_sums' row), so their block sums
// are that design's bit for bit.  The other kernels keep the simple design:
// one CUDA block per simulation block.  Asset-major (K32): one thread per path
// element striding over the tile, the walk state in registers, L and the
// per-asset rows in shared memory, per-iteration sums through mct::BlockAccN
// (4 + 4a of them).  Packed:
// one thread per packed path (Packed's passes, set_chunk_even for K31).  Up to
// 32 assets (a_tile 16 or 32) K31 keeps a path in its thread's registers: the
// thread draws its own path's normals for a pair of dates (its lanes' Philox
// blocks, the counters of the shared-memory design), the log-spots of both
// signs stay in registers, and L (four entries a shared load) and the step rows
// are staged once a block and read as broadcasts, in loops unrolled at the tile
// with i < a and j <= i predicates.  So no barrier and no shared-memory round
// trip remain in the walk, and a block's Philox and product phases overlap
// across its warps.  Its passes, thread-to-path map and sums are the
// shared-memory design's, so the block sums are the same bits (and K33's and
// K35's price sums still equal K31's).  K33 and K35 take the same register
// design at a_tile 16 and 32 (see mw_greeks_reg_kernel and
// mw_bar_greeks_reg_kernel), with K33's passes and halving tree.  Wider baskets
// (a_tile 64 and up, the 100-asset basket) do not fit a thread's registers: a
// pass keeps its log-spots in shared memory (asset-major over the pass's paths,
// so a warp's threads hit consecutive words), every pair of dates first draws
// the pass's normals into shared memory (draw_pass: one odd-strided row per
// path, padded lanes not drawn), then one thread per packed path forms the
// triangular product (L read through the read-only cache, every thread of a
// warp on the same entry) and the basket for both dates; the mirror's product
// is the negated sum of the same terms, exactly.  There the product's loads
// (one of L, one of z per multiply-add) and not the arithmetic hold the kernel
// well under its bound.  A pass walks every n_chunks-th row (see Packed), so
// that K33 and K35 add their lane rows pass by pass in the halving tree's own
// order: the tree's first levels inside a pass, its last over the passes, with
// only a pass's leaves and one partial row set a pass in shared memory.  K31
// takes as few passes as its threads and shared memory allow at any rows; K33
// and K35 need a power of two of rows a pass.  No atomics: two launches give
// the same bits.
#include <algorithm>

#include "common.cuh"
#include "packed.cuh"

namespace {

using mct::add_greek_sums;
using mct::bar_leaf_tree;
using mct::draw_pass;
using mct::fold_passes;
using mct::greek_shape;
using mct::halving_pair;
using mct::mirror_mean;
using mct::packed_base;
using mct::packed_shape;
using mct::pass_row;
using mct::pass_tree;
using mct::Packed;
using mct::PK_THREADS;
using mct::set_chunk_pow2;

constexpr int MAX_AM_ASSETS = 8;

// Threads of the asset-major kernels: one count for K30, K32 and K34 at a
// given A, so their price sums reduce alike; the wider Greek states get
// the larger register budget.
template <int A>
__host__ __device__ constexpr int am_threads() {
  return A <= 4 ? 512 : 256;
}

// One asset-major date (mctpu's _am_core): advances x[A] with the signed
// normals sgn * z, returns the basket value and the per-asset bt and spots.
// par rows (A each): log s0, drift, vol, d, w, ...
template <int A>
__device__ __forceinline__ float am_core(const float (&z)[A], float sgn,
                                         float (&x)[A], const float* lt,
                                         const float* par, float (&bt)[A],
                                         float (&s)[A]) {
  float basket = 0.0f;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    float b = par[3 * A + i];
#pragma unroll
    for (int j = 0; j <= i; ++j) b = b + lt[i * A + j] * (sgn * z[j]);
    const float xi = x[i] + par[A + i] + par[2 * A + i] * b;
    const float si = expf(xi);
    const float term = par[4 * A + i] * si;
    basket = (i == 0) ? term : basket + term;
    x[i] = xi;
    bt[i] = b;
    s[i] = si;
  }
  return basket;
}

__device__ __forceinline__ float knock(float alive, float basket, float h,
                                       bool up) {
  const bool in = up ? basket < h : basket > h;
  return alive * (in ? 1.0f : 0.0f);
}

// Loads n floats of src into the block's shared dst.
template <int THREADS>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int n) {
  for (int t = threadIdx.x; t < n; t += THREADS) dst[t] = src[t];
}

// The launch shape every kernel of this file takes.
struct Launch {
  int n_obs;
  uint32_t seed, off;
  int rows, iters;
};

__device__ __forceinline__ mct::Key iter_key(const Launch& g, int i) {
  return mct::seed_key(g.seed, (g.off + blockIdx.x) *
                                   static_cast<uint32_t>(g.iters) +
                               static_cast<uint32_t>(i));
}

// ------------------------------------------------------------ K30 (a <= 8)

// K30's split walk (mct::walk_split_kernel): both signs of tile element
// e's path advance on one draw of each pair of dates (am_core's sgn * z, as
// the unsplit walk forms it), and the element's payoff is their mean under
// ANTI.  lt and the per-asset rows are staged in shared memory.
struct AmParams {
  const float *lt, *par, *scal;
  int up, n_obs;
};

template <int A, bool BARRIER>
struct AmWalk {
  using Params = AmParams;
  static constexpr int SHARED = A * A + 5 * A;
  // CUDA blocks an SM: 64 warps at 32 registers (a = 1), 32 warps at 64
  // (a = 2, 3), 16 at 128 past them, where a = 8's state would spill at 64.
  static constexpr int MIN_BLOCKS = A == 1 ? 16 : A <= 3 ? 8 : 4;

  __device__ static void stage(const Params& P, float* sh) {
    for (int t = threadIdx.x; t < SHARED; t += blockDim.x) {
      sh[t] = t < A * A ? P.lt[t] : P.par[t - A * A];
    }
  }

  template <bool ANTI>
  __device__ static float pay(const Params& P, const float* sh, mct::Key key,
                              uint32_t e) {
    const float* lt = sh;
    const float* par = sh + A * A;
    const float k = P.scal[0], h = P.scal[1];
    const bool up = P.up != 0;
    float x[A], xm[A];
#pragma unroll
    for (int i = 0; i < A; ++i) x[i] = xm[i] = par[i];
    float acc = 0.0f, alive = 1.0f, last = 0.0f;
    float acc_m = 0.0f, alive_m = 1.0f, last_m = 0.0f;
    mct::walk_pairwise_multi<A>(key, e, P.n_obs,
                                [&](int, const float(&z)[A]) {
      float bt[A], s[A];
      const float basket = am_core<A>(z, 1.0f, x, lt, par, bt, s);
      if (BARRIER) {
        alive = knock(alive, basket, h, up);
        last = basket;
      } else {
        acc = acc + basket;
      }
      if (ANTI) {
        const float bm = am_core<A>(z, -1.0f, xm, lt, par, bt, s);
        if (BARRIER) {
          alive_m = knock(alive_m, bm, h, up);
          last_m = bm;
        } else {
          acc_m = acc_m + bm;
        }
      }
    });
    float p, pm = 0.0f;
    if (BARRIER) {
      p = alive * fmaxf(last - k, 0.0f);
      if (ANTI) pm = alive_m * fmaxf(last_m - k, 0.0f);
    } else {
      const float n = static_cast<float>(P.n_obs);
      p = fmaxf(acc / n - k, 0.0f);
      if (ANTI) pm = fmaxf(acc_m / n - k, 0.0f);
    }
    return ANTI ? 0.5f * (p + pm) : p;
  }
};

// K30's split walk and its fold (am_threads<A>() threads, BlockAccN per
// iteration: the order of the simple design's per-block kernel).
template <int A, bool ANTI, bool KAHAN, bool BARRIER>
int walk_am(const AmParams& P, const Launch& g, int n_blocks, size_t cap,
            float* scratch, float* out, cudaStream_t s) {
  return mct::walk_split_launch<AmWalk<A, BARRIER>, am_threads<A>(), true,
                                ANTI, KAHAN>(P, g.seed, g.off, n_blocks,
                                             g.rows, g.iters, cap, scratch,
                                             out, s);
}

template <int A>
int launch_walk_am(bool anti, bool kahan, bool barrier, const AmParams& P,
                   const Launch& g, int n_blocks, size_t cap, float* scratch,
                   float* out, cudaStream_t s) {
  using Fn = int (*)(const AmParams&, const Launch&, int, size_t, float*,
                     float*, cudaStream_t);
  static const Fn FNS[8] = {
      walk_am<A, false, false, false>, walk_am<A, false, false, true>,
      walk_am<A, false, true, false>,  walk_am<A, false, true, true>,
      walk_am<A, true, false, false>,  walk_am<A, true, false, true>,
      walk_am<A, true, true, false>,   walk_am<A, true, true, true>,
  };
  return FNS[(anti ? 4 : 0) | (kahan ? 2 : 0) | (barrier ? 1 : 0)](
      P, g, n_blocks, cap, scratch, out, s);
}

// ------------------------------------------------------- K32 (a <= 8)

// One Greek walk of tile element e and sign sgn; q gets [p, gr, d_0..,
// v_0..] (mctpu's _am_greek_payoff).  sc: k, t, 1/n, sqrt(dt), dt; par
// rows 5..7: v dt, w / n, 1 / s0.
template <int A>
__device__ __forceinline__ void am_greek_walk(const float* lt,
                                              const float* par,
                                              const float* sc, int n_obs,
                                              mct::Key key, uint32_t e,
                                              float sgn,
                                              float (&q)[2 + 2 * A]) {
  const float sqdt = sc[3], dt = sc[4];
  float x[A], dxv[A], as[A], av[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    x[i] = par[i];
    dxv[i] = as[i] = av[i] = 0.0f;
  }
  float acc = 0.0f, tb = 0.0f;
  mct::walk_pairwise_multi<A>(key, e, n_obs, [&](int j, const float(&z)[A]) {
    float bt[A], s[A];
    const float basket = am_core<A>(z, sgn, x, lt, par, bt, s);
#pragma unroll
    for (int i = 0; i < A; ++i) {
      dxv[i] = dxv[i] + sqdt * bt[i] - par[5 * A + i];
      as[i] = as[i] + s[i];
      av[i] = av[i] + s[i] * dxv[i];
    }
    const float tj = dt * (static_cast<float>(j) + 1.0f);
    acc = acc + basket;
    tb = tb + tj * basket;
  });
  const float k = sc[0], t = sc[1], inv_n = sc[2];
  const float abar = acc * inv_n;
  const float p = fmaxf(abar - k, 0.0f);
  const float ind = abar > k ? 1.0f : 0.0f;
  q[0] = p;
  q[1] = ind * (tb * inv_n) - t * p;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    q[2 + i] = ind * par[6 * A + i] * as[i] * par[7 * A + i];
    q[2 + A + i] = ind * par[6 * A + i] * av[i];
  }
}

template <int A, bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(am_threads<A>())
    mw_greeks_am_kernel(const float* __restrict__ scal,
                        const float* __restrict__ lt_g,
                        const float* __restrict__ par_g, Launch g,
                        float* __restrict__ out) {
  constexpr int THREADS = am_threads<A>();
  constexpr int N = 4 + 4 * A;
  __shared__ float lt[A * A], par[8 * A], sc[5], sh[(THREADS / 32) * N];
  stage<THREADS>(lt, lt_g, A * A);
  stage<THREADS>(par, par_g, 8 * A);
  stage<THREADS>(sc, scal, 5);
  __syncthreads();
  const int n_elems = g.rows * mct::LANES;
  mct::BlockAccN<THREADS, N, KAHAN> acc;
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = 0.0f;
  for (int i = 0; i < g.iters; ++i) {
    const mct::Key key = iter_key(g, i);
    for (int e = threadIdx.x; e < n_elems; e += THREADS) {
      const uint32_t u = static_cast<uint32_t>(e);
      float q[2 + 2 * A];
      am_greek_walk<A>(lt, par, sc, g.n_obs, key, u, 1.0f, q);
      if (ANTI) {
        float m[2 + 2 * A];
        am_greek_walk<A>(lt, par, sc, g.n_obs, key, u, -1.0f, m);
        mirror_mean<A>(q, m);
      }
      add_greek_sums<A>(q, v);
    }
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
}

template <int A>
void launch_greeks_am(bool anti, bool kahan, const float* scal,
                      const float* lt, const float* par, const Launch& g,
                      int n_blocks, float* out, cudaStream_t s) {
  using Fn = void (*)(const float*, const float*, const float*, Launch,
                      float*);
  static const Fn FNS[4] = {
      mw_greeks_am_kernel<A, false, false>, mw_greeks_am_kernel<A, false, true>,
      mw_greeks_am_kernel<A, true, false>, mw_greeks_am_kernel<A, true, true>};
  const Fn fn = FNS[(anti ? 2 : 0) | (kahan ? 1 : 0)];
  fn<<<n_blocks, am_threads<A>(), 0, s>>>(scal, lt, par, g, out);
}

// ------------------------------------------------------- K34 (a <= 8)

// K34 is a split walk (mct::walk_split_kernel): AmBarGreekWalk walks tile
// element e's path and writes its 2 + 2a outputs [p, gr, delta_0..,
// vega_0..] (mctpu's _am_bar_greek_payoff), the antithetic pair's mean
// under ANTI; mct::walk_fold_kernel adds them per iteration into
// add_greek_sums' row [p, p2, gr, gr2, d.., d2.., v.., v2..] (BarGreekSlots)
// at am_threads<A>() threads, the order of the simple design it replaced,
// so its block sums are that design's bit for bit.

// One sign's walk state: log-spots, the scores' first-date values, their
// sums and the vega sums, the knock-out flag and the last basket value.
template <int A>
struct BarGreekState {
  float x[A], qd[A], aq[A], av[A];
  float alive, last;

  __device__ __forceinline__ void init(const float* par) {
#pragma unroll
    for (int i = 0; i < A; ++i) {
      x[i] = par[i];
      qd[i] = aq[i] = av[i] = 0.0f;
    }
    alive = 1.0f;
    last = 0.0f;
  }

  // Date j on the normals sgn * z with the scores q (this sign's).  sc: k,
  // t, H, sqrt(dt); par rows 5..7: 1/v, 1/(s0 v sqrt(dt)), sqrt(dt)/v.
  __device__ __forceinline__ void date(int j, const float (&z)[A], float sgn,
                                       const float (&q)[A], const float* lt,
                                       const float* par, const float* sc,
                                       bool up) {
    float bt[A], s[A];
    const float basket = am_core<A>(z, sgn, x, lt, par, bt, s);
#pragma unroll
    for (int m = 0; m < A; ++m) {
      if (j == 0) qd[m] = q[m];
      aq[m] = aq[m] + q[m];
      av[m] = av[m] + q[m] * (bt[m] * par[5 * A + m] - sc[3]);
    }
    alive = knock(alive, basket, sc[2], up);
    last = basket;
  }

  // The path's [p, gr, delta_0.., vega_0..].
  __device__ __forceinline__ void pay(const float* par, const float* sc,
                                      int n_obs, float (&q)[2 + 2 * A]) const {
    const float k = sc[0], t = sc[1];
    const float p = alive * fmaxf(last - k, 0.0f);
    float score_r = aq[0] * par[7 * A];
#pragma unroll
    for (int m = 1; m < A; ++m) score_r = score_r + aq[m] * par[7 * A + m];
    q[0] = p;
    q[1] = p * score_r - t * p;
    const float n = static_cast<float>(n_obs);
#pragma unroll
    for (int m = 0; m < A; ++m) {
      q[2 + m] = p * qd[m] * par[6 * A + m];
      q[2 + A + m] = p * (av[m] - n * par[5 * A + m]);
    }
  }
};

// The scores q_m = sum_{j >= m} Linv[j, m] z_j of the draw z (the plus
// sign's; the mirror's are their negations, exactly: each product and sum
// of -z rounds to the negation, up to the sign of a zero, which no output
// reads but as a zero).
template <int A>
__device__ __forceinline__ void bar_scores(const float (&z)[A],
                                           const float* linv, float (&q)[A]) {
#pragma unroll
  for (int m = 0; m < A; ++m) {
    float qm = linv[m * A + m] * z[m];
#pragma unroll
    for (int jj = m + 1; jj < A; ++jj) qm = qm + linv[jj * A + m] * z[jj];
    q[m] = qm;
  }
}

// add_greek_sums' row: the two scalars' pairs first, then the deltas'
// sums, their squares, the vegas' sums and their squares.
template <int A>
struct BarGreekSlots {
  __host__ __device__ static constexpr int sum(int k) {
    return k < 2 ? 2 * k : k < 2 + A ? 2 + k : 2 + A + k;
  }
  __host__ __device__ static constexpr int sq(int k) {
    return k < 2 ? 2 * k + 1 : k < 2 + A ? 2 + A + k : 2 + 2 * A + k;
  }
};

struct BarGreekParams {
  const float *scal, *lt, *linv, *par;
  int up, n_obs;
};

// Both signs of a path a thread on one draw of each pair of dates, the
// mirror's am_core recomputed (bt starts from d_i, so it is no negation)
// and its scores negated.  (One (sign, path) item a thread, each drawing
// its path, came out 1.8-2.2x slower under antithetic at 3-8 assets on
// the H100: the draws bind, not the registers.)
template <int A, bool ANTI_>
struct AmBarGreekWalk {
  using Params = BarGreekParams;
  using Slots = BarGreekSlots<A>;
  static constexpr int N_OUT = 2 + 2 * A;
  static constexpr int SHARED = 2 * A * A + 8 * A + 4;
  // CUDA blocks an SM: one sign a thread, 32 warps at 64 registers up to 2
  // assets, 24 at 80 up to 4, 16 at 128 past them; both signs, 24 warps at
  // 80 up to 2 assets, 16 at 128 up to 6, 12 at 168 at 7 and 8, whose two
  // states spill at 128 (on the H100 12 warps were 3-4.5% slower at 6 and
  // 8 assets plain and at 6 antithetic, 8% faster at 8 antithetic).
  static constexpr int MIN_BLOCKS =
      ANTI_ ? (A <= 2 ? 6 : A <= 6 ? 4 : 3) : (A <= 2 ? 8 : A <= 4 ? 6 : 4);

  __device__ static void stage(const Params& P, float* sh) {
    for (int t = threadIdx.x; t < SHARED; t += blockDim.x) {
      sh[t] = t < A * A       ? P.lt[t]
              : t < 2 * A * A ? P.linv[t - A * A]
              : t < 2 * A * A + 8 * A ? P.par[t - 2 * A * A]
                                      : P.scal[t - 2 * A * A - 8 * A];
    }
  }

  template <bool ANTI>
  __device__ static void pay(const Params& P, const float* sh, mct::Key key,
                             uint32_t e, float (&q)[N_OUT]) {
    const float *lt = sh, *linv = sh + A * A, *par = sh + 2 * A * A;
    const float* sc = par + 8 * A;
    const bool up = P.up != 0;
    BarGreekState<A> st, mi;
    st.init(par);
    if (ANTI) mi.init(par);
    mct::walk_pairwise_multi<A>(key, e, P.n_obs,
                                [&](int j, const float(&z)[A]) {
      float qs[A];
      bar_scores<A>(z, linv, qs);
      st.date(j, z, 1.0f, qs, lt, par, sc, up);
      if (ANTI) {
#pragma unroll
        for (int m = 0; m < A; ++m) qs[m] = -qs[m];
        mi.date(j, z, -1.0f, qs, lt, par, sc, up);
      }
    });
    st.pay(par, sc, P.n_obs, q);
    if (ANTI) {
      float m[N_OUT];
      mi.pay(par, sc, P.n_obs, m);
      mirror_mean<A>(q, m);
    }
  }
};

// K34's split walk and its fold (am_threads<A>() threads, per iteration,
// add_greek_sums' row).
template <int A, bool ANTI, bool KAHAN>
int walk_bar_greeks_am(const BarGreekParams& P, const Launch& g,
                       int n_blocks, size_t cap, float* scratch, float* out,
                       cudaStream_t s) {
  return mct::walk_split_launch<AmBarGreekWalk<A, ANTI>, am_threads<A>(),
                                true, ANTI, KAHAN>(P, g.seed, g.off,
                                                   n_blocks, g.rows, g.iters,
                                                   cap, scratch, out, s);
}

template <int A>
int launch_bar_greeks_am(bool anti, bool kahan, const BarGreekParams& P,
                         const Launch& g, int n_blocks, size_t cap,
                         float* scratch, float* out, cudaStream_t s) {
  using Fn = int (*)(const BarGreekParams&, const Launch&, int, size_t,
                     float*, float*, cudaStream_t);
  static const Fn FNS[4] = {walk_bar_greeks_am<A, false, false>,
                            walk_bar_greeks_am<A, false, true>,
                            walk_bar_greeks_am<A, true, false>,
                            walk_bar_greeks_am<A, true, true>};
  return FNS[(anti ? 2 : 0) | (kahan ? 1 : 0)](P, g, n_blocks, cap, scratch,
                                                out, s);
}

// --------------------------------------------------------- K31 (a > 8)

// One date of packed path q for both signs: log-spots xs (and the mirror's
// xm) at stride np_max in shared memory, z its a normals.  Returns the
// basket values through b and bm.  par rows: log s0, drift, vol, d, w.
template <bool ANTI>
__device__ __forceinline__ void packed_date(const Packed& P,
                                            const float* __restrict__ lt,
                                            const float* __restrict__ par,
                                            const float* z, float* xs,
                                            float* xm, float& b, float& bm) {
  const int a = P.a;
  float basket = 0.0f, basket_m = 0.0f;
  for (int i = 0; i < a; ++i) {
    const float* lrow = lt + i * a;
    float sum = 0.0f;
    for (int j = 0; j <= i; ++j) sum = sum + __ldg(lrow + j) * z[j];
    const float drift = __ldg(par + a + i), vol = __ldg(par + 2 * a + i);
    const float d = __ldg(par + 3 * a + i), w = __ldg(par + 4 * a + i);
    const float x = xs[i * P.np_max] + drift + vol * (sum + d);
    xs[i * P.np_max] = x;
    basket = basket + expf(x) * w;
    if (ANTI) {
      // L (-z) is the negated sum of the same products, exactly.
      const float x2 = xm[i * P.np_max] + drift + vol * (-sum + d);
      xm[i * P.np_max] = x2;
      basket_m = basket_m + expf(x2) * w;
    }
  }
  b = basket;
  bm = basket_m;
}

template <bool ANTI, bool KAHAN, bool BARRIER>
__global__ void __launch_bounds__(PK_THREADS)
    mw_walk_packed_kernel(const float* __restrict__ lt,
                          const float* __restrict__ par,
                          const float* __restrict__ scal, int up, Packed P,
                          Launch g, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int np = P.np_max;
  float* z1s = smem;
  float* z2s = z1s + np * P.ap;
  float* xs = z2s + np * P.ap;
  float* xm = xs + np * P.a;  // the mirror's log-spots (ANTI)
  __shared__ float sh[(PK_THREADS / 32) * 2];
  const float k = scal[0], h = scal[1];
  const int q = threadIdx.x;
  mct::BlockAccN<PK_THREADS, 2, KAHAN> acc;
  float v[2] = {0.0f, 0.0f};
  for (int i = 0; i < g.iters; ++i) {
    const mct::Key key = iter_key(g, i);
    for (int c0 = 0; c0 < P.n_chunks; ++c0) {
      // A pass's last rows may lie past rows (set_chunk_even).
      const bool mine = q < np && pass_row(P, c0, q / P.c) < g.rows;
      for (int t = threadIdx.x; t < P.a * np; t += PK_THREADS) {
        const float x0 = __ldg(par + t / np);
        xs[t] = x0;
        if (ANTI) xm[t] = x0;
      }
      float m1 = 0.0f, alive = 1.0f, last = 0.0f;  // acc, or flag and B
      float m1m = 0.0f, alive_m = 1.0f, last_m = 0.0f;
      const int pairs = (g.n_obs + 1) / 2;
      for (int jj = 0; jj < pairs; ++jj) {
        draw_pass<PK_THREADS>(P, key, g.rows, c0, jj, z1s, z2s);
        __syncthreads();
        if (mine) {
          const int dates = min(2, g.n_obs - 2 * jj);
          for (int date = 0; date < dates; ++date) {
            const float* z = (date ? z2s : z1s) + q * P.ap;
            float b, bm;
            packed_date<ANTI>(P, lt, par, z, xs + q, xm + q, b, bm);
            if (BARRIER) {
              alive = knock(alive, b, h, up);
              last = b;
              if (ANTI) {
                alive_m = knock(alive_m, bm, h, up);
                last_m = bm;
              }
            } else {
              m1 = m1 + b;
              if (ANTI) m1m = m1m + bm;
            }
          }
        }
        __syncthreads();
      }
      if (mine) {
        const float n = static_cast<float>(g.n_obs);
        float pay = BARRIER ? alive * fmaxf(last - k, 0.0f)
                            : fmaxf(m1 / n - k, 0.0f);
        if (ANTI) {
          const float pm = BARRIER ? alive_m * fmaxf(last_m - k, 0.0f)
                                   : fmaxf(m1m / n - k, 0.0f);
          pay = 0.5f * (pay + pm);
        }
        v[0] += pay;
        v[1] += pay * pay;
      }
    }
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
}

// K31 at a_tile AT = 16 or 32 (9-32 assets): a path's normals and log-spots
// in its thread's registers.  The block stages L (rows at stride AT, zero
// above the diagonal) and the per-asset step rows once; every thread of a
// warp reads the same entry, a broadcast, L four entries a load, each
// load at its use (mct::lds4: held in registers for the whole walk, 136 + 64
// values at a_tile 16, they would spill the path's state).
constexpr int MW_REG_MAX = 32;

template <int AT>
struct RegOps {
  float4 l[AT * AT / 4];  // L[i][j] at i * AT + j
  float4 step[AT];        // drift, vol, d, w of asset i
  float x0[AT];           // log s0
};


// One date of a path for both signs (packed_date's operations in its
// order: sum = sum + L_ij z_j from j = 0, x + drift + vol (sum + d), basket
// + expf(x) w in asset order, the mirror's -sum), over registers.
template <int AT, bool ANTI>
__device__ __forceinline__ void reg_date(const RegOps<AT>& o, int a,
                                         const float (&z)[AT], float (&x)[AT],
                                         float (&xm)[AT], float& b,
                                         float& bm) {
  float basket = 0.0f, basket_m = 0.0f;
#pragma unroll
  for (int i = 0; i < AT; ++i) {
    if (i < a) {
      float sum = 0.0f;
#pragma unroll
      for (int q = 0; 4 * q <= i; ++q) {
        const float4 l4 = mct::lds4(&o.l[i * (AT / 4) + q]);
        sum = sum + l4.x * z[4 * q];
        if (4 * q + 1 <= i) sum = sum + l4.y * z[4 * q + 1];
        if (4 * q + 2 <= i) sum = sum + l4.z * z[4 * q + 2];
        if (4 * q + 3 <= i) sum = sum + l4.w * z[4 * q + 3];
      }
      const float4 st = mct::lds4(&o.step[i]);
      x[i] = x[i] + st.x + st.y * (sum + st.z);
      basket = basket + expf(x[i]) * st.w;
      if (ANTI) {
        xm[i] = xm[i] + st.x + st.y * (-sum + st.z);
        basket_m = basket_m + expf(xm[i]) * st.w;
      }
    }
  }
  b = basket;
  bm = basket_m;
}

// The same thread-to-path map, passes and sums as mw_walk_packed_kernel
// (thread q walks path q % c of local row q / c), so the block sums are
// that kernel's bit for bit; each thread draws its own path's normals
// (element row * width + p * AT + m, pair jj), with no barrier in the walk.
template <int AT, bool ANTI, bool KAHAN, bool BARRIER>
__global__ void __launch_bounds__(PK_THREADS, AT <= 16 ? 2 : 1)
    mw_walk_reg_kernel(const float* __restrict__ lt,
                       const float* __restrict__ par,
                       const float* __restrict__ scal, int up, Packed P,
                       Launch g, float* __restrict__ out) {
  __shared__ RegOps<AT> o;
  __shared__ float sh[(PK_THREADS / 32) * 2];
  const int a = P.a;
  float* lf = reinterpret_cast<float*>(o.l);
  for (int t = threadIdx.x; t < AT * AT; t += PK_THREADS) {
    const int i = t / AT, j = t - i * AT;
    lf[t] = (i < a && j <= i) ? lt[i * a + j] : 0.0f;
  }
  float* sf = reinterpret_cast<float*>(o.step);
  for (int t = threadIdx.x; t < 4 * AT; t += PK_THREADS) {
    const int i = t / 4;
    sf[t] = i < a ? par[(t - 4 * i + 1) * a + i] : 0.0f;
  }
  for (int t = threadIdx.x; t < AT; t += PK_THREADS) {
    o.x0[t] = t < a ? par[t] : 0.0f;
  }
  __syncthreads();
  const float k = scal[0], h = scal[1];
  const int q = threadIdx.x;
  const int pairs = (g.n_obs + 1) / 2;
  mct::BlockAccN<PK_THREADS, 2, KAHAN> acc;
  float v[2] = {0.0f, 0.0f};
  for (int it = 0; it < g.iters; ++it) {
    const mct::Key key = iter_key(g, it);
    for (int c0 = 0; c0 < P.n_chunks; ++c0) {
      const int row = pass_row(P, c0, q / P.c);
      if (q >= P.np_max || row >= g.rows) continue;
      const uint32_t e0 =
          static_cast<uint32_t>(row * P.width + (q % P.c) * AT);
      float x[AT], xm[AT];
#pragma unroll
      for (int i = 0; i < AT; ++i) x[i] = xm[i] = mct::lds1(&o.x0[i]);
      float m1 = 0.0f, alive = 1.0f, last = 0.0f;  // acc, or flag and B
      float m1m = 0.0f, alive_m = 1.0f, last_m = 0.0f;
      for (int jj = 0; jj < pairs; ++jj) {
        float z[2][AT];
#pragma unroll
        for (int m = 0; m < AT; ++m) {
          if (m < a) {
            mct::draw_normal_pair(key, e0 + m, static_cast<uint32_t>(jj),
                                  z[0][m], z[1][m]);
          }
        }
        const int dates = min(2, g.n_obs - 2 * jj);
#pragma unroll
        for (int date = 0; date < 2; ++date) {
          if (date >= dates) break;
          float b, bm;
          reg_date<AT, ANTI>(o, a, z[date], x, xm, b, bm);
          if (BARRIER) {
            alive = knock(alive, b, h, up);
            last = b;
            if (ANTI) {
              alive_m = knock(alive_m, bm, h, up);
              last_m = bm;
            }
          } else {
            m1 = m1 + b;
            if (ANTI) m1m = m1m + bm;
          }
        }
      }
      const float n = static_cast<float>(g.n_obs);
      float pay = BARRIER ? alive * fmaxf(last - k, 0.0f)
                          : fmaxf(m1 / n - k, 0.0f);
      if (ANTI) {
        const float pm = BARRIER ? alive_m * fmaxf(last_m - k, 0.0f)
                                 : fmaxf(m1m / n - k, 0.0f);
        pay = 0.5f * (pay + pm);
      }
      v[0] += pay;
      v[1] += pay * pay;
    }
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
}

template <int AT>
int launch_walk_reg(bool anti, bool kahan, bool barrier, const float* lt,
                    const float* par, const float* scal, int up,
                    const Packed& P, const Launch& g, int n_blocks,
                    float* out, cudaStream_t s) {
  using Fn = void (*)(const float*, const float*, const float*, int, Packed,
                      Launch, float*);
  static const Fn FNS[8] = {
      mw_walk_reg_kernel<AT, false, false, false>,
      mw_walk_reg_kernel<AT, false, false, true>,
      mw_walk_reg_kernel<AT, false, true, false>,
      mw_walk_reg_kernel<AT, false, true, true>,
      mw_walk_reg_kernel<AT, true, false, false>,
      mw_walk_reg_kernel<AT, true, false, true>,
      mw_walk_reg_kernel<AT, true, true, false>,
      mw_walk_reg_kernel<AT, true, true, true>,
  };
  const Fn fn = FNS[(anti ? 4 : 0) | (kahan ? 2 : 0) | (barrier ? 1 : 0)];
  fn<<<n_blocks, PK_THREADS, 0, s>>>(lt, par, scal, up, P, g, out);
  return 0;
}

int launch_walk_packed(bool anti, bool kahan, bool barrier, const float* lt,
                       const float* par, const float* scal, int up,
                       const Packed& P, size_t smem, const Launch& g,
                       int n_blocks, float* out, cudaStream_t s) {
  if (P.a_tile == 16) {
    return launch_walk_reg<16>(anti, kahan, barrier, lt, par, scal, up, P, g,
                               n_blocks, out, s);
  }
  if (P.a_tile == MW_REG_MAX) {
    return launch_walk_reg<MW_REG_MAX>(anti, kahan, barrier, lt, par, scal,
                                       up, P, g, n_blocks, out, s);
  }
  using Fn = void (*)(const float*, const float*, const float*, int, Packed,
                      Launch, float*);
  static const Fn FNS[8] = {
      mw_walk_packed_kernel<false, false, false>,
      mw_walk_packed_kernel<false, false, true>,
      mw_walk_packed_kernel<false, true, false>,
      mw_walk_packed_kernel<false, true, true>,
      mw_walk_packed_kernel<true, false, false>,
      mw_walk_packed_kernel<true, false, true>,
      mw_walk_packed_kernel<true, true, false>,
      mw_walk_packed_kernel<true, true, true>,
  };
  const Fn fn = FNS[(anti ? 4 : 0) | (kahan ? 2 : 0) | (barrier ? 1 : 0)];
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<n_blocks, PK_THREADS, smem, s>>>(lt, par, scal, up, P, g, out);
  return 0;
}

// --------------------------------------------------------- K33 (a > 8)

// K33 at a_tile 64 and up (at 16 and 32: mw_greeks_reg_kernel below).
// Its block keeps in shared memory, per pass: both dates' normals (2 np
// ap), per asset and path the log-spot x, the tangent dxv, the spot sum AS
// and the S dxv sum AV (and the mirror's four), then per pass the (dval,
// dval^2, vval, vval^2) lane rows its rows add up to ([n_chunks][4][width])
// and the block's running lane rows ([4][width]).  After a pass's walk its
// (dval, vval) leaves ([2][chunk_rows][width]) take the place of the
// normals, x and dxv, which span at least as many floats (ap + a >=
// a_tile).  acc and tb stay in the path's thread.  greek_shape's lane
// floats: x, dxv, AS, AV of each sign.
constexpr int K33_LANE_FLOATS = 4;

// One date of K33's walk for packed path q and both signs (state pointers
// at q, stride np_max): bt = L z + d, x += drift + vol bt, dxv += sqrt(dt)
// bt - v dt, s = expf(x), B += s w, AS += s, AV += s dxv (mctpu's
// _greek_step_mw).  x and B round as packed_date's.  par rows: log s0,
// drift, vol, d, w, v dt, 1/s0.
template <bool ANTI>
__device__ __forceinline__ void packed_greek_date(
    const Packed& P, const float* __restrict__ lt,
    const float* __restrict__ par, float sqdt, const float* z,
    float* const* st, float& b, float& bm) {
  const int a = P.a, np = P.np_max;
  float basket = 0.0f, basket_m = 0.0f;
  for (int i = 0; i < a; ++i) {
    const float* lrow = lt + i * a;
    float sum = 0.0f;
    for (int j = 0; j <= i; ++j) sum = sum + __ldg(lrow + j) * z[j];
    const float drift = __ldg(par + a + i), vol = __ldg(par + 2 * a + i);
    const float d = __ldg(par + 3 * a + i), w = __ldg(par + 4 * a + i);
    const float vdt = __ldg(par + 5 * a + i);
    const int o = i * np;
#pragma unroll
    for (int sgn = 0; sgn < (ANTI ? 2 : 1); ++sgn) {
      float* const* S = st + 4 * sgn;  // x, dxv, AS, AV of this sign
      const float bt = (sgn ? -sum : sum) + d;
      const float x = S[0][o] + drift + vol * bt;
      S[0][o] = x;
      const float dxv = S[1][o] + sqdt * bt - vdt;
      S[1][o] = dxv;
      const float s = expf(x);
      if (sgn) {
        basket_m = basket_m + s * w;
      } else {
        basket = basket + s * w;
      }
      S[2][o] = S[2][o] + s;
      S[3][o] = S[3][o] + s * dxv;
    }
  }
  b = basket;
  bm = basket_m;
}

template <bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(PK_THREADS)
    mw_greeks_packed_kernel(const float* __restrict__ scal,
                            const float* __restrict__ tj,
                            const float* __restrict__ lt,
                            const float* __restrict__ par, Packed P, Launch g,
                            float* __restrict__ out,
                            float* __restrict__ vecs) {
  extern __shared__ float smem[];
  const int np = P.np_max, a = P.a, W = P.width, nr = P.chunk_rows;
  constexpr int NS = ANTI ? 2 : 1;  // signs
  float* z1s = smem;
  float* z2s = z1s + np * P.ap;
  float* walk = z2s + np * P.ap;     // x, dxv of each sign
  float* sums = walk + 2 * NS * a * np;  // AS, AV of each sign
  float* st[4 * NS];  // x, dxv, AS, AV; the mirror's x, dxv, AS, AV
  for (int sgn = 0; sgn < NS; ++sgn) {
    st[4 * sgn] = walk + 2 * sgn * a * np;
    st[4 * sgn + 1] = walk + (2 * sgn + 1) * a * np;
    st[4 * sgn + 2] = sums + 2 * sgn * a * np;
    st[4 * sgn + 3] = sums + (2 * sgn + 1) * a * np;
  }
  float* part = sums + 2 * NS * a * np;   // [n_chunks][4][W]
  float* vec = part + 4 * P.n_chunks * W;  // [4][W]
  float* leaf = smem;  // [2][nr][W], per pass, over the normals and walk
  __shared__ float sh[(PK_THREADS / 32) * 4];
  const float k = scal[0], t = scal[1], inv_n = scal[2], sqdt = scal[3];
  for (int u = threadIdx.x; u < 4 * W; u += PK_THREADS) vec[u] = 0.0f;
  const int q = threadIdx.x;
  mct::BlockAccN<PK_THREADS, 4, KAHAN> acc;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < g.iters; ++i) {
    const mct::Key key = iter_key(g, i);
    for (int c0 = 0; c0 < P.n_chunks; ++c0) {
      for (int u = threadIdx.x; u < a * np; u += PK_THREADS) {
        const float x0 = __ldg(par + u / np);
#pragma unroll
        for (int sgn = 0; sgn < NS; ++sgn) {
          st[4 * sgn][u] = x0;
          st[4 * sgn + 1][u] = 0.0f;
          st[4 * sgn + 2][u] = 0.0f;
          st[4 * sgn + 3][u] = 0.0f;
        }
      }
      float m1 = 0.0f, tb = 0.0f, m1m = 0.0f, tbm = 0.0f;
      const int pairs = (g.n_obs + 1) / 2;
      for (int jj = 0; jj < pairs; ++jj) {
        draw_pass<PK_THREADS>(P, key, g.rows, c0, jj, z1s, z2s);
        __syncthreads();
        if (q < np) {
          float* sq[4 * NS];  // this path's state
          for (int u = 0; u < 4 * NS; ++u) sq[u] = st[u] + q;
          const int dates = min(2, g.n_obs - 2 * jj);
          for (int date = 0; date < dates; ++date) {
            const float* z = (date ? z2s : z1s) + q * P.ap;
            const float tjv = __ldg(tj + 2 * jj + date);
            float b, bm;
            packed_greek_date<ANTI>(P, lt, par, sqdt, z, sq, b, bm);
            m1 = m1 + b;
            tb = tb + tjv * b;
            if (ANTI) {
              m1m = m1m + bm;
              tbm = tbm + tjv * bm;
            }
          }
        }
        __syncthreads();
      }
      // The payoff, rho and the (dval, vval) leaves of each path's lanes
      // (mctpu's _greek_payoff_mw); padded lanes get exact zeros.
      if (q < np) {
        const float abar = m1 * inv_n;
        float p = fmaxf(abar - k, 0.0f);
        const float ind = abar > k ? 1.0f : 0.0f;
        float gr = ind * (tb * inv_n) - t * p;
        float ind_m = 0.0f;
        if (ANTI) {
          const float abar_m = m1m * inv_n;
          const float pm = fmaxf(abar_m - k, 0.0f);
          ind_m = abar_m > k ? 1.0f : 0.0f;
          const float grm = ind_m * (tbm * inv_n) - t * pm;
          p = 0.5f * (p + pm);
          gr = 0.5f * (gr + grm);
        }
        v[0] += p;
        v[1] += p * p;
        v[2] += gr;
        v[3] += gr * gr;
        const int rl = q / P.c;
        const int lane0 = (q - rl * P.c) * P.a_tile;
        float* ld = leaf + rl * W + lane0;
        float* lv = leaf + (nr + rl) * W + lane0;
        for (int m = 0; m < P.a_tile; ++m) {
          float dval = 0.0f, vval = 0.0f;
          if (m < a) {
            const float w = __ldg(par + 4 * a + m);
            const float inv_s0 = __ldg(par + 6 * a + m);
            const int o = m * np + q;
            const float wiv = ind * w * inv_n;
            dval = wiv * st[2][o] * inv_s0;
            vval = wiv * st[3][o];
            if constexpr (ANTI) {
              const float wiv_m = ind_m * w * inv_n;
              dval = 0.5f * (dval + wiv_m * st[6][o] * inv_s0);
              vval = 0.5f * (vval + wiv_m * st[7][o]);
            }
          }
          ld[m] = dval;
          lv[m] = vval;
        }
      }
      __syncthreads();
      pass_tree(P, c0, leaf, part);
      __syncthreads();
    }
    fold_passes(P, part, vec);
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
  for (int u = threadIdx.x; u < 4 * W; u += PK_THREADS) {
    vecs[static_cast<size_t>(blockIdx.x) * 4 * W + u] = vec[u];
  }
}

// K33 at a_tile AT = 16 or 32 (9-32 assets): K31's register design with
// K33's tangents.  The block stages L (rows at stride AT, zero above the
// diagonal) and the per-asset rows once, read as broadcasts at their use
// (mct::lds4 / lds1, as K31's and K35's).
template <int AT>
struct RegAsianGreekOps {
  float4 l[AT * AT / 4];  // L[i][j] at i * AT + j, zero above the diagonal
  float4 step[AT];        // drift, vol, d, w of asset i
  float4 tan[AT];         // v dt, 1/s0, log s0 (and a zero) of asset i
};

// One pair of dates (the second where two) of a path for both signs,
// packed_greek_date's operations in its order for each date: x and dxv (and
// the mirror's, whose dxv is not the negation of the path's: its step is
// sqrt(dt) (d - sum) - v dt) in registers, AS and AV of each sign in the
// shared slots s[m np] (the path's, then the mirror's AS and AV at s + a
// np, 2 a np, 3 a np).  An asset's dates depend on each other only through
// its own x, dxv, AS and AV, so each asset takes both dates in turn: its L
// row and step rows are read once a pair, its slots loaded and stored once
// a pair, and each date's basket b[date] still adds the assets in order.
template <int AT, bool ANTI>
__device__ __forceinline__ void reg_greek_pair(
    const RegAsianGreekOps<AT>& o, int a, int np, float sqdt, bool two,
    const float (&z)[2][AT], float (&x)[AT], float (&dx)[AT],
    float (&xm)[AT], float (&dxm)[AT], float* s, float (&b)[2],
    float (&bm)[2]) {
  b[0] = b[1] = bm[0] = bm[1] = 0.0f;
  const int an = a * np;
#pragma unroll
  for (int i = 0; i < AT; ++i) {
    if (i < a) {
      float* si = s + i * np;
      float as = si[0], av = si[an];
      float as_m = ANTI ? si[2 * an] : 0.0f, av_m = ANTI ? si[3 * an] : 0.0f;
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int q = 0; 4 * q <= i; ++q) {
        const float4 l4 = mct::lds4(&o.l[i * (AT / 4) + q]);
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          if (d == 0 || two) {
            sum[d] = sum[d] + l4.x * z[d][4 * q];
            if (4 * q + 1 <= i) sum[d] = sum[d] + l4.y * z[d][4 * q + 1];
            if (4 * q + 2 <= i) sum[d] = sum[d] + l4.z * z[d][4 * q + 2];
            if (4 * q + 3 <= i) sum[d] = sum[d] + l4.w * z[d][4 * q + 3];
          }
        }
      }
      const float4 st = mct::lds4(&o.step[i]);
      const float vdt = mct::lds1(&o.tan[i].x);
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        if (d == 0 || two) {
          const float bt = sum[d] + st.z;
          x[i] = x[i] + st.x + st.y * bt;
          dx[i] = dx[i] + sqdt * bt - vdt;
          const float e = expf(x[i]);
          b[d] = b[d] + e * st.w;
          as = as + e;
          av = av + e * dx[i];
          if (ANTI) {
            const float btm = -sum[d] + st.z;
            xm[i] = xm[i] + st.x + st.y * btm;
            dxm[i] = dxm[i] + sqdt * btm - vdt;
            const float em = expf(xm[i]);
            bm[d] = bm[d] + em * st.w;
            as_m = as_m + em;
            av_m = av_m + em * dxm[i];
          }
        }
      }
      si[0] = as;
      si[an] = av;
      if (ANTI) {
        si[2 * an] = as_m;
        si[3 * an] = av_m;
      }
    }
  }
}

// mw_greeks_packed_kernel's passes (greek_shape), thread-to-path map,
// payoff, rho, leaves, halving tree and sums, so out and vecs are that
// kernel's bit for bit; each thread draws its own path's normals (element
// row * width + p * AT + m, pair jj) and no barrier remains in the walk.
// Shared memory: per lane and path the slots of AS and AV of each sign
// ([2 NS][a][np]); after the walk the path's dval and vval leaves take the
// places of its AS and AV, where bar_leaf_tree reads them (pass_tree's
// levels in its order over that layout; padded lanes sum to exact zeros, as
// pass_tree's over the zeros the parent writes there); then part and vec as
// there.
template <int AT, bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(PK_THREADS, AT <= 16 ? 2 : 1)
    mw_greeks_reg_kernel(const float* __restrict__ scal,
                         const float* __restrict__ tj,
                         const float* __restrict__ lt,
                         const float* __restrict__ par, Packed P, Launch g,
                         float* __restrict__ out, float* __restrict__ vecs) {
  extern __shared__ float smem[];
  __shared__ RegAsianGreekOps<AT> o;
  __shared__ float sh[(PK_THREADS / 32) * 4];
  constexpr int NS = ANTI ? 2 : 1;  // signs
  const int np = P.np_max, a = P.a, W = P.width;
  float* ld = smem;                         // [a][np]: AS, then dval
  float* lv = ld + a * np;                  // [a][np]: AV, then vval
  float* part = smem + 2 * NS * a * np;     // [n_chunks][4][W]
  float* vec = part + 4 * P.n_chunks * W;   // [4][W]
  float* lf = reinterpret_cast<float*>(o.l);
  for (int t = threadIdx.x; t < AT * AT; t += PK_THREADS) {
    const int i = t / AT, j = t - i * AT;
    lf[t] = (i < a && j <= i) ? lt[i * a + j] : 0.0f;
  }
  float* sf = reinterpret_cast<float*>(o.step);
  float* tf = reinterpret_cast<float*>(o.tan);
  for (int t = threadIdx.x; t < 4 * AT; t += PK_THREADS) {
    const int i = t / 4, r = t - 4 * i;
    sf[t] = i < a ? par[(r + 1) * a + i] : 0.0f;
    tf[t] = i < a && r < 3 ? par[(r < 2 ? r + 5 : 0) * a + i] : 0.0f;
  }
  for (int u = threadIdx.x; u < 4 * W; u += PK_THREADS) vec[u] = 0.0f;
  __syncthreads();
  const float k = scal[0], t = scal[1], inv_n = scal[2], sqdt = scal[3];
  const int q = threadIdx.x;
  const int pairs = (g.n_obs + 1) / 2;
  mct::BlockAccN<PK_THREADS, 4, KAHAN> acc;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int it = 0; it < g.iters; ++it) {
    const mct::Key key = iter_key(g, it);
    for (int c0 = 0; c0 < P.n_chunks; ++c0) {
      if (q < np) {
        const int row = pass_row(P, c0, q / P.c);
        const uint32_t e0 =
            static_cast<uint32_t>(row * W + (q % P.c) * AT);
        float* sq = ld + q;  // this path's slots
        float x[AT], dx[AT], xm[AT], dxm[AT];
#pragma unroll
        for (int i = 0; i < AT; ++i) {
          x[i] = xm[i] = mct::lds1(&o.tan[i].z);
          dx[i] = dxm[i] = 0.0f;
          if (i < a) {
#pragma unroll
            for (int r = 0; r < 2 * NS; ++r) sq[(r * a + i) * np] = 0.0f;
          }
        }
        float m1 = 0.0f, tb = 0.0f, m1m = 0.0f, tbm = 0.0f;
        for (int jj = 0; jj < pairs; ++jj) {
          float z[2][AT];
#pragma unroll
          for (int m = 0; m < AT; ++m) {
            if (m < a) {
              mct::draw_normal_pair(key, e0 + m, static_cast<uint32_t>(jj),
                                    z[0][m], z[1][m]);
            } else {
              z[0][m] = z[1][m] = 0.0f;
            }
          }
          const int dates = min(2, g.n_obs - 2 * jj);
          float b[2], bm[2];
          reg_greek_pair<AT, ANTI>(o, a, np, sqdt, dates == 2, z, x, dx, xm,
                                   dxm, sq, b, bm);
#pragma unroll
          for (int date = 0; date < 2; ++date) {
            if (date >= dates) break;
            const float tjv = __ldg(tj + 2 * jj + date);
            m1 = m1 + b[date];
            tb = tb + tjv * b[date];
            if (ANTI) {
              m1m = m1m + bm[date];
              tbm = tbm + tjv * bm[date];
            }
          }
        }
        // The payoff, rho and the (dval, vval) leaves (mctpu's
        // _greek_payoff_mw), in mw_greeks_packed_kernel's operations.
        const float abar = m1 * inv_n;
        float p = fmaxf(abar - k, 0.0f);
        const float ind = abar > k ? 1.0f : 0.0f;
        float gr = ind * (tb * inv_n) - t * p;
        float ind_m = 0.0f;
        if (ANTI) {
          const float abar_m = m1m * inv_n;
          const float pm = fmaxf(abar_m - k, 0.0f);
          ind_m = abar_m > k ? 1.0f : 0.0f;
          const float grm = ind_m * (tbm * inv_n) - t * pm;
          p = 0.5f * (p + pm);
          gr = 0.5f * (gr + grm);
        }
        v[0] += p;
        v[1] += p * p;
        v[2] += gr;
        v[3] += gr * gr;
        const int an = a * np;
#pragma unroll
        for (int m = 0; m < AT; ++m) {
          if (m < a) {
            const float w = mct::lds1(&o.step[m].w);
            const float inv_s0 = mct::lds1(&o.tan[m].y);
            float* sm = sq + m * np;
            const float wiv = ind * w * inv_n;
            float dval = wiv * sm[0] * inv_s0;
            float vval = wiv * sm[an];
            if (ANTI) {
              const float wiv_m = ind_m * w * inv_n;
              dval = 0.5f * (dval + wiv_m * sm[2 * an] * inv_s0);
              vval = 0.5f * (vval + wiv_m * sm[3 * an]);
            }
            sm[0] = dval;
            sm[an] = vval;
          }
        }
      }
      __syncthreads();
      bar_leaf_tree(P, c0, ld, lv, part);
      __syncthreads();
    }
    fold_passes(P, part, vec);
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
  for (int u = threadIdx.x; u < 4 * W; u += PK_THREADS) {
    vecs[static_cast<size_t>(blockIdx.x) * 4 * W + u] = vec[u];
  }
}

// --------------------------------------------------------- K35 (a > 8)

// One date of K35's walk for packed path q and both signs (state pointers
// at q, stride np_max: x, qd, acc_q, acc_v): bt = L z + d, q = z L^-1 (q_m
// = sum_{j >= m} Linv[j, m] z_j, from 0), x += drift + vol bt, qd = q at
// the first date, acc_q += q, acc_v += q (bt inv_v - sqrt(dt)), s =
// expf(x), B += s w (mctpu's _bar_greek_step).  x and B round as
// packed_date's; the mirror's products are the negated sums.  par rows:
// log s0, drift, vol, d, w, inv_v, cd, sr.
template <bool ANTI>
__device__ __forceinline__ void packed_bar_greek_date(
    const Packed& P, const float* __restrict__ lt,
    const float* __restrict__ linv, const float* __restrict__ par,
    float sqdt, bool first, const float* z, float* const* st, float& b,
    float& bm) {
  const int a = P.a, np = P.np_max;
  float basket = 0.0f, basket_m = 0.0f;
  for (int i = 0; i < a; ++i) {
    const float* lrow = lt + i * a;
    float sum = 0.0f;
    for (int j = 0; j <= i; ++j) sum = sum + __ldg(lrow + j) * z[j];
    float qs = 0.0f;
    for (int j = i; j < a; ++j) qs = qs + __ldg(linv + j * a + i) * z[j];
    const float drift = __ldg(par + a + i), vol = __ldg(par + 2 * a + i);
    const float d = __ldg(par + 3 * a + i), w = __ldg(par + 4 * a + i);
    const float inv_v = __ldg(par + 5 * a + i);
    const int o = i * np;
#pragma unroll
    for (int sgn = 0; sgn < (ANTI ? 2 : 1); ++sgn) {
      float* const* S = st + 4 * sgn;  // x, qd, acc_q, acc_v of this sign
      const float bt = (sgn ? -sum : sum) + d;
      const float q = sgn ? -qs : qs;
      const float x = S[0][o] + drift + vol * bt;
      S[0][o] = x;
      if (first) S[1][o] = q;
      S[2][o] = S[2][o] + q;
      S[3][o] = S[3][o] + q * (bt * inv_v - sqdt);
      const float s = expf(x);
      if (sgn) {
        basket_m = basket_m + s * w;
      } else {
        basket = basket + s * w;
      }
    }
  }
  b = basket;
  bm = basket_m;
}

// K35 at a_tile 64 and up: K33's passes, shared memory and halving tree
// (greek_shape sizes it, for every a_tile: x, qd, acc_q, acc_v take the
// places of x, dxv, AS, AV), the
// knock-out flag and last basket value per path in its thread, and at the
// end the (payoff, rho) sums and the (dval, vval) leaves of mctpu's
// _bar_greek_payoff: p = alive max(B_T - k, 0), rho = p sum_m acc_q_m sr_m
// - t p, dval = p qd cd, vval = p (acc_v - n inv_v).  K33 writes its leaves
// over the dead normals and dxv; K35's qd is live to the end, so each path
// writes its leaves over its own qd and acc_v and the tree reads them there
// (the same tree, the same order).  Padded lanes sum to exact zeros.
template <bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(PK_THREADS)
    mw_bar_greeks_packed_kernel(const float* __restrict__ scal,
                                const float* __restrict__ lt,
                                const float* __restrict__ linv,
                                const float* __restrict__ par, int up,
                                Packed P, Launch g, float* __restrict__ out,
                                float* __restrict__ vecs) {
  extern __shared__ float smem[];
  const int np = P.np_max, a = P.a, W = P.width;
  constexpr int NS = ANTI ? 2 : 1;  // signs
  float* z1s = smem;
  float* z2s = z1s + np * P.ap;
  float* walk = z2s + np * P.ap;     // x, qd of each sign
  float* sums = walk + 2 * NS * a * np;  // acc_q, acc_v of each sign
  float* st[4 * NS];
  for (int sgn = 0; sgn < NS; ++sgn) {
    st[4 * sgn] = walk + 2 * sgn * a * np;
    st[4 * sgn + 1] = walk + (2 * sgn + 1) * a * np;
    st[4 * sgn + 2] = sums + 2 * sgn * a * np;
    st[4 * sgn + 3] = sums + (2 * sgn + 1) * a * np;
  }
  float* part = sums + 2 * NS * a * np;   // [n_chunks][4][W]
  float* vec = part + 4 * P.n_chunks * W;  // [4][W]
  __shared__ float sh[(PK_THREADS / 32) * 4];
  const float k = scal[0], t = scal[1], h = scal[2], sqdt = scal[3];
  const float n = static_cast<float>(g.n_obs);
  for (int u = threadIdx.x; u < 4 * W; u += PK_THREADS) vec[u] = 0.0f;
  const int q = threadIdx.x;
  mct::BlockAccN<PK_THREADS, 4, KAHAN> acc;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < g.iters; ++i) {
    const mct::Key key = iter_key(g, i);
    for (int c0 = 0; c0 < P.n_chunks; ++c0) {
      for (int u = threadIdx.x; u < a * np; u += PK_THREADS) {
        const float x0 = __ldg(par + u / np);
#pragma unroll
        for (int sgn = 0; sgn < NS; ++sgn) {
          st[4 * sgn][u] = x0;
          st[4 * sgn + 1][u] = 0.0f;
          st[4 * sgn + 2][u] = 0.0f;
          st[4 * sgn + 3][u] = 0.0f;
        }
      }
      float alive = 1.0f, last = 0.0f, alive_m = 1.0f, last_m = 0.0f;
      const int pairs = (g.n_obs + 1) / 2;
      for (int jj = 0; jj < pairs; ++jj) {
        draw_pass<PK_THREADS>(P, key, g.rows, c0, jj, z1s, z2s);
        __syncthreads();
        if (q < np) {
          float* sq[4 * NS];  // this path's state
          for (int u = 0; u < 4 * NS; ++u) sq[u] = st[u] + q;
          const int dates = min(2, g.n_obs - 2 * jj);
          for (int date = 0; date < dates; ++date) {
            const float* z = (date ? z2s : z1s) + q * P.ap;
            float b, bm;
            packed_bar_greek_date<ANTI>(P, lt, linv, par, sqdt,
                                        jj == 0 && date == 0, z, sq, b, bm);
            alive = knock(alive, b, h, up);
            last = b;
            if (ANTI) {
              alive_m = knock(alive_m, bm, h, up);
              last_m = bm;
            }
          }
        }
        __syncthreads();
      }
      if (q < np) {
        float p = alive * fmaxf(last - k, 0.0f);
        float sr = 0.0f;
        for (int m = 0; m < a; ++m) {
          sr = sr + st[2][m * np + q] * __ldg(par + 7 * a + m);
        }
        float gr = p * sr - t * p;
        float pm = 0.0f;
        if (ANTI) {
          pm = alive_m * fmaxf(last_m - k, 0.0f);
          float srm = 0.0f;
          for (int m = 0; m < a; ++m) {
            srm = srm + st[6][m * np + q] * __ldg(par + 7 * a + m);
          }
          const float grm = pm * srm - t * pm;
          gr = 0.5f * (gr + grm);
        }
        const float p_own = p;
        if (ANTI) p = 0.5f * (p + pm);
        v[0] += p;
        v[1] += p * p;
        v[2] += gr;
        v[3] += gr * gr;
        // The (dval, vval) leaves in place of this path's qd and acc_v.
        for (int m = 0; m < a; ++m) {
          const float inv_v = __ldg(par + 5 * a + m);
          const float cd = __ldg(par + 6 * a + m);
          const int o = m * np + q;
          float dval = p_own * st[1][o] * cd;
          float vval = p_own * (st[3][o] - n * inv_v);
          if constexpr (ANTI) {
            dval = 0.5f * (dval + pm * st[5][o] * cd);
            vval = 0.5f * (vval + pm * (st[7][o] - n * inv_v));
          }
          st[1][o] = dval;
          st[3][o] = vval;
        }
      }
      __syncthreads();
      bar_leaf_tree(P, c0, st[1], st[3], part);
      __syncthreads();
    }
    fold_passes(P, part, vec);
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
  for (int u = threadIdx.x; u < 4 * W; u += PK_THREADS) {
    vecs[static_cast<size_t>(blockIdx.x) * 4 * W + u] = vec[u];
  }
}

// K35 at a_tile AT = 16 or 32 (9-32 assets): K31's register design with
// K35's scores.  The block stages L (rows at stride AT), L^-1 by columns
// (column m as row m, its entries j >= m) and the per-asset rows once, and
// reads them as broadcasts at their use (mct::lds4 / lds1, as K31's).
template <int AT>
struct RegGreekOps {
  float4 l[AT * AT / 4];   // L[i][j] at i * AT + j, zero above the diagonal
  float4 li[AT * AT / 4];  // L^-1[j][m] at m * AT + j, zero for j < m
  float4 step[AT];         // drift, vol, d, w of asset i
  float4 score[AT];        // inv_v, cd, sr, log s0 of asset i
};

// One date of a path for both signs, packed_bar_greek_date's operations in
// its order: x, acc_v and the mirror's in registers; qd (written at the
// first date) and acc_q in the shared slots qd[m np], aq[m np].  The
// mirror's q is -q exactly, so its qd and acc_q are the negations of these
// (up to the sign of a zero) and are not kept.
template <int AT, bool ANTI>
__device__ __forceinline__ void reg_bar_greek_date(
    const RegGreekOps<AT>& o, int a, int np, float sqdt, bool first,
    const float (&z)[AT], float (&x)[AT], float (&xm)[AT], float (&av)[AT],
    float (&avm)[AT], float* qd, float* aq, float& b, float& bm) {
  float basket = 0.0f, basket_m = 0.0f;
#pragma unroll
  for (int i = 0; i < AT; ++i) {
    if (i < a) {
      float sum = 0.0f;
#pragma unroll
      for (int q = 0; 4 * q <= i; ++q) {
        const float4 l4 = mct::lds4(&o.l[i * (AT / 4) + q]);
        sum = sum + l4.x * z[4 * q];
        if (4 * q + 1 <= i) sum = sum + l4.y * z[4 * q + 1];
        if (4 * q + 2 <= i) sum = sum + l4.z * z[4 * q + 2];
        if (4 * q + 3 <= i) sum = sum + l4.w * z[4 * q + 3];
      }
      // Past lane a the entries and normals are 0: the padded terms add
      // +0 after the real ones (qs is never -0), so qs is unchanged.
      float qs = 0.0f;
#pragma unroll
      for (int q = i / 4; q < AT / 4; ++q) {
        const float4 l4 = mct::lds4(&o.li[i * (AT / 4) + q]);
        if (4 * q >= i) qs = qs + l4.x * z[4 * q];
        if (4 * q + 1 >= i) qs = qs + l4.y * z[4 * q + 1];
        if (4 * q + 2 >= i) qs = qs + l4.z * z[4 * q + 2];
        if (4 * q + 3 >= i) qs = qs + l4.w * z[4 * q + 3];
      }
      const float4 st = mct::lds4(&o.step[i]);
      const float inv_v = mct::lds1(&o.score[i].x);
      const float bt = sum + st.z;
      x[i] = x[i] + st.x + st.y * bt;
      if (first) qd[i * np] = qs;
      aq[i * np] = aq[i * np] + qs;
      av[i] = av[i] + qs * (bt * inv_v - sqdt);
      basket = basket + expf(x[i]) * st.w;
      if (ANTI) {
        const float btm = -sum + st.z;
        xm[i] = xm[i] + st.x + st.y * btm;
        avm[i] = avm[i] + (-qs) * (btm * inv_v - sqdt);
        basket_m = basket_m + expf(xm[i]) * st.w;
      }
    }
  }
  b = basket;
  bm = basket_m;
}

// mw_bar_greeks_packed_kernel's passes (greek_shape), thread-to-path map,
// payoff, leaves, halving tree and sums, so out and vecs are that kernel's
// bit for bit; each thread draws its own path's normals (element row *
// width + p * AT + m, pair jj) and no barrier remains in the walk.  Shared
// memory: per lane and path the slot of qd, then of its dval leaf ([a][np])
// and the slot of acc_q, then of its vval leaf ([a][np]), where the tree
// reads them; then part and vec as there.
template <int AT, bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(PK_THREADS, AT <= 16 ? 2 : 1)
    mw_bar_greeks_reg_kernel(const float* __restrict__ scal,
                             const float* __restrict__ lt,
                             const float* __restrict__ linv,
                             const float* __restrict__ par, int up, Packed P,
                             Launch g, float* __restrict__ out,
                             float* __restrict__ vecs) {
  extern __shared__ float smem[];
  __shared__ RegGreekOps<AT> o;
  __shared__ float sh[(PK_THREADS / 32) * 4];
  const int np = P.np_max, a = P.a, W = P.width;
  float* ld = smem;                        // [a][np]: qd, then dval
  float* lv = ld + a * np;                 // [a][np]: acc_q, then vval
  float* part = lv + a * np;               // [n_chunks][4][W]
  float* vec = part + 4 * P.n_chunks * W;  // [4][W]
  float* lf = reinterpret_cast<float*>(o.l);
  float* lif = reinterpret_cast<float*>(o.li);
  for (int t = threadIdx.x; t < AT * AT; t += PK_THREADS) {
    const int i = t / AT, j = t - i * AT;
    lf[t] = (i < a && j <= i) ? lt[i * a + j] : 0.0f;
    lif[t] = (j < a && j >= i) ? linv[j * a + i] : 0.0f;
  }
  float* sf = reinterpret_cast<float*>(o.step);
  float* cf = reinterpret_cast<float*>(o.score);
  for (int t = threadIdx.x; t < 4 * AT; t += PK_THREADS) {
    const int i = t / 4, r = t - 4 * i;
    sf[t] = i < a ? par[(r + 1) * a + i] : 0.0f;
    cf[t] = i < a ? par[(r < 3 ? r + 5 : 0) * a + i] : 0.0f;
  }
  for (int u = threadIdx.x; u < 4 * W; u += PK_THREADS) vec[u] = 0.0f;
  __syncthreads();
  const float k = scal[0], t = scal[1], h = scal[2], sqdt = scal[3];
  const float n = static_cast<float>(g.n_obs);
  const int q = threadIdx.x;
  const int pairs = (g.n_obs + 1) / 2;
  mct::BlockAccN<PK_THREADS, 4, KAHAN> acc;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int it = 0; it < g.iters; ++it) {
    const mct::Key key = iter_key(g, it);
    for (int c0 = 0; c0 < P.n_chunks; ++c0) {
      if (q < np) {
        const int row = pass_row(P, c0, q / P.c);
        const uint32_t e0 =
            static_cast<uint32_t>(row * W + (q % P.c) * AT);
        float* qd = ld + q;
        float* aq = lv + q;
        float x[AT], xm[AT], av[AT], avm[AT];
#pragma unroll
        for (int i = 0; i < AT; ++i) {
          x[i] = xm[i] = mct::lds1(&o.score[i].w);
          av[i] = avm[i] = 0.0f;
          if (i < a) aq[i * np] = 0.0f;
        }
        float alive = 1.0f, last = 0.0f, alive_m = 1.0f, last_m = 0.0f;
        for (int jj = 0; jj < pairs; ++jj) {
          float z[2][AT];
#pragma unroll
          for (int m = 0; m < AT; ++m) {
            if (m < a) {
              mct::draw_normal_pair(key, e0 + m, static_cast<uint32_t>(jj),
                                    z[0][m], z[1][m]);
            } else {
              z[0][m] = z[1][m] = 0.0f;
            }
          }
          const int dates = min(2, g.n_obs - 2 * jj);
#pragma unroll
          for (int date = 0; date < 2; ++date) {
            if (date >= dates) break;
            float b, bm;
            reg_bar_greek_date<AT, ANTI>(o, a, np, sqdt,
                                         jj == 0 && date == 0, z[date], x,
                                         xm, av, avm, qd, aq, b, bm);
            alive = knock(alive, b, h, up);
            last = b;
            if (ANTI) {
              alive_m = knock(alive_m, bm, h, up);
              last_m = bm;
            }
          }
        }
        float p = alive * fmaxf(last - k, 0.0f);
        float sr = 0.0f;
#pragma unroll
        for (int m = 0; m < AT; ++m) {
          if (m < a) sr = sr + aq[m * np] * mct::lds1(&o.score[m].z);
        }
        float gr = p * sr - t * p;
        float pm = 0.0f;
        if (ANTI) {
          pm = alive_m * fmaxf(last_m - k, 0.0f);
          float srm = 0.0f;
#pragma unroll
          for (int m = 0; m < AT; ++m) {
            if (m < a) srm = srm + (-aq[m * np]) * mct::lds1(&o.score[m].z);
          }
          const float grm = pm * srm - t * pm;
          gr = 0.5f * (gr + grm);
        }
        const float p_own = p;
        if (ANTI) p = 0.5f * (p + pm);
        v[0] += p;
        v[1] += p * p;
        v[2] += gr;
        v[3] += gr * gr;
        // The (dval, vval) leaves in place of qd and acc_q.
#pragma unroll
        for (int m = 0; m < AT; ++m) {
          if (m < a) {
            const float inv_v = mct::lds1(&o.score[m].x);
            const float cd = mct::lds1(&o.score[m].y);
            const float qdm = qd[m * np];
            float dval = p_own * qdm * cd;
            float vval = p_own * (av[m] - n * inv_v);
            if (ANTI) {
              dval = 0.5f * (dval + pm * (-qdm) * cd);
              vval = 0.5f * (vval + pm * (avm[m] - n * inv_v));
            }
            qd[m * np] = dval;
            aq[m * np] = vval;
          }
        }
      }
      __syncthreads();
      bar_leaf_tree(P, c0, ld, lv, part);
      __syncthreads();
    }
    fold_passes(P, part, vec);
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
  for (int u = threadIdx.x; u < 4 * W; u += PK_THREADS) {
    vecs[static_cast<size_t>(blockIdx.x) * 4 * W + u] = vec[u];
  }
}

// K35 at a_tile 16 and 32: dynamic shared memory of leaves, part and vec.
size_t bar_greeks_reg_smem(const Packed& P) {
  return (2 * static_cast<size_t>(P.a) * P.np_max +
          (4 * static_cast<size_t>(P.n_chunks) + 4) * P.width) *
         sizeof(float);
}

template <int AT>
int launch_bar_greeks_reg(bool anti, bool kahan, const float* scal,
                          const float* lt, const float* linv,
                          const float* par, int up, const Packed& P,
                          const Launch& g, int n_blocks, float* out,
                          float* vecs, cudaStream_t s) {
  using Fn = void (*)(const float*, const float*, const float*, const float*,
                      int, Packed, Launch, float*, float*);
  static const Fn FNS[4] = {mw_bar_greeks_reg_kernel<AT, false, false>,
                            mw_bar_greeks_reg_kernel<AT, false, true>,
                            mw_bar_greeks_reg_kernel<AT, true, false>,
                            mw_bar_greeks_reg_kernel<AT, true, true>};
  const Fn fn = FNS[(anti ? 2 : 0) | (kahan ? 1 : 0)];
  const size_t smem = bar_greeks_reg_smem(P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<n_blocks, PK_THREADS, smem, s>>>(scal, lt, linv, par, up, P, g, out,
                                        vecs);
  return 0;
}

Launch make_launch(int n_obs, int seed, int off, int rows, int iters) {
  return Launch{n_obs, static_cast<uint32_t>(seed), static_cast<uint32_t>(off),
                rows, iters};
}

}  // namespace

// Dispatches the asset-major kernels on n_assets = 1..8.
#define MCT_DISPATCH_A(CALL)                             \
  switch (n_assets) {                                    \
    case 1: CALL(1); break;                              \
    case 2: CALL(2); break;                              \
    case 3: CALL(3); break;                              \
    case 4: CALL(4); break;                              \
    case 5: CALL(5); break;                              \
    case 6: CALL(6); break;                              \
    case 7: CALL(7); break;                              \
    case MAX_AM_ASSETS: CALL(MAX_AM_ASSETS); break;      \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// Floats of scratch a K30 launch takes (cap: at most this many, 0 for 256
// MB; past it the blocks and iterations go in groups).  The fold's carry
// (BlockAccN's pairs) is the same at every thread count.
extern "C" int mctpu_multi_walk_am_scratch_floats(int n_blocks, int rows,
                                                  int iters, int cap) {
  return static_cast<int>(
      mct::walk_groups<am_threads<1>(), true>(n_blocks, rows, iters,
                                              static_cast<size_t>(cap))
          .total);
}

extern "C" int mctpu_multi_walk_am(const float* lt, const float* par,
                                   const float* scal, int n_assets, int n_obs,
                                   int seed, int off, int n_blocks, int rows,
                                   int iters, int antithetic, int kahan,
                                   int barrier, int up, int cap,
                                   float* scratch, float* out, void* stream) {
  const Launch g = make_launch(n_obs, seed, off, rows, iters);
  const AmParams P{lt, par, scal, up, n_obs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
#define MCT_CALL(A)                                                       \
  err = launch_walk_am<A>(antithetic != 0, kahan != 0, barrier != 0, P, g, \
                          n_blocks, static_cast<size_t>(cap), scratch,     \
                          out, s)
  MCT_DISPATCH_A(MCT_CALL)
#undef MCT_CALL
  return err;
}

extern "C" int mctpu_multi_walk_packed(const float* lt, const float* par,
                                       const float* scal, int n_assets,
                                       int n_obs, int seed, int off,
                                       int n_blocks, int rows, int iters,
                                       int antithetic, int kahan, int a_tile,
                                       int width, int barrier, int up,
                                       float* out, void* stream) {
  if (a_tile < n_assets || width % a_tile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem = 0;
  const Packed P = packed_shape(n_assets, a_tile, width, rows,
                                antithetic != 0, smem);
  if (P.chunk_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_walk_packed(
      antithetic != 0, kahan != 0, barrier != 0, lt, par, scal, up, P, smem,
      make_launch(n_obs, seed, off, rows, iters), n_blocks, out,
      static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mctpu_multi_walk_greeks_am(const float* scal, const float* lt,
                                          const float* par, int n_assets,
                                          int n_obs, int seed, int off,
                                          int n_blocks, int rows, int iters,
                                          int antithetic, int kahan,
                                          float* out, void* stream) {
  const Launch g = make_launch(n_obs, seed, off, rows, iters);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MCT_CALL(A)                                                        \
  launch_greeks_am<A>(antithetic != 0, kahan != 0, scal, lt, par, g,       \
                      n_blocks, out, s)
  MCT_DISPATCH_A(MCT_CALL)
#undef MCT_CALL
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch a K34 launch takes (cap: at most this many, 0 for 256
// MB; past it the blocks and iterations go in groups).
extern "C" int mctpu_multi_walk_bar_greeks_am_scratch_floats(int n_assets,
                                                            int n_blocks,
                                                            int rows,
                                                            int iters,
                                                            int cap) {
  size_t total = 0;
#define MCT_CALL(A)                                                  \
  total = mct::walk_groups<am_threads<A>(), true, 2 + 2 * A>(        \
              n_blocks, rows, iters, static_cast<size_t>(cap)).total
  MCT_DISPATCH_A(MCT_CALL)
#undef MCT_CALL
  return static_cast<int>(total);
}

extern "C" int mctpu_multi_walk_bar_greeks_am(
    const float* scal, const float* lt, const float* linv, const float* par,
    int n_assets, int n_obs, int seed, int off, int n_blocks, int rows,
    int iters, int antithetic, int kahan, int up, int cap, float* scratch,
    float* out, void* stream) {
  const Launch g = make_launch(n_obs, seed, off, rows, iters);
  const BarGreekParams P{scal, lt, linv, par, up, n_obs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
#define MCT_CALL(A)                                                         \
  err = launch_bar_greeks_am<A>(antithetic != 0, kahan != 0, P, g, n_blocks, \
                                static_cast<size_t>(cap), scratch, out, s)
  MCT_DISPATCH_A(MCT_CALL)
#undef MCT_CALL
  return err;
}

extern "C" int mctpu_multi_walk_greeks_packed(
    const float* scal, const float* tj, const float* lt, const float* par,
    int n_assets, int n_obs, int seed, int off, int n_blocks, int rows,
    int iters, int antithetic, int kahan, int a_tile, int width, float* out,
    float* vecs, void* stream) {
  if (a_tile < n_assets || width % a_tile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem = 0;
  const Packed P = greek_shape(n_assets, a_tile, width, rows,
                               (antithetic ? 2 : 1) * K33_LANE_FLOATS, smem);
  if (P.chunk_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  using Fn = void (*)(const float*, const float*, const float*, const float*,
                      Packed, Launch, float*, float*);
  static const Fn FNS[3][4] = {
      {mw_greeks_packed_kernel<false, false>,
       mw_greeks_packed_kernel<false, true>,
       mw_greeks_packed_kernel<true, false>,
       mw_greeks_packed_kernel<true, true>},
      {mw_greeks_reg_kernel<16, false, false>,
       mw_greeks_reg_kernel<16, false, true>,
       mw_greeks_reg_kernel<16, true, false>,
       mw_greeks_reg_kernel<16, true, true>},
      {mw_greeks_reg_kernel<MW_REG_MAX, false, false>,
       mw_greeks_reg_kernel<MW_REG_MAX, false, true>,
       mw_greeks_reg_kernel<MW_REG_MAX, true, false>,
       mw_greeks_reg_kernel<MW_REG_MAX, true, true>}};
  // a_tile 16 and 32: the register kernel, its shared memory the AS and AV
  // slots of each sign, part and vec.
  const int reg = a_tile == 16 ? 1 : a_tile == MW_REG_MAX ? 2 : 0;
  if (reg > 0) {
    smem = (2 * static_cast<size_t>(antithetic ? 2 : 1) * n_assets *
                P.np_max +
            (4 * static_cast<size_t>(P.n_chunks) + 4) * width) *
           sizeof(float);
  }
  const Fn fn = FNS[reg][(antithetic ? 2 : 0) | (kahan ? 1 : 0)];
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<n_blocks, PK_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      scal, tj, lt, par, P, make_launch(n_obs, seed, off, rows, iters), out,
      vecs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mctpu_multi_walk_bar_greeks_packed(
    const float* scal, const float* lt, const float* linv, const float* par,
    int n_assets, int n_obs, int seed, int off, int n_blocks, int rows,
    int iters, int antithetic, int kahan, int a_tile, int width, int up,
    float* out, float* vecs, void* stream) {
  if (a_tile < n_assets || width % a_tile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem = 0;
  const Packed P = greek_shape(n_assets, a_tile, width, rows,
                               (antithetic ? 2 : 1) * K33_LANE_FLOATS, smem);
  if (P.chunk_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Launch g = make_launch(n_obs, seed, off, rows, iters);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_tile == 16 || a_tile == MW_REG_MAX) {
    const int err =
        (a_tile == 16 ? launch_bar_greeks_reg<16>
                      : launch_bar_greeks_reg<MW_REG_MAX>)(
            antithetic != 0, kahan != 0, scal, lt, linv, par, up, P, g,
            n_blocks, out, vecs, s);
    if (err != 0) return err;
    return static_cast<int>(cudaGetLastError());
  }
  using Fn = void (*)(const float*, const float*, const float*, const float*,
                      int, Packed, Launch, float*, float*);
  static const Fn FNS[4] = {
      mw_bar_greeks_packed_kernel<false, false>,
      mw_bar_greeks_packed_kernel<false, true>,
      mw_bar_greeks_packed_kernel<true, false>,
      mw_bar_greeks_packed_kernel<true, true>};
  const Fn fn = FNS[(antithetic ? 2 : 0) | (kahan ? 1 : 0)];
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<n_blocks, PK_THREADS, smem, s>>>(scal, lt, linv, par, up, P, g, out,
                                        vecs);
  return static_cast<int>(cudaGetLastError());
}
