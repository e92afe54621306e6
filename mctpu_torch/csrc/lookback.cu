// K15 and K16: fused lookback-option Monte Carlo and its pathwise Greeks.
//
// K15 replaces mctpu/kernels/lookback.py::_lookback_kernel, K16
// ::_lookback_greeks_kernel.  The stream is K9's (csrc/asian.cu): reseed per
// (block, iteration) with (seed, (off + b) * iters + i), pairs of dates per
// Philox block, the antithetic mirror replaying the draws with the sign
// flipped and averaged in before the sums.  Each path carries the log-spot
// and the running extreme of it, which starts at log s0 (the initial fixing
// is a monitoring point): the minimum for the floating call and the fixed
// put, the maximum for the floating put and the fixed call.  MODE is
// 2 * fixed + put.  The payoff takes two expf per path.  K16 also carries f
// (the vega tangent over s) and t at the arg-extreme, updated by the same
// strict compare, and the running scalars cj = c1 (j + 1) and tj = t_j as
// sums, as the JAX kernel does; it forms price, delta (homogeneity), vega
// and rho (mctpu/kernels/lookback.py, _greek_epilogue): 4 outputs, 8 sums.
//
// This file is built with -fmad=false (mctpu_torch/_build.py), like
// csrc/asian.cu: the arg-extreme update and the fixed strike's in-the-money
// indicator are discontinuities, and an FMA that the plain PyTorch version
// does not take would move a log-spot by an ulp and move a whole term of a
// block sum.  Without contraction, and with the same libm expf and IEEE
// division, each path's values equal the plain version's to the bit.
//
// Bound on the H100: arithmetic, the 32-bit integer pipe of Philox first.
// Per path-step: half a Philox block, half a Box-Muller, one add chain and a
// min or max (K16: three selects and two tangent FMAs more); two expf per
// path.  K15 is a split walk (mct::walk_split_kernel, csrc/common.cuh, as
// K12 in csrc/barrier.cu): one thread per path element of every
// (simulation block, iteration) item walks both signs of its path on one
// draw of each pair and writes its payoff, and mct::walk_fold_kernel adds
// the payoffs in the order of the simple design (one CUDA block of 1024
// threads per simulation block, each thread's Acc2 over its elements t, t +
// 1024, .. of every iteration, then write_block_sums' tree), so its block
// sums are that design's bit for bit.  K16 keeps the simple design: one
// CUDA block per simulation block, one thread per path element striding
// over the (rows, 128) tile, state in registers, the sums in
// mct::BlockAccN per iteration.  No atomics.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;        // K15's fold
constexpr int GREEK_THREADS = 512;   // K16: 6 carries and 8 sums a thread
constexpr int N_SUMS = 8;

template <int MODE>
struct Kind {
  static constexpr bool FIXED = (MODE & 2) != 0;
  static constexpr bool PUT = (MODE & 1) != 0;
  static constexpr bool USE_MIN = FIXED == PUT;  // floating call, fixed put
};

template <bool USE_MIN>
__device__ __forceinline__ float extreme(float log_ext, float log_s) {
  return USE_MIN ? fminf(log_ext, log_s) : fmaxf(log_ext, log_s);
}

// K15's payoff from the terminal log-spot and the running extreme.
template <int MODE>
__device__ __forceinline__ float payoff(float log_s, float log_ext,
                                        float k) {
  using K = Kind<MODE>;
  const float s = expf(log_s), ext = expf(log_ext);
  if (!K::FIXED) return K::PUT ? ext - s : s - ext;
  return fmaxf(K::PUT ? k - ext : ext - k, 0.0f);
}

// K15's split walk: both signs of tile element e's path advance on one
// draw of each pair (the mirror's normal is -z, exactly the simple
// design's sgn * z), and the element's payoff is their mean under ANTI.
// par: log s0, k, drift, vol.
template <int MODE>
struct LookbackWalk {
  struct Params {
    const float* par;
    int n_obs;
  };
  static constexpr int SHARED = 0;
  static constexpr int MIN_BLOCKS = 16;  // 64 warps an SM at 32 registers

  __device__ static void stage(const Params&, float*) {}

  template <bool ANTI>
  __device__ static float pay(const Params& P, const float*, mct::Key key,
                              uint32_t e) {
    constexpr bool USE_MIN = Kind<MODE>::USE_MIN;
    const float log_s0 = P.par[0], k = P.par[1], drift = P.par[2],
                vol = P.par[3];
    float log_s = log_s0, log_ext = log_s0, log_m = log_s0,
          log_ext_m = log_s0;
    mct::walk_pairwise(key, e, P.n_obs, [&](int, float z) {
      log_s = log_s + drift + vol * z;
      log_ext = extreme<USE_MIN>(log_ext, log_s);
      if (ANTI) {
        log_m = log_m + drift + vol * (-z);
        log_ext_m = extreme<USE_MIN>(log_ext_m, log_m);
      }
    });
    const float p = payoff<MODE>(log_s, log_ext, k);
    if (!ANTI) return p;
    return 0.5f * (p + payoff<MODE>(log_m, log_ext_m, k));
  }
};

// K16's scalars (mctpu_torch/kernels/lookback.py, GREEK_SCAL).
struct GreekScal {
  float log_s0, s0, k, drift, vol, inv_v, c1, dt, t;
};

// One K16 walk of tile element e; q[] gets (p, gd, gv, gr).
template <int MODE>
__device__ __forceinline__ void greek_walk(const GreekScal& c, int n_obs,
                                           mct::Key key, uint32_t e,
                                           float sgn, float (&q)[4]) {
  using K = Kind<MODE>;
  float log_s = c.log_s0, log_ext = c.log_s0, f_ext = 0.0f, t_ext = 0.0f,
        cj = c.c1, tj = 0.0f;
  mct::walk_pairwise(key, e, n_obs, [&](int, float z) {
    log_s = log_s + c.drift + c.vol * (sgn * z);
    tj = tj + c.dt;
    const float f = (log_s - c.log_s0) * c.inv_v + cj;
    const bool upd = K::USE_MIN ? log_s < log_ext : log_s > log_ext;
    log_ext = upd ? log_s : log_ext;
    f_ext = upd ? f : f_ext;
    t_ext = upd ? tj : t_ext;
    cj = cj + c.c1;
  });
  const float s_t = expf(log_s), ext = expf(log_ext);
  const float f_t = (log_s - c.log_s0) * c.inv_v +
                    c.c1 * static_cast<float>(n_obs);
  if (!K::FIXED) {
    const float p = K::PUT ? ext - s_t : s_t - ext;
    const float gv = s_t * f_t - ext * f_ext;
    const float gr = ext * (c.t - t_ext);
    q[0] = p;
    q[1] = __fdiv_rn(p, c.s0);
    q[2] = K::PUT ? -gv : gv;
    q[3] = K::PUT ? -gr : gr;
  } else if (K::PUT) {  // ext tracks the minimum
    const float ind = ext < c.k ? 1.0f : 0.0f;
    const float p = fmaxf(c.k - ext, 0.0f);
    q[0] = p;
    q[1] = __fdiv_rn(-ind * ext, c.s0);
    q[2] = -ind * ext * f_ext;
    q[3] = -ind * t_ext * ext - c.t * p;
  } else {  // ext tracks the maximum
    const float ind = ext > c.k ? 1.0f : 0.0f;
    const float p = fmaxf(ext - c.k, 0.0f);
    q[0] = p;
    q[1] = __fdiv_rn(ind * ext, c.s0);
    q[2] = ind * ext * f_ext;
    q[3] = ind * t_ext * ext - c.t * p;
  }
}

template <bool ANTI, bool KAHAN, int MODE>
__global__ void __launch_bounds__(GREEK_THREADS)
    lookback_greeks_kernel(const float* __restrict__ scal, int n_obs,
                           uint32_t seed, uint32_t off, int n_elems,
                           int iters, float* __restrict__ out) {
  __shared__ float sh[(GREEK_THREADS / 32) * N_SUMS];
  const GreekScal c{scal[0], scal[1], scal[2], scal[3], scal[4],
                    scal[5], scal[6], scal[7], scal[8]};
  mct::BlockAccN<GREEK_THREADS, N_SUMS, KAHAN> acc;
  float v[N_SUMS];
#pragma unroll
  for (int j = 0; j < N_SUMS; ++j) v[j] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const uint32_t word = (off + blockIdx.x) * static_cast<uint32_t>(iters) +
                          static_cast<uint32_t>(i);
    const mct::Key key = mct::seed_key(seed, word);
    for (int e = threadIdx.x; e < n_elems; e += GREEK_THREADS) {
      float q[4];
      greek_walk<MODE>(c, n_obs, key, static_cast<uint32_t>(e), 1.0f, q);
      if (ANTI) {
        float m[4];
        greek_walk<MODE>(c, n_obs, key, static_cast<uint32_t>(e), -1.0f, m);
#pragma unroll
        for (int j = 0; j < 4; ++j) q[j] = 0.5f * (q[j] + m[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] += q[j];
        v[2 * j + 1] += q[j] * q[j];
      }
    }
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
}

template <bool ANTI, bool KAHAN, int MODE>
void launch_greeks(const float* scal, int n_obs, uint32_t seed, uint32_t off,
                   int n_blocks, int n_elems, int iters, float* out,
                   cudaStream_t stream) {
  lookback_greeks_kernel<ANTI, KAHAN, MODE><<<n_blocks, GREEK_THREADS, 0,
                                              stream>>>(
      scal, n_obs, seed, off, n_elems, iters, out);
}

using GreeksFn = void (*)(const float*, int, uint32_t, uint32_t, int, int,
                          int, float*, cudaStream_t);

// K15's split walk and its fold (THREADS threads, each thread's Acc2).
template <bool ANTI, bool KAHAN, int MODE>
int launch_split(const float* par, int n_obs, uint32_t seed, uint32_t off,
                 int n_blocks, int rows, int iters, size_t cap,
                 float* scratch, float* out, cudaStream_t s) {
  return mct::walk_split_launch<LookbackWalk<MODE>, THREADS, false, ANTI,
                                KAHAN>(
      typename LookbackWalk<MODE>::Params{par, n_obs}, seed, off, n_blocks,
      rows, iters, cap, scratch, out, s);
}

using SplitFn = int (*)(const float*, int, uint32_t, uint32_t, int, int, int,
                        size_t, float*, float*, cudaStream_t);

// Both tables indexed by antithetic << 3 | kahan << 2 | mode.
#define MCT_LOOKBACK_MODES(F, A, K) \
  F<A, K, 0>, F<A, K, 1>, F<A, K, 2>, F<A, K, 3>
#define MCT_LOOKBACK_TABLE(F)                                            \
  MCT_LOOKBACK_MODES(F, false, false), MCT_LOOKBACK_MODES(F, false, true), \
      MCT_LOOKBACK_MODES(F, true, false), MCT_LOOKBACK_MODES(F, true, true)
constexpr GreeksFn GREEK_LAUNCHERS[16] = {MCT_LOOKBACK_TABLE(launch_greeks)};
constexpr SplitFn SPLIT_LAUNCHERS[16] = {MCT_LOOKBACK_TABLE(launch_split)};
#undef MCT_LOOKBACK_TABLE
#undef MCT_LOOKBACK_MODES

int launcher_index(int antithetic, int kahan, int mode) {
  return (antithetic ? 8 : 0) | (kahan ? 4 : 0) | mode;
}

}  // namespace

// Floats of scratch a K15 launch takes (cap: at most this many, 0 for 256
// MB; past it the blocks and iterations go in groups).
extern "C" int mctpu_lookback_scratch_floats(int n_blocks, int rows,
                                             int iters, int cap) {
  return static_cast<int>(
      mct::walk_groups<THREADS, false>(n_blocks, rows, iters,
                                       static_cast<size_t>(cap))
          .total);
}

extern "C" int mctpu_lookback(const float* par, int n_obs, int seed, int off,
                              int n_blocks, int rows, int iters,
                              int antithetic, int kahan, int mode, int cap,
                              float* scratch, float* out, void* stream) {
  if (mode < 0 || mode > 3) return static_cast<int>(cudaErrorInvalidValue);
  return SPLIT_LAUNCHERS[launcher_index(antithetic, kahan, mode)](
      par, n_obs, static_cast<uint32_t>(seed), static_cast<uint32_t>(off),
      n_blocks, rows, iters, static_cast<size_t>(cap), scratch, out,
      static_cast<cudaStream_t>(stream));
}

extern "C" int mctpu_lookback_greeks(const float* scal, int n_obs, int seed,
                                     int off, int n_blocks, int rows,
                                     int iters, int antithetic, int kahan,
                                     int mode, float* out, void* stream) {
  if (mode < 0 || mode > 3) return static_cast<int>(cudaErrorInvalidValue);
  GREEK_LAUNCHERS[launcher_index(antithetic, kahan, mode)](
      scal, n_obs, static_cast<uint32_t>(seed), static_cast<uint32_t>(off),
      n_blocks, rows * mct::LANES, iters, out,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
