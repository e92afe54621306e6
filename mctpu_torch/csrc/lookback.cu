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
// path.  Simple design, as K9: one CUDA block per simulation block, one
// thread per path element striding over the (rows, 128) tile, state in
// registers; K15 sums with mct::Acc2, K16 with mct::BlockAccN per iteration.
// No atomics.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;        // K15
constexpr int GREEK_THREADS = 512;   // K16: 6 carries and 8 sums a thread
constexpr int N_SUMS = 8;

template <int MODE>
struct Kind {
  static constexpr bool FIXED = (MODE & 2) != 0;
  static constexpr bool PUT = (MODE & 1) != 0;
  static constexpr bool USE_MIN = FIXED == PUT;  // floating call, fixed put
};

// One K15 walk of tile element e -> its payoff.
template <int MODE>
__device__ __forceinline__ float walk(float log_s0, float k, float drift,
                                      float vol, int n_obs, mct::Key key,
                                      uint32_t e, float sgn) {
  using K = Kind<MODE>;
  float log_s = log_s0, log_ext = log_s0;
  mct::walk_pairwise(key, e, n_obs, [&](int, float z) {
    log_s = log_s + drift + vol * (sgn * z);
    log_ext = K::USE_MIN ? fminf(log_ext, log_s) : fmaxf(log_ext, log_s);
  });
  const float s = expf(log_s), ext = expf(log_ext);
  if (!K::FIXED) return K::PUT ? ext - s : s - ext;
  return fmaxf(K::PUT ? k - ext : ext - k, 0.0f);
}

template <bool ANTI, bool KAHAN, int MODE>
__global__ void __launch_bounds__(THREADS)
    lookback_kernel(const float* __restrict__ par, int n_obs, uint32_t seed,
                    uint32_t off, int n_elems, int iters,
                    float* __restrict__ out) {
  // par: log s0, k, drift, vol
  const float log_s0 = par[0], k = par[1], drift = par[2], vol = par[3];
  mct::Acc2<KAHAN> acc;
  for (int i = 0; i < iters; ++i) {
    const uint32_t word = (off + blockIdx.x) * static_cast<uint32_t>(iters) +
                          static_cast<uint32_t>(i);
    const mct::Key key = mct::seed_key(seed, word);
    for (int e = threadIdx.x; e < n_elems; e += THREADS) {
      const uint32_t u = static_cast<uint32_t>(e);
      float p = walk<MODE>(log_s0, k, drift, vol, n_obs, key, u, 1.0f);
      if (ANTI) {
        p = 0.5f * (p + walk<MODE>(log_s0, k, drift, vol, n_obs, key, u,
                                   -1.0f));
      }
      acc.add(p);
    }
  }
  mct::write_block_sums<THREADS, KAHAN>(acc, out);
}

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
void launch(const float* scal, int n_obs, uint32_t seed, uint32_t off,
            int n_blocks, int n_elems, int iters, int greeks, float* out,
            cudaStream_t stream) {
  if (greeks) {
    lookback_greeks_kernel<ANTI, KAHAN, MODE><<<n_blocks, GREEK_THREADS, 0,
                                                stream>>>(
        scal, n_obs, seed, off, n_elems, iters, out);
  } else {
    lookback_kernel<ANTI, KAHAN, MODE><<<n_blocks, THREADS, 0, stream>>>(
        scal, n_obs, seed, off, n_elems, iters, out);
  }
}

using LaunchFn = void (*)(const float*, int, uint32_t, uint32_t, int, int,
                          int, int, float*, cudaStream_t);

// Indexed by antithetic << 3 | kahan << 2 | mode.
#define MCT_LOOKBACK_MODES(A, K)                                  \
  launch<A, K, 0>, launch<A, K, 1>, launch<A, K, 2>, launch<A, K, 3>
constexpr LaunchFn LAUNCHERS[16] = {
    MCT_LOOKBACK_MODES(false, false), MCT_LOOKBACK_MODES(false, true),
    MCT_LOOKBACK_MODES(true, false),  MCT_LOOKBACK_MODES(true, true),
};
#undef MCT_LOOKBACK_MODES

int run(const float* scal, int n_obs, int seed, int off, int n_blocks,
        int rows, int iters, int antithetic, int kahan, int mode, int greeks,
        float* out, void* stream) {
  if (mode < 0 || mode > 3) return static_cast<int>(cudaErrorInvalidValue);
  const int idx = (antithetic ? 8 : 0) | (kahan ? 4 : 0) | mode;
  LAUNCHERS[idx](scal, n_obs, static_cast<uint32_t>(seed),
                 static_cast<uint32_t>(off), n_blocks, rows * mct::LANES,
                 iters, greeks, out, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mctpu_lookback(const float* par, int n_obs, int seed, int off,
                              int n_blocks, int rows, int iters,
                              int antithetic, int kahan, int mode, float* out,
                              void* stream) {
  return run(par, n_obs, seed, off, n_blocks, rows, iters, antithetic, kahan,
             mode, 0, out, stream);
}

extern "C" int mctpu_lookback_greeks(const float* scal, int n_obs, int seed,
                                     int off, int n_blocks, int rows,
                                     int iters, int antithetic, int kahan,
                                     int mode, float* out, void* stream) {
  return run(scal, n_obs, seed, off, n_blocks, rows, iters, antithetic, kahan,
             mode, 1, out, stream);
}
