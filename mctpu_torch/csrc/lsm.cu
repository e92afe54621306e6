// K50 and K51: the Longstaff-Schwartz forward pass under a frozen exercise
// rule, and its pathwise delta, vega and rho.
//
// K50 replaces mctpu/kernels/lsm.py::_lsm_kernel, K51 ::_lsm_greeks_kernel.
// Per simulation block b and iteration i the stream is reseeded with
// (seed, (off + b) * iters + i) in int32 wrap; tile element e walks the
// n_steps exercise dates in pairs (mct::walk_pairwise), the antithetic
// mirror replaying the same draws with the sign flipped, and the two
// mirrored outputs are averaged before they are summed.  The walk carries
// the log-spot, the present-value cashflow and the alive flag: at date j the
// spot s = expf(log_s) pays max(+-(s - k), 0), and a path still alive
// exercises when the payoff is positive and above the continuation value
// b0 + y (b1 + y (b2 + y b3)), y = s inv_k - 1, of the rule's row j; the
// last date pays every path still alive.  K51 also sums, per exercised path
// with a positive payoff, the pathwise derivatives of df_j payoff with the
// stopping date held fixed: wp = psign df_j s, delta wp / s0, vega
// wp (log_s / v + vc_j), rho rhoc_j (mctpu/kernels/lsm.py, Greeks section).
//
// The exercise decision is a discontinuity: one ulp in s, y or the Horner
// sum moves a whole cashflow.  This file is built with -fmad=false
// (mctpu_torch/_build.py) and uses expf, never __expf, so every path rounds
// as the plain PyTorch version's separate operations do and exercises on
// the same date.  The operand tables (beta zero-padded to n_steps rows, df,
// vc, rhoc, log s0) are formed once on the host, so both read the same
// bits.  K51 reads K50's df table and takes the same steps for the cashflow,
// so its price sums equal K50's bit for bit.
//
// Bound on the H100: integer and arithmetic, as K9: per path-step half a
// Philox block and Box-Muller pair, one expf, the payoff, the Horner compare
// and the cashflow update (K51: six more multiply-adds); the walk is a
// serial dependence from date to date and the only memory traffic is the
// tables (read through the read-only cache) and the block's partials.
// Simple design: one CUDA block per simulation block, one thread per path
// element striding over the (rows, 128) tile, the state in registers;
// mct::BlockAccN reduces the block's sums once per iteration in a fixed
// tree and Kahan-adds them in the carrying threads (the JAX kernels'
// chunk sums and _accum_add).  K50 and K51 share the thread count, so K50's
// two sums reduce in K51's order.  No atomics: two launches give the same
// bits.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;

// scal: s0, k, drift, vol, inv_k, inv_v, psign, inv_s0, log_s0
// (mctpu_torch/kernels/lsm.py, SCAL).
struct Scal {
  float k, drift, vol, inv_k, inv_v, psign, inv_s0, log_s0;
};

// One walk of tile element e; q gets the PV cashflow and, under GREEKS, its
// delta, vega and rho integrands.
template <bool PUT, bool GREEKS>
__device__ __forceinline__ void walk(const Scal& c,
                                     const float* __restrict__ beta,
                                     const float* __restrict__ df,
                                     const float* __restrict__ vc,
                                     const float* __restrict__ rhoc,
                                     int n_steps, mct::Key key, uint32_t e,
                                     float sgn, float (&q)[GREEKS ? 4 : 1]) {
  float log_s = c.log_s0, cf = 0.0f, alive = 1.0f;
  float gd = 0.0f, gv = 0.0f, gr = 0.0f;
  const int last = n_steps - 1;
  mct::walk_pairwise(key, e, n_steps, [&](int j, float z) {
    log_s = log_s + c.drift + c.vol * (sgn * z);
    const float s = expf(log_s);
    const float pay = PUT ? fmaxf(c.k - s, 0.0f) : fmaxf(s - c.k, 0.0f);
    float ex = alive;  // maturity pays every path still alive
    if (j < last) {
      const float* b = beta + 4 * j;
      const float y = s * c.inv_k - 1.0f;
      const float cont =
          __ldg(b) + y * (__ldg(b + 1) + y * (__ldg(b + 2) + y * __ldg(b + 3)));
      ex = alive * ((pay > 0.0f && pay > cont) ? 1.0f : 0.0f);
    }
    const float dfj = __ldg(df + j);
    cf = cf + dfj * ex * pay;
    if (GREEKS) {
      const float exi = ex * (pay > 0.0f ? 1.0f : 0.0f);
      const float wp = (c.psign * dfj) * (exi * s);
      gd = gd + wp * c.inv_s0;
      gv = gv + wp * (log_s * c.inv_v + __ldg(vc + j));
      gr = gr + exi * __ldg(rhoc + j);
    }
    alive = alive - ex;
  });
  q[0] = cf;
  if (GREEKS) {
    q[1] = gd;
    q[2] = gv;
    q[3] = gr;
  }
}

template <bool ANTI, bool KAHAN, bool PUT, bool GREEKS>
__global__ void __launch_bounds__(THREADS)
    lsm_kernel(const float* __restrict__ scal, const float* __restrict__ beta,
               const float* __restrict__ tables, int n_steps, uint32_t seed,
               uint32_t off, int n_elems, int iters, float* __restrict__ out) {
  constexpr int NQ = GREEKS ? 4 : 1;
  constexpr int N = 2 * NQ;
  __shared__ float sh[(THREADS / 32) * N];
  Scal c;
  c.k = scal[1];
  c.drift = scal[2];
  c.vol = scal[3];
  c.inv_k = scal[4];
  c.inv_v = scal[5];
  c.psign = scal[6];
  c.inv_s0 = scal[7];
  c.log_s0 = scal[8];
  const float* df = tables;
  const float* vc = tables + n_steps;
  const float* rhoc = tables + 2 * n_steps;

  mct::BlockAccN<THREADS, N, KAHAN> acc;
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const uint32_t word = (off + blockIdx.x) * static_cast<uint32_t>(iters) +
                          static_cast<uint32_t>(i);
    const mct::Key key = mct::seed_key(seed, word);
    for (int e = threadIdx.x; e < n_elems; e += THREADS) {
      const uint32_t u = static_cast<uint32_t>(e);
      float q[NQ];
      walk<PUT, GREEKS>(c, beta, df, vc, rhoc, n_steps, key, u, 1.0f, q);
      if (ANTI) {
        float m[NQ];
        walk<PUT, GREEKS>(c, beta, df, vc, rhoc, n_steps, key, u, -1.0f, m);
#pragma unroll
        for (int j = 0; j < NQ; ++j) q[j] = 0.5f * (q[j] + m[j]);
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        v[2 * j] += q[j];
        v[2 * j + 1] += q[j] * q[j];
      }
    }
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
}

template <bool ANTI, bool KAHAN, bool PUT, bool GREEKS>
void launch(const float* scal, const float* beta, const float* tables,
            int n_steps, uint32_t seed, uint32_t off, int n_blocks,
            int n_elems, int iters, float* out, cudaStream_t stream) {
  lsm_kernel<ANTI, KAHAN, PUT, GREEKS><<<n_blocks, THREADS, 0, stream>>>(
      scal, beta, tables, n_steps, seed, off, n_elems, iters, out);
}

using LaunchFn = void (*)(const float*, const float*, const float*, int,
                          uint32_t, uint32_t, int, int, int, float*,
                          cudaStream_t);

// Indexed by antithetic << 3 | kahan << 2 | put << 1 | greeks.
constexpr LaunchFn LAUNCHERS[16] = {
    launch<false, false, false, false>, launch<false, false, false, true>,
    launch<false, false, true, false>,  launch<false, false, true, true>,
    launch<false, true, false, false>,  launch<false, true, false, true>,
    launch<false, true, true, false>,   launch<false, true, true, true>,
    launch<true, false, false, false>,  launch<true, false, false, true>,
    launch<true, false, true, false>,   launch<true, false, true, true>,
    launch<true, true, false, false>,   launch<true, true, false, true>,
    launch<true, true, true, false>,    launch<true, true, true, true>,
};

int run(const float* scal, const float* beta, const float* tables,
        int n_steps, int seed, int off, int n_blocks, int rows, int iters,
        int antithetic, int put, int kahan, int greeks, float* out,
        void* stream) {
  const int idx = (antithetic ? 8 : 0) | (kahan ? 4 : 0) | (put ? 2 : 0) |
                  (greeks ? 1 : 0);
  LAUNCHERS[idx](scal, beta, tables, n_steps, static_cast<uint32_t>(seed),
                 static_cast<uint32_t>(off), n_blocks, rows * mct::LANES,
                 iters, out, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mctpu_lsm(const float* scal, const float* beta,
                         const float* tables, int n_steps, int seed, int off,
                         int n_blocks, int rows, int iters, int antithetic,
                         int put, int kahan, float* out, void* stream) {
  return run(scal, beta, tables, n_steps, seed, off, n_blocks, rows, iters,
             antithetic, put, kahan, 0, out, stream);
}

extern "C" int mctpu_lsm_greeks(const float* scal, const float* beta,
                                const float* tables, int n_steps, int seed,
                                int off, int n_blocks, int rows, int iters,
                                int antithetic, int put, int kahan,
                                float* out, void* stream) {
  return run(scal, beta, tables, n_steps, seed, off, n_blocks, rows, iters,
             antithetic, put, kahan, 1, out, stream);
}
