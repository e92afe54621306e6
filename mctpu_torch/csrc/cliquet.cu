// K17 and K18: fused cliquet Monte Carlo and its pathwise Greeks.
//
// K17 replaces mctpu/kernels/cliquet.py::_cliquet_kernel, K18
// ::_cliquet_greeks_kernel.  The stream is K9's (csrc/asian.cu) with the
// n_periods periods in place of the dates: reseed per (block, iteration)
// with (seed, (off + b) * iters + i), pairs of periods per Philox block, the
// antithetic mirror replaying the draws with the sign flipped and averaged
// in before the sums.  Each period draws the log-return lr = mu_dt + vol z
// and adds min(max(expf(lr) - 1, floor), cap); no spot is carried.  K18 also
// sums, under the band mask m = 1{floor < ret < cap}, m e^lr times the
// derivative of lr in v, r and T, and forms price, vega, rho and theta
// (mctpu/kernels/cliquet.py, _greek_step and _greek_finalize): 4 outputs,
// 8 sums.  The arithmetic is the JAX kernel's as written: expf(lr) - 1, not
// expm1f; the vega term (lr - mu_dt) * inv_v - vol * inv_v * vol.
//
// This file is built with -fmad=false (mctpu_torch/_build.py), like
// csrc/asian.cu: mu_dt + vol * z is the expression nvcc would contract, and
// the band mask and the clip are discontinuities that one ulp of lr moves.
// Without contraction, and with the same libm expf and IEEE division, each
// path's values equal the plain PyTorch version's to the bit.
//
// Bound on the H100: arithmetic, the 32-bit integer pipe of Philox first.
// Per path-step: half a Philox block, half a Box-Muller, one expf and a
// clip (K18: a mask and three tangent sums more).  Simple design, as K9:
// one CUDA block per simulation block, one thread per path element striding
// over the (rows, 128) tile, state in registers; K17 sums with mct::Acc2,
// K18 with mct::BlockAccN per iteration.  No atomics.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;        // K17
constexpr int GREEK_THREADS = 512;   // K18: 4 carries and 8 sums a thread
constexpr int N_SUMS = 8;

__device__ __forceinline__ float clip(float ret, float floor_, float cap) {
  return fminf(fmaxf(ret, floor_), cap);
}

// One K17 walk of tile element e -> its payoff.
__device__ __forceinline__ float walk(float mu_dt, float vol, float cap,
                                      float floor_, int n_periods,
                                      mct::Key key, uint32_t e, float sgn) {
  float acc = 0.0f;
  mct::walk_pairwise(key, e, n_periods, [&](int, float z) {
    const float lr = mu_dt + vol * (sgn * z);
    acc = acc + clip(expf(lr) - 1.0f, floor_, cap);
  });
  return acc;
}

template <bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(THREADS)
    cliquet_kernel(const float* __restrict__ par, int n_periods,
                   uint32_t seed, uint32_t off, int n_elems, int iters,
                   float* __restrict__ out) {
  // par: mu_dt, vol, cap, floor
  const float mu_dt = par[0], vol = par[1], cap = par[2], floor_ = par[3];
  mct::Acc2<KAHAN> acc;
  for (int i = 0; i < iters; ++i) {
    const uint32_t word = (off + blockIdx.x) * static_cast<uint32_t>(iters) +
                          static_cast<uint32_t>(i);
    const mct::Key key = mct::seed_key(seed, word);
    for (int e = threadIdx.x; e < n_elems; e += THREADS) {
      const uint32_t u = static_cast<uint32_t>(e);
      float p = walk(mu_dt, vol, cap, floor_, n_periods, key, u, 1.0f);
      if (ANTI) {
        p = 0.5f * (p + walk(mu_dt, vol, cap, floor_, n_periods, key, u,
                             -1.0f));
      }
      acc.add(p);
    }
  }
  mct::write_block_sums<THREADS, KAHAN>(acc, out);
}

// K18's scalars (mctpu_torch/kernels/cliquet.py, GREEK_SCAL).
struct GreekScal {
  float mu_dt, vol, cap, floor_, dt, t, r, inv_v;
  float vv, half_over_t;  // vol * inv_v * vol and 0.5 / t, per launch
};

// One K18 walk of tile element e; q[] gets (p, gv, gr, gt).
__device__ __forceinline__ void greek_walk(const GreekScal& c, int n_periods,
                                           mct::Key key, uint32_t e,
                                           float sgn, float (&q)[4]) {
  float acc = 0.0f, gv = 0.0f, grr = 0.0f, gtr = 0.0f;
  mct::walk_pairwise(key, e, n_periods, [&](int, float z) {
    const float lr = c.mu_dt + c.vol * (sgn * z);
    const float ex = expf(lr);
    const float ret = ex - 1.0f;
    const float m = (ret > c.floor_ && ret < c.cap) ? 1.0f : 0.0f;
    const float me = m * ex;
    acc = acc + clip(ret, c.floor_, c.cap);
    gv = gv + me * ((lr - c.mu_dt) * c.inv_v - c.vv);
    grr = grr + me;
    gtr = gtr + me * (lr + c.mu_dt);
  });
  q[0] = acc;
  q[1] = gv;
  q[2] = grr * c.dt - c.t * acc;
  q[3] = gtr * c.half_over_t - c.r * acc;
}

template <bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(GREEK_THREADS)
    cliquet_greeks_kernel(const float* __restrict__ scal, int n_periods,
                          uint32_t seed, uint32_t off, int n_elems, int iters,
                          float* __restrict__ out) {
  __shared__ float sh[(GREEK_THREADS / 32) * N_SUMS];
  GreekScal c;
  c.mu_dt = scal[0];
  c.vol = scal[1];
  c.cap = scal[2];
  c.floor_ = scal[3];
  c.dt = scal[4];
  c.t = scal[5];
  c.r = scal[6];
  c.inv_v = scal[7];
  c.vv = c.vol * c.inv_v * c.vol;
  c.half_over_t = __fdiv_rn(0.5f, c.t);

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
      greek_walk(c, n_periods, key, static_cast<uint32_t>(e), 1.0f, q);
      if (ANTI) {
        float m[4];
        greek_walk(c, n_periods, key, static_cast<uint32_t>(e), -1.0f, m);
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

template <bool ANTI, bool KAHAN>
void launch(const float* scal, int n_periods, uint32_t seed, uint32_t off,
            int n_blocks, int n_elems, int iters, int greeks, float* out,
            cudaStream_t stream) {
  if (greeks) {
    cliquet_greeks_kernel<ANTI, KAHAN><<<n_blocks, GREEK_THREADS, 0,
                                         stream>>>(scal, n_periods, seed, off,
                                                   n_elems, iters, out);
  } else {
    cliquet_kernel<ANTI, KAHAN><<<n_blocks, THREADS, 0, stream>>>(
        scal, n_periods, seed, off, n_elems, iters, out);
  }
}

using LaunchFn = void (*)(const float*, int, uint32_t, uint32_t, int, int,
                          int, int, float*, cudaStream_t);

// Indexed by antithetic << 1 | kahan.
constexpr LaunchFn LAUNCHERS[4] = {
    launch<false, false>, launch<false, true>,
    launch<true, false>,  launch<true, true>,
};

int run(const float* scal, int n_periods, int seed, int off, int n_blocks,
        int rows, int iters, int antithetic, int kahan, int mode, int greeks,
        float* out, void* stream) {
  if (mode != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int idx = (antithetic ? 2 : 0) | (kahan ? 1 : 0);
  LAUNCHERS[idx](scal, n_periods, static_cast<uint32_t>(seed),
                 static_cast<uint32_t>(off), n_blocks, rows * mct::LANES,
                 iters, greeks, out, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: the walk signature's variant slot; the cliquet has one (0).
extern "C" int mctpu_cliquet(const float* par, int n_periods, int seed,
                             int off, int n_blocks, int rows, int iters,
                             int antithetic, int kahan, int mode, float* out,
                             void* stream) {
  return run(par, n_periods, seed, off, n_blocks, rows, iters, antithetic,
             kahan, mode, 0, out, stream);
}

extern "C" int mctpu_cliquet_greeks(const float* scal, int n_periods,
                                    int seed, int off, int n_blocks, int rows,
                                    int iters, int antithetic, int kahan,
                                    int mode, float* out, void* stream) {
  return run(scal, n_periods, seed, off, n_blocks, rows, iters, antithetic,
             kahan, mode, 1, out, stream);
}
