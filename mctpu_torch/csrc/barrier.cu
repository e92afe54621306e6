// K12, K13 and K14: fused knock-out barrier-call Monte Carlo, its
// likelihood-ratio Greeks and the multilevel (MLMC) level correction of the
// monitoring count.
//
// K12 replaces mctpu/kernels/barrier.py::_barrier_kernel, K13
// ::_barrier_greeks_kernel, K14 ::_barrier_level_kernel.  The stream is
// K9's (csrc/asian.cu): reseed per (block, iteration) with (seed, (off + b)
// * iters + i), pairs of dates per Philox block, the antithetic mirror replaying the draws with the sign
// flipped and averaged in before the sums.  Each path carries the log-spot
// and a 0/1 alive flag that the first date with log s >= log H (up-and-out)
// or log s <= log H (down-and-out) multiplies by 0; the payoff is
// alive * max(exp(log s_T) - k, 0).  K13 also carries zeta_1, sum zeta and
// sum zeta^2 and forms the likelihood-ratio delta, vega and rho
// (mctpu/kernels/barrier.py, _greek_quants): 4 outputs, 8 sums.  Its vega
// integrand p (z2s / v - zs sqrt(dt) - n / v) cancels heavily, which is why
// the tests hold its sums by the scaled pair bound.  K14 walks nf = n0 2^l dates on K11's map (csrc/asian.cu: one pair per
// coarse step j at counter j, the cosine on the odd date, the sine on the
// shared date) with two flags: the fine flag checks both dates, the coarse
// flag the shared date only, and d = (af - ac) max(exp(log s_T) - k, 0):
// 2 sums.
//
// This file is built with -fmad=false (mctpu_torch/_build.py), like
// csrc/asian.cu: the knock-out compare is a discontinuity, and an FMA that
// the plain PyTorch version does not take would move a log-spot by an ulp
// and flip a path that grazes the barrier, changing a block sum by a whole
// payoff.  Without contraction, and with the same libm logf/sqrtf, each
// path's log-spot, flag and payoff equal the plain version's to the bit.
//
// Bound on the H100: arithmetic and latency.  Per path-step: half a Philox
// block, half a Box-Muller, one add chain and a compare; one expf per path.
// K12 is a split walk (mct::walk_split_kernel, csrc/common.cuh): one thread
// per path element of every (simulation block, iteration) item walks both
// signs of its path on one draw of each pair and writes its payoff, and
// mct::walk_fold_kernel adds the payoffs in the order of the unsplit design
// (one CUDA block of 1024 threads per simulation block, each thread's Acc2
// over its elements t, t + 1024, .. of every iteration, then
// write_block_sums' tree), so its block sums are that design's bit for bit.
// K13 and K14 keep the simple design: one CUDA block per simulation block,
// one thread per path element striding over the (rows, 128) tile, state in
// registers; K14 sums with mct::Acc2, K13 with mct::BlockAccN per
// iteration.  No atomics.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;        // K12's fold, K14
constexpr int GREEK_THREADS = 512;   // K13
constexpr int N_SUMS = 8;

template <bool UP>
__device__ __forceinline__ float alive_update(float alive, float log_s,
                                              float log_h) {
  const bool hit = UP ? log_s >= log_h : log_s <= log_h;
  return alive * (hit ? 0.0f : 1.0f);
}

// K12's split walk: both signs of tile element e's path advance on one
// draw of each pair (the mirror's normal is -z, exactly the unsplit walk's
// sgn * z), and the element's payoff is their mean under ANTI.
// par: log s0, k, log H, drift, vol.
template <bool UP>
struct BarrierWalk {
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
    const float log_s0 = P.par[0], k = P.par[1], log_h = P.par[2],
                drift = P.par[3], vol = P.par[4];
    float log_s = log_s0, alive = 1.0f, log_m = log_s0, alive_m = 1.0f;
    mct::walk_pairwise(key, e, P.n_obs, [&](int, float z) {
      log_s = log_s + drift + vol * z;
      alive = alive_update<UP>(alive, log_s, log_h);
      if (ANTI) {
        log_m = log_m + drift + vol * (-z);
        alive_m = alive_update<UP>(alive_m, log_m, log_h);
      }
    });
    const float p = alive * fmaxf(expf(log_s) - k, 0.0f);
    if (!ANTI) return p;
    return 0.5f * (p + alive_m * fmaxf(expf(log_m) - k, 0.0f));
  }
};

// One K14 walk of tile element e over n_fine dates -> its level
// difference d.
template <bool UP>
__device__ __forceinline__ float level_walk(float log_s0, float k,
                                            float log_h, float drift,
                                            float vol, int n_fine,
                                            mct::Key key, uint32_t e,
                                            float sgn) {
  float log_s = log_s0, af = 1.0f, ac = 1.0f;
  mct::walk_steps(key, e, n_fine / 2, [&](int, float z1, float z2) {
    log_s = log_s + drift + vol * (sgn * z1);  // the odd, fine-only date
    af = alive_update<UP>(af, log_s, log_h);
    log_s = log_s + drift + vol * (sgn * z2);  // the shared date
    af = alive_update<UP>(af, log_s, log_h);
    ac = alive_update<UP>(ac, log_s, log_h);
  });
  return (af - ac) * fmaxf(expf(log_s) - k, 0.0f);
}

template <bool ANTI, bool KAHAN, bool UP>
__global__ void __launch_bounds__(THREADS)
    barrier_level_kernel(const float* __restrict__ par, int n_fine,
                         uint32_t seed, uint32_t off, int n_elems, int iters,
                         float* __restrict__ out) {
  // par: log s0, k, log H, drift, vol (at dt = t / n_fine)
  const float log_s0 = par[0], k = par[1], log_h = par[2], drift = par[3],
              vol = par[4];
  mct::Acc2<KAHAN> acc;
  for (int i = 0; i < iters; ++i) {
    const uint32_t word = (off + blockIdx.x) * static_cast<uint32_t>(iters) +
                          static_cast<uint32_t>(i);
    const mct::Key key = mct::seed_key(seed, word);
    for (int e = threadIdx.x; e < n_elems; e += THREADS) {
      const uint32_t u = static_cast<uint32_t>(e);
      float d = level_walk<UP>(log_s0, k, log_h, drift, vol, n_fine, key, u,
                               1.0f);
      if (ANTI) {
        d = 0.5f * (d + level_walk<UP>(log_s0, k, log_h, drift, vol, n_fine,
                                       key, u, -1.0f));
      }
      acc.add(d);
    }
  }
  mct::write_block_sums<THREADS, KAHAN>(acc, out);
}

// K13's scalars (mctpu_torch/kernels/barrier.py, GREEK_SCAL).
struct GreekScal {
  float log_s0, k, log_h, drift, vol, c_d, inv_v, sqdt, n_over_v, c_r, t;
};

// One K13 walk of tile element e; q[] gets (p, gd, gv, gr).
template <bool UP>
__device__ __forceinline__ void greek_walk(const GreekScal& c, int n_obs,
                                           mct::Key key, uint32_t e,
                                           float sgn, float (&q)[4]) {
  float log_s = c.log_s0, alive = 1.0f, z1 = 0.0f, zs = 0.0f, z2s = 0.0f;
  mct::walk_pairwise(key, e, n_obs, [&](int j, float z) {
    const float zeta = sgn * z;
    log_s = log_s + c.drift + c.vol * zeta;
    alive = alive_update<UP>(alive, log_s, c.log_h);
    if (j == 0) z1 = zeta;
    zs = zs + zeta;
    z2s = z2s + zeta * zeta;
  });
  const float p = alive * fmaxf(expf(log_s) - c.k, 0.0f);
  q[0] = p;
  q[1] = p * z1 * c.c_d;
  q[2] = p * (z2s * c.inv_v - zs * c.sqdt - c.n_over_v);
  q[3] = p * (zs * c.c_r - c.t);
}

template <bool ANTI, bool KAHAN, bool UP>
__global__ void __launch_bounds__(GREEK_THREADS)
    barrier_greeks_kernel(const float* __restrict__ scal, int n_obs,
                          uint32_t seed, uint32_t off, int n_elems, int iters,
                          float* __restrict__ out) {
  __shared__ float sh[(GREEK_THREADS / 32) * N_SUMS];
  const GreekScal c{scal[0], scal[1], scal[2], scal[3], scal[4], scal[5],
                    scal[6], scal[7], scal[8], scal[9], scal[10]};
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
      greek_walk<UP>(c, n_obs, key, static_cast<uint32_t>(e), 1.0f, q);
      if (ANTI) {
        float m[4];
        greek_walk<UP>(c, n_obs, key, static_cast<uint32_t>(e), -1.0f, m);
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

// kind: 1 K13, 2 K14.
template <bool ANTI, bool KAHAN, bool UP>
void launch(const float* scal, int n_obs, uint32_t seed, uint32_t off,
            int n_blocks, int n_elems, int iters, int kind, float* out,
            cudaStream_t stream) {
  if (kind == 2) {
    barrier_level_kernel<ANTI, KAHAN, UP><<<n_blocks, THREADS, 0, stream>>>(
        scal, n_obs, seed, off, n_elems, iters, out);
  } else {
    barrier_greeks_kernel<ANTI, KAHAN, UP><<<n_blocks, GREEK_THREADS, 0,
                                             stream>>>(scal, n_obs, seed, off,
                                                       n_elems, iters, out);
  }
}

using LaunchFn = void (*)(const float*, int, uint32_t, uint32_t, int, int,
                          int, int, float*, cudaStream_t);

// Indexed by antithetic << 2 | kahan << 1 | up.
constexpr LaunchFn LAUNCHERS[8] = {
    launch<false, false, false>, launch<false, false, true>,
    launch<false, true, false>,  launch<false, true, true>,
    launch<true, false, false>,  launch<true, false, true>,
    launch<true, true, false>,   launch<true, true, true>,
};

int run(const float* scal, int n_obs, int seed, int off, int n_blocks,
        int rows, int iters, int antithetic, int kahan, int up, int kind,
        float* out, void* stream) {
  const int idx = (antithetic ? 4 : 0) | (kahan ? 2 : 0) | (up ? 1 : 0);
  LAUNCHERS[idx](scal, n_obs, static_cast<uint32_t>(seed),
                 static_cast<uint32_t>(off), n_blocks, rows * mct::LANES,
                 iters, kind, out, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// K12's split walk and its fold (THREADS threads, each thread's Acc2).
template <bool ANTI, bool KAHAN, bool UP>
int launch_split(const float* par, int n_obs, uint32_t seed, uint32_t off,
                 int n_blocks, int rows, int iters, size_t cap,
                 float* scratch, float* out, cudaStream_t s) {
  return mct::walk_split_launch<BarrierWalk<UP>, THREADS, false, ANTI, KAHAN>(
      typename BarrierWalk<UP>::Params{par, n_obs}, seed, off, n_blocks, rows,
      iters, cap, scratch, out, s);
}

using SplitFn = int (*)(const float*, int, uint32_t, uint32_t, int, int, int,
                        size_t, float*, float*, cudaStream_t);

// Indexed by antithetic << 2 | kahan << 1 | up.
constexpr SplitFn SPLIT_LAUNCHERS[8] = {
    launch_split<false, false, false>, launch_split<false, false, true>,
    launch_split<false, true, false>,  launch_split<false, true, true>,
    launch_split<true, false, false>,  launch_split<true, false, true>,
    launch_split<true, true, false>,   launch_split<true, true, true>,
};

}  // namespace

// Floats of scratch a K12 launch takes (cap: at most this many, 0 for 256
// MB; past it the blocks and iterations go in groups).
extern "C" int mctpu_barrier_scratch_floats(int n_blocks, int rows,
                                            int iters, int cap) {
  return static_cast<int>(
      mct::walk_groups<THREADS, false>(n_blocks, rows, iters,
                                       static_cast<size_t>(cap))
          .total);
}

extern "C" int mctpu_barrier(const float* par, int n_obs, int seed, int off,
                             int n_blocks, int rows, int iters, int antithetic,
                             int kahan, int up, int cap, float* scratch,
                             float* out, void* stream) {
  const int idx = (antithetic ? 4 : 0) | (kahan ? 2 : 0) | (up ? 1 : 0);
  return SPLIT_LAUNCHERS[idx](par, n_obs, static_cast<uint32_t>(seed),
                              static_cast<uint32_t>(off), n_blocks, rows,
                              iters, static_cast<size_t>(cap), scratch, out,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int mctpu_barrier_greeks(const float* scal, int n_obs, int seed,
                                    int off, int n_blocks, int rows, int iters,
                                    int antithetic, int kahan, int up,
                                    float* out, void* stream) {
  return run(scal, n_obs, seed, off, n_blocks, rows, iters, antithetic, kahan,
             up, 1, out, stream);
}

// par (log s0, k, log H, drift, vol at dt = t / n_fine) -> out (n_blocks, 2)
// of the level correction over n_fine (even) dates.
extern "C" int mctpu_barrier_level(const float* par, int n_fine, int seed,
                                   int off, int n_blocks, int rows, int iters,
                                   int antithetic, int kahan, int up,
                                   float* out, void* stream) {
  return run(par, n_fine, seed, off, n_blocks, rows, iters, antithetic, kahan,
             up, 2, out, stream);
}
