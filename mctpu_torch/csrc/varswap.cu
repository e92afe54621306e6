// K19 and K20: the variance swap's fair strike (K19) and its sensitivities
// (K20), one realized-variance walk per path, under GBM or Heston.
//
// K19 replaces mctpu/kernels/varswap.py::_varswap_kernel, K20
// ::_varswap_greeks_kernel, both legs (dynamics "gbm" and "heston"; mode 0
// and 1 of the entry points).  Every walk reseeds per (block, iteration)
// with (seed, (off + b) * iters + i).
//
// GBM: the stream is K9's and K12's (csrc/asian.cu): pairs of dates per
// Philox block, an odd n_obs taking the cosine branch of the last pair.
// Each path sums lr^2 (and, in K20, lr) with lr = drift + vol z over n_obs
// dates; K19 pays rv = acc / T, K20 forms (rv, vega, rho, theta) from the
// two sums in mctpu's _gbm_greek_quants order (mctpu_torch/kernels/
// varswap.py, _greek_quants).  The antithetic mirror's z is -z of the same
// draw: both signs step in one walk over one draw per date (the JAX kernel
// reseeds and draws again), and the pair's mean 0.5 (x + x_mirror) is
// formed before the sums, per quantity.
//
// Heston: the stream is K27's (csrc/heston.cu): one Philox block and both
// Box-Muller branches per date (mct::walk_steps).  Each path steps
// mct::heston_step and adds lr^2 with lr the step's increment of x = log(S /
// S0) (K19); K20 steps mct::heston_greek_step (K28's tangents) and also sums
// lr and 2 lr (al_p,new - al_p) per parameter p = v0, theta, kappa, xi, and
// pays (rv, dv0, dtheta, dkappa, dxi, rho = (2 dt / T) sum lr), each over T
// (mctpu's _heston_greek_walk).  Both step both signs on one draw, as
// GBM (the JAX kernels reseed and draw again for the mirror).
//
// Built with -fmad=false (mctpu_torch/_build.py), as every walk: a
// contracted drift + vol * z would round each log-return otherwise than the
// plain version does, and the Heston step has max(v, 0) and v > 0.  1 / v,
// sqrtf and the tangents' 1 / sqrt(vp) are IEEE (no fast math), as the
// plain version's.
//
// Bound on the H100: the draws.  GBM: per path-step half a Philox block (20
// 32-bit integer multiplies and XORs) and half a Box-Muller, beside 4 (K19)
// or 5 (K20) float32 operations.  Heston: a whole Philox block and a
// Box-Muller pair per path-step, beside the Euler step's ~15 float32
// operations and a sqrtf (K19) or the tangent step's ~45 and a sqrtf and a
// divide (K20): 252 dates make 126 (GBM) or 252 (Heston) Philox blocks a
// path.  K19 (both legs) is a split walk, as K12 and K27: one thread per
// path element of every (block, iteration) on the whole card, its sample
// to scratch, and a fold of THREADS threads a simulation block in the
// order of the simple design it replaced (each thread's mct::Acc2 over its
// elements t, t + THREADS, .. iteration by iteration, then the block's
// tree), so its block sums are that design's bit for bit.  K20's Heston
// leg is a split walk too, its six outputs an element folded by
// GREEK_THREADS threads a block into its (sum, sum^2) pairs, BlockAccN per
// iteration (the simple design's order).  K20's GBM leg keeps the simple
// design, as K13: one CUDA block per simulation block, one thread per path
// element striding over the (rows, 128) tile, state in registers,
// mct::BlockAccN per iteration.  No atomics: two launches give the same
// bits.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;        // K19
constexpr int GREEK_THREADS = 512;   // K20
constexpr int N_SUMS = 8;            // (sum, sum^2) of rv, vega, rho, theta

// K19: the realized variance of tile element e's path (the antithetic
// pair's mean when ANTI).
template <bool ANTI>
__device__ __forceinline__ float realized_variance(float inv_t, float drift,
                                                   float vol, int n_obs,
                                                   mct::Key key, uint32_t e) {
  float acc = 0.0f, acc_m = 0.0f;
  mct::walk_pairwise(key, e, n_obs, [&](int, float z) {
    const float lr = drift + vol * z;
    acc = acc + lr * lr;
    if (ANTI) {
      const float lm = drift + vol * (-z);
      acc_m = acc_m + lm * lm;
    }
  });
  const float rv = acc * inv_t;
  return ANTI ? 0.5f * (rv + acc_m * inv_t) : rv;
}

// K20's scalars (mctpu_torch/kernels/varswap.py, greek_params) and the
// products of them that _greek_quants forms, once per thread.
struct GreekScal {
  float inv_t, drift, vol, two_inv_t, inv_v, v_dt, rho_c, theta_c;
};

__device__ __forceinline__ GreekScal greek_scal(const float* scal) {
  const float inv_t = scal[0], drift = scal[1], v = scal[3], dt = scal[4];
  return GreekScal{inv_t,          drift,
                   scal[2],        2.0f * inv_t,
                   1.0f / v,       v * dt,
                   (2.0f * dt) * inv_t, (drift * inv_t) * inv_t};
}

// (rv, vega, rho, theta) of the two sums a2 = sum lr^2, a1 = sum lr.
__device__ __forceinline__ void greek_quants(const GreekScal& c, float a2,
                                             float a1, float (&q)[4]) {
  q[0] = a2 * c.inv_t;
  q[1] = c.two_inv_t * ((a2 - c.drift * a1) * c.inv_v - c.v_dt * a1);
  q[2] = c.rho_c * a1;
  q[3] = c.theta_c * a1;
}

template <bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(GREEK_THREADS)
    varswap_greeks_kernel(const float* __restrict__ scal, int n_obs,
                          uint32_t seed, uint32_t off, int n_elems, int iters,
                          float* __restrict__ out) {
  __shared__ float sh[(GREEK_THREADS / 32) * N_SUMS];
  const GreekScal c = greek_scal(scal);
  mct::BlockAccN<GREEK_THREADS, N_SUMS, KAHAN> acc;
  float v[N_SUMS];
#pragma unroll
  for (int j = 0; j < N_SUMS; ++j) v[j] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const uint32_t word = (off + blockIdx.x) * static_cast<uint32_t>(iters) +
                          static_cast<uint32_t>(i);
    const mct::Key key = mct::seed_key(seed, word);
    for (int e = threadIdx.x; e < n_elems; e += GREEK_THREADS) {
      float a2 = 0.0f, a1 = 0.0f, m2 = 0.0f, m1 = 0.0f;
      mct::walk_pairwise(key, static_cast<uint32_t>(e), n_obs,
                         [&](int, float z) {
                           const float lr = c.drift + c.vol * z;
                           a2 = a2 + lr * lr;
                           a1 = a1 + lr;
                           if (ANTI) {
                             const float lm = c.drift + c.vol * (-z);
                             m2 = m2 + lm * lm;
                             m1 = m1 + lm;
                           }
                         });
      float q[4];
      greek_quants(c, a2, a1, q);
      if (ANTI) {
        float qm[4];
        greek_quants(c, m2, m1, qm);
#pragma unroll
        for (int j = 0; j < 4; ++j) q[j] = 0.5f * (q[j] + qm[j]);
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

// K19 as split walks (mct::walk_split_kernel), the fold K19's unsplit order
// (THREADS threads, each thread's Acc2 over (iteration, element), then
// write_block_sums' tree), so the block sums are the simple design's bit
// for bit.  Each stages its scalars in shared memory.
//
// GBM: realized_variance above, one thread a path element.
struct VarswapGbmWalk {
  struct Params {
    const float* scal;
    int n_obs;
  };
  static constexpr int SHARED = 3;
  static constexpr int MIN_BLOCKS = 16;  // 64 warps an SM

  __device__ static void stage(const Params& P, float* sh) {
    if (threadIdx.x < SHARED) sh[threadIdx.x] = P.scal[threadIdx.x];
  }

  template <bool ANTI>
  __device__ static float pay(const Params& P, const float* sh, mct::Key key,
                              uint32_t e) {
    return realized_variance<ANTI>(sh[0], sh[1], sh[2], P.n_obs, key, e);
  }
};

// Heston: tile element e walks its n_obs dates once, drawing each Philox
// block once; under ANTI both signs' (x, v) advance on that draw, the
// mirror's normals -z_v and -z_perp (exactly the simple design's sgn * z,
// so each sign rounds as it did there), and the sample is the pair's mean
// 0.5 (rv+ + rv-), rv = acc / T.
struct VarswapHestonWalk {
  struct Params {
    const float* scal;
    int n_obs;
  };
  static constexpr int SHARED = 10;      // HESTON_SCAL
  static constexpr int MIN_BLOCKS = 12;  // 48 warps an SM, no spills

  __device__ static void stage(const Params& P, float* sh) {
    if (threadIdx.x < SHARED) sh[threadIdx.x] = P.scal[threadIdx.x];
  }

  template <bool ANTI>
  __device__ static float pay(const Params& P, const float* sh, mct::Key key,
                              uint32_t e) {
    // sh: 1/t, s0 (not read), v0, then the Euler step's seven constants
    const float inv_t = sh[0], v0 = sh[2];
    const mct::HestonStep h = mct::heston_consts(sh + 3);
    float x = 0.0f, v = v0, acc = 0.0f, xm = 0.0f, vm = v0, acc_m = 0.0f;
    mct::walk_steps(key, e, P.n_obs, [&](int, float z_v, float z_perp) {
      const float x_old = x;
      mct::heston_step(h, z_v, z_perp, x, v);
      const float lr = x - x_old;
      acc = acc + lr * lr;
      if (ANTI) {
        const float xm_old = xm;
        mct::heston_step(h, -z_v, -z_perp, xm, vm);
        const float lm = xm - xm_old;
        acc_m = acc_m + lm * lm;
      }
    });
    const float rv = acc * inv_t;
    return ANTI ? 0.5f * (rv + acc_m * inv_t) : rv;
  }
};

// K20's Heston scalars (mctpu_torch/kernels/varswap.py, HESTON_GREEK_SCAL).
struct HestonGreekScal {
  float inv_t, v0;
  mct::HestonStep h;
  float half_dt, dt;
};

// One sign's K20 Heston walk state: (x, v), K28's tangent pairs tg, the
// sums of lr^2 and lr, and of 2 lr (al_p,new - al_p) per parameter p.
struct HestonGreekState {
  float x, v, acc2, acc1;
  float tg[8];
  float dacc[4];

  __device__ __forceinline__ void init(float v0) {
    x = 0.0f;
    v = v0;
    acc2 = acc1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) tg[i] = i == 1 ? 1.0f : 0.0f;
#pragma unroll
    for (int p = 0; p < 4; ++p) dacc[p] = 0.0f;
  }

  // One date on the normals (z_v, z_perp) of this sign.
  __device__ __forceinline__ void step(const HestonGreekScal& c, float z_v,
                                       float z_perp) {
    const float x_old = x;
    const float al_old[4] = {tg[0], tg[2], tg[4], tg[6]};
    mct::heston_greek_step(c.h, c.half_dt, c.dt, z_v, z_perp, x, v, tg);
    const float lr = x - x_old;
    const float two_lr = 2.0f * lr;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      dacc[p] = dacc[p] + two_lr * (tg[2 * p] - al_old[p]);
    }
    acc2 = acc2 + lr * lr;
    acc1 = acc1 + lr;
  }

  // (rv, dv0, dtheta, dkappa, dxi, rho).
  __device__ __forceinline__ void pay(const HestonGreekScal& c,
                                      float (&q)[6]) const {
    q[0] = acc2 * c.inv_t;
#pragma unroll
    for (int p = 0; p < 4; ++p) q[1 + p] = dacc[p] * c.inv_t;
    q[5] = ((2.0f * c.dt) * c.inv_t) * acc1;
  }
};

// K20's Heston leg as a split walk (mct::walk_split_kernel): tile element
// e walks its n_obs dates, drawing each Philox block once; under ANTI
// both signs' states advance on that draw, the mirror's normals -z_v and
// -z_perp (exactly the simple design's sgn * z), and the element's six
// outputs are the pair's means 0.5 (q + m).  Its fold is
// walk_fold_kernel<GREEK_THREADS, KAHAN, true, 6>: the simple design's
// per-thread (sum q_k, sum q_k^2) pairs, BlockAccN per iteration.  (One
// (sign, path) item a thread, each drawing its path, came out 1.45x
// slower under antithetic on the H100.)
template <bool ANTI_>
struct VarswapHestonGreekWalk {
  struct Params {
    const float* scal;
    int n_obs;
  };
  static constexpr int N_OUT = 6;
  static constexpr int SHARED = 11;  // HESTON_GREEK_SCAL
  // 32 warps an SM at 64 registers; both signs' 32 floats of state at up
  // to 96 (72 taken: 28 warps).
  static constexpr int MIN_BLOCKS = ANTI_ ? 5 : 8;

  __device__ static void stage(const Params& P, float* sh) {
    if (threadIdx.x < SHARED) sh[threadIdx.x] = P.scal[threadIdx.x];
  }

  __device__ static HestonGreekScal scal(const float* sh) {
    return HestonGreekScal{sh[0], sh[1], mct::heston_consts(sh + 2), sh[9],
                           sh[10]};
  }

  template <bool ANTI>
  __device__ static void pay(const Params& P, const float* sh, mct::Key key,
                             uint32_t e, float (&q)[N_OUT]) {
    const HestonGreekScal c = scal(sh);
    HestonGreekState st, mi;
    st.init(c.v0);
    if (ANTI) mi.init(c.v0);
    mct::walk_steps(key, e, P.n_obs, [&](int, float z_v, float z_perp) {
      st.step(c, z_v, z_perp);
      if (ANTI) mi.step(c, -z_v, -z_perp);
    });
    st.pay(c, q);
    if (ANTI) {
      float m[N_OUT];
      mi.pay(c, m);
#pragma unroll
      for (int j = 0; j < N_OUT; ++j) q[j] = 0.5f * (q[j] + m[j]);
    }
  }
};

// K20: the GBM leg on the simple design, the Heston leg as a split walk
// and its fold (cap and scratch its groups').
template <bool ANTI, bool KAHAN>
int launch_greeks(const float* scal, int n_obs, uint32_t seed, uint32_t off,
                  int n_blocks, int rows, int iters, int heston, size_t cap,
                  float* scratch, float* out, cudaStream_t stream) {
  if (heston) {
    using Walk = VarswapHestonGreekWalk<ANTI>;
    return mct::walk_split_launch<Walk, GREEK_THREADS, true, ANTI, KAHAN>(
        typename Walk::Params{scal, n_obs}, seed, off, n_blocks, rows, iters,
        cap, scratch, out, stream);
  }
  varswap_greeks_kernel<ANTI, KAHAN><<<n_blocks, GREEK_THREADS, 0,
                                       stream>>>(
      scal, n_obs, seed, off, rows * mct::LANES, iters, out);
  return static_cast<int>(cudaGetLastError());
}

using GreekFn = int (*)(const float*, int, uint32_t, uint32_t, int, int, int,
                        int, size_t, float*, float*, cudaStream_t);

// Indexed by antithetic << 1 | kahan.
constexpr GreekFn GREEK_LAUNCHERS[4] = {
    launch_greeks<false, false>, launch_greeks<false, true>,
    launch_greeks<true, false>,  launch_greeks<true, true>,
};

// K19's split walk of the leg Walk and its fold (THREADS threads, each
// thread's Acc2, the simple design's order).
template <class Walk, bool ANTI, bool KAHAN>
int launch_walk(const float* scal, int n_obs, uint32_t seed, uint32_t off,
                int n_blocks, int rows, int iters, size_t cap, float* scratch,
                float* out, cudaStream_t s) {
  return mct::walk_split_launch<Walk, THREADS, false, ANTI, KAHAN>(
      typename Walk::Params{scal, n_obs}, seed, off, n_blocks, rows, iters,
      cap, scratch, out, s);
}

using WalkFn = int (*)(const float*, int, uint32_t, uint32_t, int, int, int,
                       size_t, float*, float*, cudaStream_t);

// Indexed by antithetic << 2 | kahan << 1 | heston.
constexpr WalkFn WALK_LAUNCHERS[8] = {
    launch_walk<VarswapGbmWalk, false, false>,
    launch_walk<VarswapHestonWalk, false, false>,
    launch_walk<VarswapGbmWalk, false, true>,
    launch_walk<VarswapHestonWalk, false, true>,
    launch_walk<VarswapGbmWalk, true, false>,
    launch_walk<VarswapHestonWalk, true, false>,
    launch_walk<VarswapGbmWalk, true, true>,
    launch_walk<VarswapHestonWalk, true, true>,
};

}  // namespace

// Floats of scratch a K19 launch takes, either leg (cap: at most this many,
// 0 for 256 MB; past it the blocks and iterations go in groups).
extern "C" int mctpu_varswap_scratch_floats(int n_blocks, int rows, int iters,
                                            int cap) {
  return static_cast<int>(
      mct::walk_groups<THREADS, false>(n_blocks, rows, iters,
                                       static_cast<size_t>(cap))
          .total);
}

// mode 0 (GBM): scal (1/t, drift, vol); mode 1 (Heston): scal (1/t, s0, v0,
// kappa dt, theta, xi, rho, sqrt(1 - rho^2), r dt, sqrt(dt)).  -> out
// (n_blocks, 2): the split walk and its fold, scratch of
// mctpu_varswap_scratch_floats(.., cap) floats.
extern "C" int mctpu_varswap(const float* scal, int n_obs, int seed, int off,
                             int n_blocks, int rows, int iters, int antithetic,
                             int kahan, int mode, int cap, float* scratch,
                             float* out, void* stream) {
  const int idx = (antithetic ? 4 : 0) | (kahan ? 2 : 0) | (mode ? 1 : 0);
  return WALK_LAUNCHERS[idx](scal, n_obs, static_cast<uint32_t>(seed),
                             static_cast<uint32_t>(off), n_blocks, rows,
                             iters, static_cast<size_t>(cap), scratch, out,
                             static_cast<cudaStream_t>(stream));
}

// Floats of scratch a K20 Heston launch takes (cap: at most this many, 0
// for 256 MB; past it the blocks and iterations go in groups); the GBM
// leg takes none.
extern "C" int mctpu_varswap_greeks_scratch_floats(int n_blocks, int rows,
                                                   int iters, int cap) {
  return static_cast<int>(
      mct::walk_groups<GREEK_THREADS, true,
                       VarswapHestonGreekWalk<true>::N_OUT>(
          n_blocks, rows, iters, static_cast<size_t>(cap))
          .total);
}

// mode 0 (GBM): scal (1/t, drift, vol, v, dt) -> out (n_blocks, 8); mode 1
// (Heston): scal (1/t, v0, kappa dt, theta, xi, rho, sqrt(1 - rho^2), r dt,
// sqrt(dt), dt / 2, dt) -> out (n_blocks, 12), the split walk and its fold,
// scratch of mctpu_varswap_greeks_scratch_floats(.., cap) floats.
extern "C" int mctpu_varswap_greeks(const float* scal, int n_obs, int seed,
                                    int off, int n_blocks, int rows, int iters,
                                    int antithetic, int kahan, int mode,
                                    int cap, float* scratch, float* out,
                                    void* stream) {
  const int idx = (antithetic ? 2 : 0) | (kahan ? 1 : 0);
  return GREEK_LAUNCHERS[idx](scal, n_obs, static_cast<uint32_t>(seed),
                              static_cast<uint32_t>(off), n_blocks, rows,
                              iters, mode, static_cast<size_t>(cap), scratch,
                              out, static_cast<cudaStream_t>(stream));
}
