// K9, K10 and K11: fused Asian-call Monte Carlo, its Greeks and the
// multilevel (MLMC) level correction of the observation count.
//
// K9 replaces mctpu/kernels/asian.py::_asian_kernel, K10
// ::_asian_greeks_kernel, K11 ::_asian_level_kernel.  Per simulation block
// b and iteration i the stream is reseeded with (seed, (off + b) * iters +
// i) in int32 wrap; tile element e walks the n_obs dates in pairs
// (mct::walk_pairwise), the antithetic mirror replaying the same draws with the sign flipped, and the
// two mirrored outputs are averaged before they are summed.  K9 carries the
// log-spot and the running sum of the spots (of the log-spots for the
// geometric average) and pays max(avg - k, 0).  K10 also carries the vega
// tangent sum, sum s_j t_j and sum s_j t_j^2 and the running scalars
// cj = c1 (j + 1) and tj = t_j, and forms price, pathwise delta, vega and
// rho, and the Stein-tilt gamma (mctpu/kernels/asian.py, _greek_quants):
// 5 outputs, 10 sums.  The geometric walk is a template of its own: it
// takes no expf per step and never touches racc/r2acc.  K11 walks
// nf = n0 2^l dates, one Box-Muller pair per coarse step j at counter j
// (mct::walk_steps over nf / 2 steps): the cosine drives the odd,
// fine-only date, the sine the shared date; the fine sum takes both dates,
// the coarse sum the shared one, in that order, and d = pay(accf / nf) -
// pay(accc / (nf / 2)): 2 sums.
//
// This file is built with -fmad=false (mctpu_torch/_build.py): no multiply
// is contracted into an FMA, so every per-path value rounds as the plain
// PyTorch version's separate operations do, and with the same libm expf/
// logf/sqrtf and IEEE division the two agree per path to the bit.  Only the
// block sums' order differs.  That matters because the Greeks' ITM
// indicator is discontinuous: one ulp on a path at avg ~ k flips a whole
// delta term.
//
// Bound on the H100: arithmetic and latency.  Per path-step: half a Philox
// block (10 rounds of two 32-bit mul.hi/lo), half a Box-Muller (logf,
// sqrtf, the sin/cos polynomials), one add chain and, arithmetic only, one
// expf; the walk is a serial dependence from date to date.  K9 keeps the
// simple design: one CUDA block per simulation block, one thread
// per path element striding over the (rows, 128) tile, the state in
// registers, mct::Acc2 and one fixed-order block tree; layout_for gives
// 128 blocks at 2^22 paths, one per SM.  K10 and K11 are split walks
// (AsianGreekWalk and AsianLevelWalk on mct::walk_split_kernel,
// csrc/common.cuh): one thread per path element of every (simulation
// block, iteration) item, so the grid fills all 132 SMs on any plan (the
// MLMC 8 x 8 plan ran K11 on 8 SMs in the simple design), both antithetic
// signs advancing on one draw of each pair (the simple design drew and
// transformed every pair twice), the element's outputs (K10: 5; K11: its
// d) written to scratch; mct::walk_fold_kernel then adds them in the
// simple design's order -- K10: one CUDA block of 512 threads per
// simulation block, thread t taking elements t, t + 512, .. of each
// iteration into its 10 plain sums, mct::BlockAccN once per iteration;
// K11: one CUDA block of 1024 threads, each thread's Acc2 over its
// elements t, t + 1024, .. of every iteration, then write_block_sums' tree
// -- so their block sums are that design's bit for bit.  No atomics: two
// launches give the same bits.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;       // K9, K11's fold
constexpr int GREEK_THREADS = 512;  // K10's fold: 10 sums a thread
constexpr int N_GREEK_SCAL = 12;    // K10's scal (GREEK_SCAL)

// max(avg - k, 0) of a running sum over n dates (an IEEE division).
template <bool GEO>
__device__ __forceinline__ float avg_payoff(float acc, int n, float k) {
  float avg = acc / static_cast<float>(n);
  if (GEO) avg = expf(avg);
  return fmaxf(avg - k, 0.0f);
}

// One K9 walk of tile element e -> its payoff.
template <bool GEO>
__device__ __forceinline__ float walk(float log_s0, float k, float drift,
                                      float vol, int n_obs, mct::Key key,
                                      uint32_t e, float sgn) {
  float log_s = log_s0, acc = 0.0f;
  mct::walk_pairwise(key, e, n_obs, [&](int, float z) {
    log_s = log_s + drift + vol * (sgn * z);
    acc = acc + (GEO ? log_s : expf(log_s));
  });
  return avg_payoff<GEO>(acc, n_obs, k);
}

// One coarse step of a K11 walk on the pair (z1, z2) (the mirror's (-z1,
// -z2)): the odd, fine-only date on z1, then the shared date on z2; the
// fine sum takes both dates, the coarse sum the shared one.
template <bool GEO>
__device__ __forceinline__ void level_step(float drift, float vol, float z1,
                                           float z2, float& log_s,
                                           float& accf, float& accc) {
  log_s = log_s + drift + vol * z1;
  accf = accf + (GEO ? log_s : expf(log_s));
  log_s = log_s + drift + vol * z2;
  const float x = GEO ? log_s : expf(log_s);
  accf = accf + x;
  accc = accc + x;
}

// K11's split walk (mct::walk_split_kernel, one output): tile element e
// walks its n_coarse steps once, one Box-Muller pair a step at counter j
// (mct::walk_steps); under ANTI both signs' log-spot and sums advance on
// that draw (the mirror's normals -z1, -z2, exactly the simple design's
// sgn * z), and the sample is the pair's mean 0.5 (d+ + d-) with d =
// pay(accf / nf) - pay(accc / nc).  The four level scalars are staged in
// shared memory; the geometric walk is an instance of its own (no expf a
// date).
template <bool GEO>
struct AsianLevelWalk {
  struct Params {
    const float* scal;  // log s0, k, drift, vol (at dt = t / n_fine)
    int n_coarse;
  };
  static constexpr int SHARED = 4;
  static constexpr int MIN_BLOCKS = 16;  // 64 warps an SM

  __device__ static void stage(const Params& P, float* sh) {
    if (threadIdx.x < SHARED) sh[threadIdx.x] = P.scal[threadIdx.x];
  }

  template <bool ANTI>
  __device__ static float pay(const Params& P, const float* sh, mct::Key key,
                              uint32_t e) {
    const float log_s0 = sh[0], k = sh[1], drift = sh[2], vol = sh[3];
    float log_s = log_s0, accf = 0.0f, accc = 0.0f;
    float log_m = log_s0, accf_m = 0.0f, accc_m = 0.0f;
    mct::walk_steps(key, e, P.n_coarse, [&](int, float z1, float z2) {
      level_step<GEO>(drift, vol, z1, z2, log_s, accf, accc);
      if (ANTI) level_step<GEO>(drift, vol, -z1, -z2, log_m, accf_m, accc_m);
    });
    auto level_d = [&](float f, float c) {
      return avg_payoff<GEO>(f, 2 * P.n_coarse, k) -
             avg_payoff<GEO>(c, P.n_coarse, k);
    };
    const float d = level_d(accf, accc);
    if (!ANTI) return d;
    return 0.5f * (d + level_d(accf_m, accc_m));
  }
};

template <bool ANTI, bool KAHAN, bool GEO>
__global__ void __launch_bounds__(THREADS)
    asian_kernel(const float* __restrict__ par, int n_obs, uint32_t seed,
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
      float p = walk<GEO>(log_s0, k, drift, vol, n_obs, key, u, 1.0f);
      if (ANTI) {
        p = 0.5f * (p + walk<GEO>(log_s0, k, drift, vol, n_obs, key, u,
                                  -1.0f));
      }
      acc.add(p);
    }
  }
  mct::write_block_sums<THREADS, KAHAN>(acc, out);
}

// K10's scalars (mctpu_torch/kernels/asian.py, GREEK_SCAL), then the
// JAX kernel's in-kernel scalars inv_n, sqt_v and inv_s02.
struct GreekScal {
  float log_s0, s0, k, drift, vol, inv_v, c1, dt, t, tbar, zc0, ivst;
  float inv_n, sqt_v, inv_s02;
};

__device__ __forceinline__ GreekScal load_greek(const float* p) {
  return GreekScal{p[0], p[1], p[2],  p[3],  p[4],  p[5],  p[6], p[7],
                   p[8], p[9], p[10], p[11], p[12], p[13], p[14]};
}

// One sign's carries of a K10 walk: the log-spot, the running sum of the
// spots (log-spots for GEO), the vega tangent sum and, arithmetic only,
// sum s_j t_j and sum s_j t_j^2.
struct GreekState {
  float log_s, acc, gacc, racc, r2acc;
};

// One date of a K10 walk on the normal z (the mirror's -z), at the running
// scalars cj = c1 (j + 1) and tj = t_j, which both signs share.
template <bool GEO>
__device__ __forceinline__ void greek_step(const GreekScal& c, float z,
                                           float cj, float tj,
                                           GreekState& g) {
  g.log_s = g.log_s + c.drift + c.vol * z;
  const float f = (g.log_s - c.log_s0) * c.inv_v + cj;
  if (GEO) {
    g.acc = g.acc + g.log_s;
    g.gacc = g.gacc + f;
  } else {
    const float s = expf(g.log_s);
    const float st = s * tj;
    g.acc = g.acc + s;
    g.gacc = g.gacc + s * f;
    g.racc = g.racc + st;
    g.r2acc = g.r2acc + st * tj;
  }
}

// (p, gd, gv, gr, gg) of a walk's carries (mctpu/kernels/asian.py,
// _greek_quants).
template <bool GEO>
__device__ __forceinline__ void greek_quants(const GreekScal& c,
                                             const GreekState& g,
                                             float (&q)[5]) {
  float avg = g.acc * c.inv_n;
  if (GEO) avg = expf(avg);
  const float ind = avg > c.k ? 1.0f : 0.0f;
  const float p = fmaxf(avg - c.k, 0.0f);
  const float z = (g.log_s - c.log_s0 - c.zc0) * c.ivst;
  q[0] = p;
  q[1] = __fdiv_rn(ind * avg, c.s0);
  if (GEO) {
    q[2] = ind * (avg * g.gacc * c.inv_n);
    q[3] = ind * (avg * c.tbar) - c.t * p;
    q[4] = ind * (avg * c.inv_s02) * (__fdiv_rn(c.sqt_v, c.tbar) * z - 1.0f);
  } else {
    const float m = g.racc * c.inv_n;
    const float r2n = g.r2acc * c.inv_n;
    q[2] = ind * (g.gacc * c.inv_n);
    q[3] = ind * m - c.t * p;
    // h = Abar^2 / (dA/dz); IEEE division (m >= t_1 avg > 0).
    const float h = __fdiv_rn(c.sqt_v * (avg * avg) * c.inv_s02, m);
    const float dh = c.inv_s02 * (2.0f * avg - __fdiv_rn((avg * avg) * r2n,
                                                           m * m));
    q[4] = ind * (h * z - dh);
  }
}

// K10's split walk (mct::walk_split_kernel, 5 outputs an element): tile
// element e walks its n_obs dates once, drawing each pair once; under ANTI
// both signs' carries advance on that draw (the mirror's normal -z,
// exactly the unsplit walk's sgn * z, so each sign rounds as it did there
// and the in-the-money indicator falls on the same side), the running
// scalars cj and tj once for both, and each output is the pair's mean
// 0.5 (q+ + q-).  The 12 scalars and the 3 formed from them are staged in
// shared memory; the geometric walk is an instance of its own (no expf a
// date, no racc / r2acc).
struct GreekParams {
  const float* scal;
  int n_obs;
};

template <bool GEO>
struct AsianGreekWalk {
  using Params = GreekParams;
  static constexpr int N_OUT = 5;
  static constexpr int SHARED = N_GREEK_SCAL + 3;
  static constexpr int MIN_BLOCKS = 8;  // 32 warps an SM

  // The JAX kernel's in-kernel scalars, formed as the simple kernel formed
  // them: 1.0 / n_obs is a double rounded to float (a weakly typed Python
  // float there).
  __device__ static void stage(const Params& P, float* sh) {
    const int t = threadIdx.x;
    if (t < N_GREEK_SCAL) sh[t] = P.scal[t];
    if (t == 0) {
      const float s0 = P.scal[1], t_mat = P.scal[8], ivst = P.scal[11];
      sh[N_GREEK_SCAL] = MCT_F32(1.0 / P.n_obs);
      sh[N_GREEK_SCAL + 1] = t_mat * ivst;
      sh[N_GREEK_SCAL + 2] = __fdiv_rn(1.0f, s0 * s0);
    }
  }

  template <bool ANTI>
  __device__ static void pay(const Params& P, const float* sh, mct::Key key,
                             uint32_t e, float (&q)[N_OUT]) {
    const GreekScal c = load_greek(sh);
    GreekState g{c.log_s0, 0.0f, 0.0f, 0.0f, 0.0f};
    GreekState m = g;
    float cj = c.c1, tj = c.dt;
    mct::walk_pairwise(key, e, P.n_obs, [&](int, float z) {
      greek_step<GEO>(c, z, cj, tj, g);
      if (ANTI) greek_step<GEO>(c, -z, cj, tj, m);
      if (!GEO) tj = tj + c.dt;
      cj = cj + c.c1;
    });
    greek_quants<GEO>(c, g, q);
    if (ANTI) {
      float qm[N_OUT];
      greek_quants<GEO>(c, m, qm);
#pragma unroll
      for (int j = 0; j < N_OUT; ++j) q[j] = 0.5f * (q[j] + qm[j]);
    }
  }
};

template <bool ANTI, bool KAHAN, bool GEO>
void launch(const float* scal, int n_obs, uint32_t seed, uint32_t off,
            int n_blocks, int n_elems, int iters, float* out,
            cudaStream_t stream) {
  asian_kernel<ANTI, KAHAN, GEO><<<n_blocks, THREADS, 0, stream>>>(
      scal, n_obs, seed, off, n_elems, iters, out);
}

using LaunchFn = void (*)(const float*, int, uint32_t, uint32_t, int, int,
                          int, float*, cudaStream_t);

// Indexed by antithetic << 2 | kahan << 1 | geometric.
constexpr LaunchFn LAUNCHERS[8] = {
    launch<false, false, false>, launch<false, false, true>,
    launch<false, true, false>,  launch<false, true, true>,
    launch<true, false, false>,  launch<true, false, true>,
    launch<true, true, false>,   launch<true, true, true>,
};

// K10's split walk and its fold (GREEK_THREADS threads, BlockAccN of the 10
// sums once per iteration: the unsplit kernel's order).
template <bool ANTI, bool KAHAN, bool GEO>
int launch_greeks(const float* scal, int n_obs, uint32_t seed, uint32_t off,
                  int n_blocks, int rows, int iters, size_t cap,
                  float* scratch, float* out, cudaStream_t s) {
  return mct::walk_split_launch<AsianGreekWalk<GEO>, GREEK_THREADS, true,
                                ANTI, KAHAN>(GreekParams{scal, n_obs}, seed,
                                             off, n_blocks, rows, iters, cap,
                                             scratch, out, s);
}

using GreekFn = int (*)(const float*, int, uint32_t, uint32_t, int, int, int,
                        size_t, float*, float*, cudaStream_t);

// Indexed by antithetic << 2 | kahan << 1 | geometric.
constexpr GreekFn GREEK_LAUNCHERS[8] = {
    launch_greeks<false, false, false>, launch_greeks<false, false, true>,
    launch_greeks<false, true, false>,  launch_greeks<false, true, true>,
    launch_greeks<true, false, false>,  launch_greeks<true, false, true>,
    launch_greeks<true, true, false>,   launch_greeks<true, true, true>,
};

// K11's split walk and its fold (THREADS threads, each thread's Acc2, the
// unsplit kernel's order).
template <bool ANTI, bool KAHAN, bool GEO>
int launch_level(const float* scal, int n_coarse, uint32_t seed,
                 uint32_t off, int n_blocks, int rows, int iters, size_t cap,
                 float* scratch, float* out, cudaStream_t s) {
  return mct::walk_split_launch<AsianLevelWalk<GEO>, THREADS, false, ANTI,
                                KAHAN>(
      typename AsianLevelWalk<GEO>::Params{scal, n_coarse}, seed, off,
      n_blocks, rows, iters, cap, scratch, out, s);
}

// Indexed by antithetic << 2 | kahan << 1 | geometric.
constexpr GreekFn LEVEL_LAUNCHERS[8] = {
    launch_level<false, false, false>, launch_level<false, false, true>,
    launch_level<false, true, false>,  launch_level<false, true, true>,
    launch_level<true, false, false>,  launch_level<true, false, true>,
    launch_level<true, true, false>,   launch_level<true, true, true>,
};

}  // namespace

extern "C" int mctpu_asian(const float* par, int n_obs, int seed, int off,
                           int n_blocks, int rows, int iters, int antithetic,
                           int kahan, int geometric, float* out,
                           void* stream) {
  const int idx = (antithetic ? 4 : 0) | (kahan ? 2 : 0) | (geometric ? 1 : 0);
  LAUNCHERS[idx](par, n_obs, static_cast<uint32_t>(seed),
                 static_cast<uint32_t>(off), n_blocks, rows * mct::LANES,
                 iters, out, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch a K10 launch takes (cap: at most this many, 0 for 256
// MB; past it the blocks and iterations go in groups).
extern "C" int mctpu_asian_greeks_scratch_floats(int n_blocks, int rows,
                                                 int iters, int cap) {
  return static_cast<int>(
      mct::walk_groups<GREEK_THREADS, true, AsianGreekWalk<false>::N_OUT>(
          n_blocks, rows, iters, static_cast<size_t>(cap))
          .total);
}

// scal (GREEK_SCAL, 12 floats) -> out (n_blocks, 10): the split walk and
// its fold, scratch of mctpu_asian_greeks_scratch_floats(.., cap) floats.
extern "C" int mctpu_asian_greeks(const float* scal, int n_obs, int seed,
                                  int off, int n_blocks, int rows, int iters,
                                  int antithetic, int kahan, int geometric,
                                  int cap, float* scratch, float* out,
                                  void* stream) {
  const int idx = (antithetic ? 4 : 0) | (kahan ? 2 : 0) | (geometric ? 1 : 0);
  return GREEK_LAUNCHERS[idx](scal, n_obs, static_cast<uint32_t>(seed),
                              static_cast<uint32_t>(off), n_blocks, rows,
                              iters, static_cast<size_t>(cap), scratch, out,
                              static_cast<cudaStream_t>(stream));
}

// Floats of scratch a K11 launch takes (cap: at most this many, 0 for 256
// MB; past it the blocks and iterations go in groups).
extern "C" int mctpu_asian_level_scratch_floats(int n_blocks, int rows,
                                                int iters, int cap) {
  return static_cast<int>(
      mct::walk_groups<THREADS, false>(n_blocks, rows, iters,
                                       static_cast<size_t>(cap))
          .total);
}

// par (log s0, k, drift, vol at dt = t / n_fine) -> out (n_blocks, 2) of the
// level correction over n_fine (even) dates: the split walk and its fold,
// scratch of mctpu_asian_level_scratch_floats(.., cap) floats.
extern "C" int mctpu_asian_level(const float* par, int n_fine, int seed,
                                 int off, int n_blocks, int rows, int iters,
                                 int antithetic, int kahan, int geometric,
                                 int cap, float* scratch, float* out,
                                 void* stream) {
  const int idx = (antithetic ? 4 : 0) | (kahan ? 2 : 0) | (geometric ? 1 : 0);
  return LEVEL_LAUNCHERS[idx](par, n_fine / 2, static_cast<uint32_t>(seed),
                              static_cast<uint32_t>(off), n_blocks, rows,
                              iters, static_cast<size_t>(cap), scratch, out,
                              static_cast<cudaStream_t>(stream));
}
