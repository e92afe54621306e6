// K27, K28 and K29: Heston Monte Carlo (full-truncation Euler or Andersen's
// QE), its pathwise Greeks and the multilevel (MLMC) level correction of the
// Euler walk.
//
// K27 replaces mctpu/kernels/heston.py::_heston_kernel (both schemes), K28
// ::_heston_greeks_kernel, K29 ::_level_kernel.  Per simulation block b and
// iteration i the stream is reseeded with (seed, (off + b) * iters + i) in
// int32 wrap; tile element e walks n_steps steps, step j drawing Philox
// block (e, j, 0, 0) and taking both Box-Muller branches, z_v (cosine) and
// z_perp (sine), in that step (mct::walk_steps); the antithetic mirror
// replays the same draws with the sign flipped, and the two mirrored
// outputs are averaged before they are summed.  Each path carries x = log(S / S0) and v.  K27 steps
// mct::heston_step (Euler) or qe_step below (mctpu/models/heston.py,
// qe_step) and pays max(s0 e^x - k, 0).  K28 steps mct::heston_greek_step
// with four tangent pairs and forms price, delta, vega (v0), rho, dtheta,
// dkappa and dxi (mctpu_torch/kernels/heston.py, _greek_quants): 7
// outputs, 14 sums.  K29 walks a fine path of n_fine = n0 2^l Euler steps
// and a coarse path of n_fine / 2 steps on the same increments: coarse step
// j draws Philox blocks (e, 2j) and (e, 2j + 1) (K27's stream at n_fine
// steps), takes the two fine steps on them and one coarse step on
// zc = (z1 + z2) / sqrt(2) for z_v and z_perp alike, the mirror's sign
// applied after the sum, and pays d = P(x_fine) - P(x_coarse): 2 sums.
//
// Built with -fmad=false (mctpu_torch/_build.py): each path rounds as the
// plain PyTorch version's separate operations do, with the same IEEE sqrtf
// and divisions and the same libm expf/logf, so the walk's branches fall on
// the same side as there: max(v, 0) and v > 0 in Euler, psi <= 1.5 (where
// the QE variance is not continuous), u (psi + 1) <= psi - 1 and the clip of
// u in QE, and S > K in the payoff (K29: in each of its two payoffs).  Only
// the block sums' order differs.
//
// Bound on the H100: the draws.  Per path-step one whole Philox block (10
// rounds of two 32-bit mul.hi/lo) and one Box-Muller pair (logf, sqrtf, the
// sin/cos polynomials), beside some 15 float32 operations and a sqrtf for
// Euler; QE adds an expf (the Hastings CDF), a logf in its exponential
// branch, two more sqrtf and three divides, and may be bound by them rather
// than by the integer pipe.  The walk is a serial dependence from step to
// step.  K27 and K29 are split walks (HestonWalk and HestonLevelWalk on
// mct::walk_split_kernel, csrc/common.cuh): one thread per path element of
// every (simulation block, iteration) item, so the grid fills the card on
// any plan (the MLMC 8 x 8 plan, which K27 runs at level 0 and K29 above
// it, ran on 8 SMs in the simple design), both antithetic signs advancing
// on one draw of each pair (the simple design drew and transformed every
// pair twice), the element's payoff (K29: its d) written to scratch;
// mct::walk_fold_kernel then adds them in the simple design's order (one
// CUDA block of 1024 threads per simulation block, each thread's Acc2 over
// its elements t, t + 1024, .. of every iteration, then write_block_sums'
// tree), so their block sums are that design's bit for bit.  K28 keeps the
// simple design: one CUDA block per simulation block, one thread per path
// element striding over the (rows, 128) tile, the state in registers,
// mct::BlockAccN once per iteration.  No atomics: two launches give the
// same bits.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;       // K27's and K29's folds
constexpr int GREEK_THREADS = 512;  // K28: 14 sums and 10 carries a thread
constexpr int N_SUMS = 14;
constexpr int N_EULER = 10;  // K27's scal: 10 Euler scalars, then QE_KEYS

// The QE constants, in mctpu_torch/models/heston.py's QE_KEYS order.
struct QeConst {
  float e, c1, c2, r_dt, k0, k1, k2, k3, k4, theta;
};

// One QE step of (x, v) in mctpu's qe_step order.  The branch not taken is
// not formed: mctpu forms both and selects, which gives the same value.
__device__ __forceinline__ void qe_step(const QeConst& c, float z_v, float z_s,
                                        float& x, float& v) {
  const float m = c.theta + (v - c.theta) * c.e;
  const float s2 = v * c.c1 + c.c2;
  const float inv_m = __fdiv_rn(1.0f, fmaxf(m, MCT_F32(1e-30)));
  const float psi = s2 * inv_m * inv_m;
  float v_new;
  if (psi <= 1.5f) {  // quadratic: a (b + z_v)^2
    const float two_over = __fdiv_rn(2.0f, psi);
    const float quad_arg = fmaxf(two_over * (two_over - 1.0f), 0.0f);
    const float b2 = two_over - 1.0f + sqrtf(quad_arg);
    const float a = __fdiv_rn(m, 1.0f + b2);
    const float w = sqrtf(b2) + z_v;
    v_new = a * (w * w);
  } else {  // exponential, its mass at zero drawn through u = Phi(z_v)
    const float psip1 = psi + 1.0f;
    const float u = fminf(fmaxf(mct::norm_cdf_hastings(z_v), 0.0f),
                          MCT_F32(1.0 - 1e-7));
    if (u * psip1 <= psi - 1.0f) {
      v_new = 0.0f;
    } else {
      const float log_arg =
          __fdiv_rn(2.0f, fmaxf(psip1 * (1.0f - u), MCT_F32(1e-30)));
      v_new = logf(log_arg) * (0.5f * m * psip1);
    }
  }
  x = x + c.r_dt + c.k0 + c.k1 * v + c.k2 * v_new +
      sqrtf(fmaxf(c.k3 * v + c.k4 * v_new, MCT_F32(1e-20))) * z_s;
  v = v_new;
}

struct Scal {
  float s0, k, v0;
  mct::HestonStep h;
  QeConst qe;
};

__device__ __forceinline__ Scal load_scal(const float* p) {
  const float* q = p + N_EULER;
  return Scal{p[0], p[1], p[2], mct::heston_consts(p + 3),
              QeConst{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8],
                      q[9]}};
}

// One K27 step of (x, v) on the pair (z_v, z_perp), in the scheme QE.
template <bool QE>
__device__ __forceinline__ void step(const Scal& c, float z_v, float z_perp,
                                     float& x, float& v) {
  if (QE) {
    qe_step(c.qe, z_v, z_perp, x, v);
  } else {
    mct::heston_step(c.h, z_v, z_perp, x, v);
  }
}

__device__ __forceinline__ float call_pay(const Scal& c, float x) {
  return fmaxf(c.s0 * expf(x) - c.k, 0.0f);
}

// K27's split walk (mct::walk_split_kernel): tile element e walks its
// n_steps steps once, drawing each Philox block once; under ANTI both
// signs' (x, v) advance on that draw (the mirror's normals -z, exactly the
// unsplit walk's sgn * z, so each sign rounds as it did there, QE's
// branches included), and the element's sample is the pair's mean
// 0.5 (p+ + p-).  The 20 scalars are staged in shared memory.
template <bool QE>
struct HestonWalk {
  struct Params {
    const float* scal;
    int n_steps;
  };
  static constexpr int SHARED = N_EULER + 10;
  static constexpr int MIN_BLOCKS = QE ? 8 : 16;  // 32 / 64 warps an SM

  __device__ static void stage(const Params& P, float* sh) {
    if (threadIdx.x < SHARED) sh[threadIdx.x] = P.scal[threadIdx.x];
  }

  template <bool ANTI>
  __device__ static float pay(const Params& P, const float* sh, mct::Key key,
                              uint32_t e) {
    const Scal c = load_scal(sh);
    float x = 0.0f, v = c.v0, xm = 0.0f, vm = c.v0;
    mct::walk_steps(key, e, P.n_steps, [&](int, float z_v, float z_perp) {
      step<QE>(c, z_v, z_perp, x, v);
      if (ANTI) step<QE>(c, -z_v, -z_perp, xm, vm);
    });
    const float p = call_pay(c, x);
    if (!ANTI) return p;
    return 0.5f * (p + call_pay(c, xm));
  }
};

// K28's scalars (mctpu_torch/kernels/heston.py, GREEK_SCAL).
struct GreekScal {
  float s0, k, v0;
  mct::HestonStep h;
  float half_dt, t_k, dt;
};

// One K28 walk of tile element e; q[] gets (p, delta, vega, rho, dtheta,
// dkappa, dxi).
__device__ __forceinline__ void greek_walk(const GreekScal& c, int n_steps,
                                           mct::Key key, uint32_t e,
                                           float sgn, float (&q)[7]) {
  float x = 0.0f, v = c.v0;
  float tg[8] = {0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  mct::walk_steps(key, e, n_steps, [&](int, float z_v, float z_perp) {
    mct::heston_greek_step(c.h, c.half_dt, c.dt, sgn * z_v, sgn * z_perp, x,
                           v, tg);
  });
  const float e_x = expf(x);
  const float st = c.s0 * e_x;
  const float ind = st > c.k ? 1.0f : 0.0f;
  const float ist = ind * st;
  q[0] = fmaxf(st - c.k, 0.0f);
  q[1] = ind * e_x;
  q[2] = ist * tg[0];
  q[3] = c.t_k * ind;
  q[4] = ist * tg[2];
  q[5] = ist * tg[4];
  q[6] = ist * tg[6];
}

template <bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(GREEK_THREADS)
    heston_greeks_kernel(const float* __restrict__ scal, int n_steps,
                         uint32_t seed, uint32_t off, int n_elems, int iters,
                         float* __restrict__ out) {
  __shared__ float sh[(GREEK_THREADS / 32) * N_SUMS];
  const GreekScal c{scal[0], scal[1], scal[2], mct::heston_consts(scal + 3),
                    scal[10], scal[11], scal[12]};
  mct::BlockAccN<GREEK_THREADS, N_SUMS, KAHAN> acc;
  float vs[N_SUMS];
#pragma unroll
  for (int j = 0; j < N_SUMS; ++j) vs[j] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const uint32_t word = (off + blockIdx.x) * static_cast<uint32_t>(iters) +
                          static_cast<uint32_t>(i);
    const mct::Key key = mct::seed_key(seed, word);
    for (int e = threadIdx.x; e < n_elems; e += GREEK_THREADS) {
      float q[7];
      greek_walk(c, n_steps, key, static_cast<uint32_t>(e), 1.0f, q);
      if (ANTI) {
        float m[7];
        greek_walk(c, n_steps, key, static_cast<uint32_t>(e), -1.0f, m);
#pragma unroll
        for (int j = 0; j < 7; ++j) q[j] = 0.5f * (q[j] + m[j]);
      }
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        vs[2 * j] += q[j];
        vs[2 * j + 1] += q[j] * q[j];
      }
    }
    acc.add(vs, nullptr, sh);
  }
  acc.write(out);
}

// K29's scalars (mctpu_torch/kernels/heston.py, LEVEL_SCAL): s0, k, v0,
// theta, xi, rho_c, rho_s, then kappa dt, r dt and sqrt(dt) of the fine and
// of the coarse step.
struct LevelScal {
  float s0, k, v0;
  mct::HestonStep fine, coarse;
};

__device__ __forceinline__ LevelScal load_level(const float* p) {
  return LevelScal{p[0], p[1], p[2],
                   mct::HestonStep{p[7], p[3], p[4], p[5], p[6], p[8], p[9]},
                   mct::HestonStep{p[10], p[3], p[4], p[5], p[6], p[11],
                                   p[12]}};
}

// One coarse step of K29's coupled walk on the draws z1 = (z1v, z1p), z2 =
// (z2v, z2p) of Philox blocks (e, 2j) and (e, 2j + 1), with the sign sgn
// (the mirror's -1): two fine steps on sgn z1 and sgn z2, one coarse step on
// sgn zc, zc = (z1 + z2) / sqrt(2) formed unsigned (a rounded add, then a
// rounded multiply) and the sign applied after.  s = (xf, vf, xc, vc).
__device__ __forceinline__ void level_step(const LevelScal& c, float z1v,
                                           float z1p, float z2v, float z2p,
                                           float sgn, float (&s)[4]) {
  const float inv_sqrt2 = MCT_F32(0.7071067811865476);
  mct::heston_step(c.fine, sgn * z1v, sgn * z1p, s[0], s[1]);
  mct::heston_step(c.fine, sgn * z2v, sgn * z2p, s[0], s[1]);
  const float zcv = (z1v + z2v) * inv_sqrt2;
  const float zcp = (z1p + z2p) * inv_sqrt2;
  mct::heston_step(c.coarse, sgn * zcv, sgn * zcp, s[2], s[3]);
}

// The payoff difference d = P(x_fine) - P(x_coarse) of a walk's state.
__device__ __forceinline__ float level_pay(const LevelScal& c,
                                           const float (&s)[4]) {
  return fmaxf(c.s0 * expf(s[0]) - c.k, 0.0f) -
         fmaxf(c.s0 * expf(s[2]) - c.k, 0.0f);
}

// K29's split walk (mct::walk_split_kernel): tile element e walks its
// n_coarse coarse steps once, drawing each pair of Philox blocks once;
// under ANTI both signs' fine and coarse states (8 floats) advance on that
// draw (the mirror's normals -z, exactly the unsplit walk's sgn * z), and
// the element's sample is the pair's mean 0.5 (d+ + d-).  The 13 level
// scalars are staged in shared memory.
struct HestonLevelWalk {
  struct Params {
    const float* scal;
    int n_coarse;
  };
  static constexpr int SHARED = 13;
  static constexpr int MIN_BLOCKS = 16;  // 64 warps an SM

  __device__ static void stage(const Params& P, float* sh) {
    if (threadIdx.x < SHARED) sh[threadIdx.x] = P.scal[threadIdx.x];
  }

  template <bool ANTI>
  __device__ static float pay(const Params& P, const float* sh, mct::Key key,
                              uint32_t e) {
    const LevelScal c = load_level(sh);
    float s[4] = {0.0f, c.v0, 0.0f, c.v0};
    float m[4] = {0.0f, c.v0, 0.0f, c.v0};
    for (int j = 0; j < P.n_coarse; ++j) {
      float z1v, z1p, z2v, z2p;
      mct::draw_normal_pair(key, e, static_cast<uint32_t>(2 * j), z1v, z1p);
      mct::draw_normal_pair(key, e, static_cast<uint32_t>(2 * j + 1), z2v,
                            z2p);
      level_step(c, z1v, z1p, z2v, z2p, 1.0f, s);
      if (ANTI) level_step(c, z1v, z1p, z2v, z2p, -1.0f, m);
    }
    const float d = level_pay(c, s);
    if (!ANTI) return d;
    return 0.5f * (d + level_pay(c, m));
  }
};

template <bool ANTI, bool KAHAN>
void launch_greeks(const float* scal, int n_steps, uint32_t seed,
                   uint32_t off, int n_blocks, int n_elems, int iters,
                   float* out, cudaStream_t stream) {
  heston_greeks_kernel<ANTI, KAHAN><<<n_blocks, GREEK_THREADS, 0, stream>>>(
      scal, n_steps, seed, off, n_elems, iters, out);
}

using GreekFn = void (*)(const float*, int, uint32_t, uint32_t, int, int,
                         int, float*, cudaStream_t);

// Indexed by antithetic << 1 | kahan.
constexpr GreekFn GREEK_LAUNCHERS[4] = {
    launch_greeks<false, false>, launch_greeks<false, true>,
    launch_greeks<true, false>,  launch_greeks<true, true>,
};

// K27's split walk and its fold (THREADS threads, each thread's Acc2, the
// unsplit kernel's order).
template <bool ANTI, bool KAHAN, bool QE>
int launch_walk(const float* scal, int n_steps, uint32_t seed, uint32_t off,
                int n_blocks, int rows, int iters, size_t cap, float* scratch,
                float* out, cudaStream_t s) {
  return mct::walk_split_launch<HestonWalk<QE>, THREADS, false, ANTI, KAHAN>(
      typename HestonWalk<QE>::Params{scal, n_steps}, seed, off, n_blocks,
      rows, iters, cap, scratch, out, s);
}

using WalkFn = int (*)(const float*, int, uint32_t, uint32_t, int, int, int,
                       size_t, float*, float*, cudaStream_t);

// Indexed by antithetic << 2 | kahan << 1 | qe.
constexpr WalkFn WALK_LAUNCHERS[8] = {
    launch_walk<false, false, false>, launch_walk<false, false, true>,
    launch_walk<false, true, false>,  launch_walk<false, true, true>,
    launch_walk<true, false, false>,  launch_walk<true, false, true>,
    launch_walk<true, true, false>,   launch_walk<true, true, true>,
};

// K29's split walk and its fold (THREADS threads, each thread's Acc2, the
// unsplit kernel's order).
template <bool ANTI, bool KAHAN>
int launch_level(const float* scal, int n_coarse, uint32_t seed, uint32_t off,
                 int n_blocks, int rows, int iters, size_t cap,
                 float* scratch, float* out, cudaStream_t s) {
  return mct::walk_split_launch<HestonLevelWalk, THREADS, false, ANTI, KAHAN>(
      HestonLevelWalk::Params{scal, n_coarse}, seed, off, n_blocks, rows,
      iters, cap, scratch, out, s);
}

using LevelFn = int (*)(const float*, int, uint32_t, uint32_t, int, int, int,
                        size_t, float*, float*, cudaStream_t);

// Indexed by antithetic << 1 | kahan.
constexpr LevelFn LEVEL_LAUNCHERS[4] = {
    launch_level<false, false>, launch_level<false, true>,
    launch_level<true, false>,  launch_level<true, true>,
};

}  // namespace

// Floats of scratch a K27 launch takes (cap: at most this many, 0 for 256
// MB; past it the blocks and iterations go in groups).
extern "C" int mctpu_heston_scratch_floats(int n_blocks, int rows, int iters,
                                           int cap) {
  return static_cast<int>(
      mct::walk_groups<THREADS, false>(n_blocks, rows, iters,
                                       static_cast<size_t>(cap))
          .total);
}

// scal (the 10 Euler scalars, then the 10 QE constants) -> out (n_blocks,
// 2); mode 1 takes the QE scheme, 0 Euler: the split walk and its fold,
// scratch of mctpu_heston_scratch_floats(.., cap) floats.
extern "C" int mctpu_heston(const float* scal, int n_steps, int seed, int off,
                            int n_blocks, int rows, int iters, int antithetic,
                            int kahan, int mode, int cap, float* scratch,
                            float* out, void* stream) {
  const int idx = (antithetic ? 4 : 0) | (kahan ? 2 : 0) | (mode ? 1 : 0);
  return WALK_LAUNCHERS[idx](scal, n_steps, static_cast<uint32_t>(seed),
                             static_cast<uint32_t>(off), n_blocks, rows,
                             iters, static_cast<size_t>(cap), scratch, out,
                             static_cast<cudaStream_t>(stream));
}

// scal (the 10 Euler scalars, half_dt, t_k, dt) -> out (n_blocks, 14).
// mode is unused (the single-asset walks' common signature).
extern "C" int mctpu_heston_greeks(const float* scal, int n_steps, int seed,
                                   int off, int n_blocks, int rows, int iters,
                                   int antithetic, int kahan, int /*mode*/,
                                   float* out, void* stream) {
  const int idx = (antithetic ? 2 : 0) | (kahan ? 1 : 0);
  GREEK_LAUNCHERS[idx](scal, n_steps, static_cast<uint32_t>(seed),
                       static_cast<uint32_t>(off), n_blocks,
                       rows * mct::LANES, iters, out,
                       static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch a K29 launch takes (cap: at most this many, 0 for 256
// MB; past it the blocks and iterations go in groups).
extern "C" int mctpu_heston_level_scratch_floats(int n_blocks, int rows,
                                                 int iters, int cap) {
  return static_cast<int>(
      mct::walk_groups<THREADS, false>(n_blocks, rows, iters,
                                       static_cast<size_t>(cap))
          .total);
}

// scal (LEVEL_SCAL, 13 floats) -> out (n_blocks, 2) of the level correction
// over n_fine (even) fine steps: the split walk and its fold, scratch of
// mctpu_heston_level_scratch_floats(.., cap) floats.
extern "C" int mctpu_heston_level(const float* scal, int n_fine, int seed,
                                  int off, int n_blocks, int rows, int iters,
                                  int antithetic, int kahan, int cap,
                                  float* scratch, float* out, void* stream) {
  const int idx = (antithetic ? 2 : 0) | (kahan ? 1 : 0);
  return LEVEL_LAUNCHERS[idx](scal, n_fine / 2, static_cast<uint32_t>(seed),
                              static_cast<uint32_t>(off), n_blocks, rows,
                              iters, static_cast<size_t>(cap), scratch, out,
                              static_cast<cudaStream_t>(stream));
}
