// K45-K48: the control-variate kernels.  Each is a pricing kernel the port
// already has, plus a control variable c beside the payoff p and five
// centered moment sums a block instead of (sum p, sum p^2).  K49: the
// importance-sampled call, K1 with an exponentially tilted draw.
//
// K45 replaces mctpu/kernels/varred.py::_vanilla_cv_kernel: K1's stream
// and terminal draw (vanilla.cu), p = max(S_T - k, 0) and c = S_T.
// K46 replaces ::_asian_cv_kernel: K9's walk (asian.cu, reseeded per
// (block, iteration), the mirror replaying the draws), carrying sum S_j and
// sum log S_j; p the arithmetic payoff, c = max(exp(sum log S_j / n) - k, 0)
// the geometric one.  K47 replaces ::_basket_cv_am_kernel (<= 8 assets):
// K2's asset-major stream and mct::am_basket (basket.cuh); c the basket
// value.  K48 replaces ::_basket_cv_kernel (> 8 assets): K3's lane-packed
// stream and pass and mct::packed_baskets' operations in their order (a
// register-tiled product up to width 128); padded slots are never drawn.
//
// Per unit, p and c are pair-meaned under antithetic first; then, with the
// centers (p0, m) from the operands, cc = c - m and d = (p - p0) - cc, and
// the block sums (d, d^2, cc, cc^2, d cc) in mctpu's order (varred.py,
// _moment_sums).  d is the residual of two nearly equal terms: for a
// near-perfect control (the basket's beta is 1 + 6e-8) its spread is ~0.4%
// of the payoff's, so one contracted multiply-add in S_T moves it by a
// visible fraction.  This file builds with -fmad=false (_build.py): every
// per-unit value rounds as the plain version's separate operations do (K48's
// explicit fmaf in the L z product and the basket sum aside, as in K3).
//
// K49 replaces ::_is_kernel: K1's stream and terminal draw, each normal z
// shifted to zt = z + theta and its payoff max(s0 e^{mu + sig zt} - k, 0)
// weighted by the likelihood ratio e^{-theta zt + theta^2 / 2}
// (mctpu's _is_tile), the pair mean of z and -z under antithetic; the
// block's (sum p, sum p^2) as K1 sums them (mct::Acc2, one block tree).
// The weight is a second expf a path, and -fmad=false keeps its exponent
// -theta zt + theta^2 / 2 uncontracted, as the plain version rounds it.
//
// Bound on the H100: arithmetic, as K1, K9, K2 and K3 (the moments add ten
// float32 operations a unit).  Simple design, the parents' threads and
// loops: one CUDA block per simulation block; each thread sums its units of
// an iteration plainly, and mct::BlockAccN reduces the block's five sums
// once per iteration in a fixed tree and Kahan-adds them in the carrying
// threads (the JAX kernels' acc_add_n).  K48 is split into one CUDA block
// per (simulation block, iteration) and a fold that keeps that order, its
// L z a register-tiled product (see "K48" below).  No atomics: two
// launches give the same bits.
#include <algorithm>

#include "basket.cuh"

namespace {

constexpr int N_SUMS = 5;
constexpr int VAN_THREADS = 256;
constexpr int ASIAN_THREADS = 1024;
constexpr int AM_THREADS = 256;
constexpr int PK_THREADS = 128;
constexpr int MAX_AM_ASSETS = 8;
constexpr size_t SMEM_LIMIT = 96 * 1024;

// The five centered moments of one unit (p, c), added to v.
__device__ __forceinline__ void add_moments(float p, float c, float p0,
                                            float m, float (&v)[N_SUMS]) {
  const float cc = c - m;
  const float d = (p - p0) - cc;
  v[0] += d;
  v[1] += d * d;
  v[2] += cc;
  v[3] += cc * cc;
  v[4] += d * cc;
}

__device__ __forceinline__ void zero(float (&v)[N_SUMS]) {
#pragma unroll
  for (int j = 0; j < N_SUMS; ++j) v[j] = 0.0f;
}

// ---------------------------------------------------------------- K45

// (p, c) of one terminal draw z, pair-meaned under ANTI.
template <bool ANTI>
__device__ __forceinline__ void vanilla_pc(float s0, float k, float mu,
                                           float sig, float z, float& p,
                                           float& c) {
  const float st = s0 * expf(mu + sig * z);
  p = fmaxf(st - k, 0.0f);
  c = st;
  if (ANTI) {
    const float sm = s0 * expf(mu + sig * -z);
    p = 0.5f * (p + fmaxf(sm - k, 0.0f));
    c = 0.5f * (c + sm);
  }
}

template <bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(VAN_THREADS)
    vanilla_cv_kernel(const float* __restrict__ par, uint32_t seed,
                      uint32_t off, int n_elems, int iters,
                      float* __restrict__ out) {
  __shared__ float sh[(VAN_THREADS / 32) * N_SUMS];
  // par: s0, k, mu, sig, p0, m
  const float s0 = par[0], k = par[1], mu = par[2], sig = par[3];
  const float p0 = par[4], m = par[5];
  const mct::Key key = mct::seed_key(seed, off + blockIdx.x);
  mct::BlockAccN<VAN_THREADS, N_SUMS, KAHAN> acc;
  float v[N_SUMS];
  zero(v);
  for (int i = 0; i < iters; ++i) {
    for (int e = threadIdx.x; e < n_elems; e += VAN_THREADS) {
      float z1, z2, p, c;
      mct::draw_normal_pair(key, e, i, z1, z2);
      vanilla_pc<ANTI>(s0, k, mu, sig, z1, p, c);
      add_moments(p, c, p0, m, v);
      vanilla_pc<ANTI>(s0, k, mu, sig, z2, p, c);
      add_moments(p, c, p0, m, v);
    }
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
}

// ---------------------------------------------------------------- K46

// One walk of tile element e -> (arithmetic payoff, geometric payoff).
__device__ __forceinline__ void asian_pc(float log_s0, float k, float drift,
                                         float vol, float inv_n, int n_obs,
                                         mct::Key key, uint32_t e, float sgn,
                                         float& p, float& c) {
  float log_s = log_s0, sa = 0.0f, sl = 0.0f;
  mct::walk_pairwise(key, e, n_obs, [&](int, float z) {
    log_s = log_s + drift + vol * (sgn * z);
    sa = sa + expf(log_s);
    sl = sl + log_s;
  });
  p = fmaxf(sa * inv_n - k, 0.0f);
  c = fmaxf(expf(sl * inv_n) - k, 0.0f);
}

template <bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(ASIAN_THREADS)
    asian_cv_kernel(const float* __restrict__ scal, int n_obs, uint32_t seed,
                    uint32_t off, int n_elems, int iters,
                    float* __restrict__ out) {
  __shared__ float sh[(ASIAN_THREADS / 32) * N_SUMS];
  // scal: log s0, k, drift, vol, p0, m
  const float log_s0 = scal[0], k = scal[1], drift = scal[2], vol = scal[3];
  const float p0 = scal[4], m = scal[5];
  // mctpu's 1.0 / n_obs is a weakly typed Python float: a double rounded
  // to float.
  const float inv_n = MCT_F32(1.0 / n_obs);
  mct::BlockAccN<ASIAN_THREADS, N_SUMS, KAHAN> acc;
  float v[N_SUMS];
  zero(v);
  for (int i = 0; i < iters; ++i) {
    const uint32_t word = (off + blockIdx.x) * static_cast<uint32_t>(iters) +
                          static_cast<uint32_t>(i);
    const mct::Key key = mct::seed_key(seed, word);
    for (int e = threadIdx.x; e < n_elems; e += ASIAN_THREADS) {
      const uint32_t u = static_cast<uint32_t>(e);
      float p, c;
      asian_pc(log_s0, k, drift, vol, inv_n, n_obs, key, u, 1.0f, p, c);
      if (ANTI) {
        float pm, cm;
        asian_pc(log_s0, k, drift, vol, inv_n, n_obs, key, u, -1.0f, pm, cm);
        p = 0.5f * (p + pm);
        c = 0.5f * (c + cm);
      }
      add_moments(p, c, p0, m, v);
    }
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
}

// ---------------------------------------------------------------- K47

// (p, c) of one asset-major path from its A normals, pair-meaned under ANTI.
template <int A, bool ANTI>
__device__ __forceinline__ void am_pc(const float* z, const float* lt,
                                      const float* par, float k, float& p,
                                      float& c) {
  const float b = mct::am_basket<A>(z, lt, par, 1.0f);
  p = fmaxf(b - k, 0.0f);
  c = b;
  if (ANTI) {
    const float bm = mct::am_basket<A>(z, lt, par, -1.0f);
    p = 0.5f * (p + fmaxf(bm - k, 0.0f));
    c = 0.5f * (c + bm);
  }
}

template <int A, bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(AM_THREADS)
    basket_cv_am_kernel(const float* __restrict__ lt,
                        const float* __restrict__ par,
                        const float* __restrict__ scal, uint32_t seed,
                        uint32_t off, int n_elems, int iters,
                        float* __restrict__ out) {
  __shared__ float s_lt[A * A];
  __shared__ float s_par[4 * A];
  __shared__ float sh[(AM_THREADS / 32) * N_SUMS];
  for (int t = threadIdx.x; t < A * A; t += AM_THREADS) s_lt[t] = lt[t];
  for (int t = threadIdx.x; t < 4 * A; t += AM_THREADS) s_par[t] = par[t];
  __syncthreads();
  // scal: k, p0, m
  const float k = scal[0], p0 = scal[1], m = scal[2];
  const mct::Key key = mct::seed_key(seed, off + blockIdx.x);
  mct::BlockAccN<AM_THREADS, N_SUMS, KAHAN> acc;
  float v[N_SUMS];
  zero(v);
  for (int i = 0; i < iters; ++i) {
    for (int e = threadIdx.x; e < n_elems; e += AM_THREADS) {
      float za[A], zb[A], p, c;
#pragma unroll
      for (int q = 0; q < A; ++q) {
        mct::draw_normal_pair(key, e, static_cast<uint32_t>(i * A + q), za[q],
                              zb[q]);
      }
      am_pc<A, ANTI>(za, s_lt, s_par, k, p, c);
      add_moments(p, c, p0, m, v);
      am_pc<A, ANTI>(zb, s_lt, s_par, k, p, c);
      add_moments(p, c, p0, m, v);
    }
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
}

template <int A>
void launch_am(bool anti, bool kahan, const float* lt, const float* par,
               const float* scal, uint32_t seed, uint32_t off, int n_blocks,
               int n_elems, int iters, float* out, cudaStream_t s) {
  const dim3 g(n_blocks), b(AM_THREADS);
  if (anti) {
    if (kahan) basket_cv_am_kernel<A, true, true><<<g, b, 0, s>>>(lt, par, scal, seed, off, n_elems, iters, out);
    else basket_cv_am_kernel<A, true, false><<<g, b, 0, s>>>(lt, par, scal, seed, off, n_elems, iters, out);
  } else {
    if (kahan) basket_cv_am_kernel<A, false, true><<<g, b, 0, s>>>(lt, par, scal, seed, off, n_elems, iters, out);
    else basket_cv_am_kernel<A, false, false><<<g, b, 0, s>>>(lt, par, scal, seed, off, n_elems, iters, out);
  }
}

// ---------------------------------------------------------------- K48

// K48 runs as a split kernel and a fold.  The simple design's CUDA block of
// PK_THREADS threads walked one simulation block's iterations in series: per
// iteration, K3's chunks of chunk_rows rows (both branches' normals drawn
// into shared memory, padded slots not drawn), then unit q = 2 path + branch
// of a chunk (at most PK_THREADS of them) to thread q, which formed its
// basket values (mct::packed_baskets) and added its five moments into its
// per-thread sums, chunk after chunk; BlockAccN reduced them once per
// iteration (warp tree, warps in order) and Kahan-carried them.  Here one
// CUDA block takes one (simulation block b, iteration i) item: its key
// seed_key(seed, off + b), its draws (r0 * width + e, i), the same chunks
// and the same unit-to-thread map, so each thread's sums are the simple
// design's; it writes the iteration's row reduced over the block
// (mct::block_row, the same tree) into scratch [B][iters][1][5], and
// basket_cv_fold_kernel carries the rows over the iterations in order
// (mct::slice_fold with one slice, BlockAccN's Kahan form).  So the sums
// equal the simple design's bit for bit, and the main run's 512 blocks x 16
// iterations and the pilot's 8 x 102 become 8192 and 816 CUDA blocks.
//
// At width 128 (9-128 assets) the item's L z is the register-tiled
// product mct::tiled_item (basket.cuh, shared with K3): the simple design's
// chunks and unit-to-thread map, the basket values of packed_baskets bit
// for bit, and each unit's moments added in its thread (threads 128-255
// hold no unit: their zero sums enter block_row's tree after the first four
// warps' and leave each row as it was (x + 0 = x; only the sign of a zero
// row could change, which no Kahan carry or plain add from 0.0f keeps)).
// Past width 128 (a > 128) the item keeps the simple design's per-path
// code (basket_cv_path_kernel).
template <bool ANTI>
__global__ void __launch_bounds__(mct::TILED_THREADS, 2)
    basket_cv_tiled_kernel(const float* __restrict__ lt,
                           const float* __restrict__ par,
                           const float* __restrict__ scal, int a, int a_tile,
                           int chunk_rows, uint32_t seed, uint32_t off,
                           int rows, int iters, float* __restrict__ scratch) {
  __shared__ float sh[(mct::TILED_THREADS / 32) * N_SUMS];
  const int b = blockIdx.x / iters, i = blockIdx.x - b * iters;
  const float k = scal[0], p0 = scal[1], m = scal[2];
  float v[N_SUMS];
  zero(v);
  mct::tiled_item<ANTI>(
      lt, par, a, a_tile, chunk_rows, mct::seed_key(seed, off + b),
      static_cast<uint32_t>(i), rows,
      [&](int, int, float basket, float basket_m) {
        float p = fmaxf(basket - k, 0.0f), cv = basket;
        if (ANTI) {
          p = 0.5f * (p + fmaxf(basket_m - k, 0.0f));
          cv = 0.5f * (cv + basket_m);
        }
        add_moments(p, cv, p0, m, v);
      });
  mct::block_row<mct::TILED_THREADS, N_SUMS>(
      v, sh, scratch + static_cast<size_t>(blockIdx.x) * N_SUMS);
}

// Past width 128: the simple design's chunk (both branches' rows, odd row
// stride) and one thread per unit forming its basket values, per item.
template <bool ANTI>
__global__ void __launch_bounds__(PK_THREADS)
    basket_cv_path_kernel(const float* __restrict__ lt,
                          const float* __restrict__ par,
                          const float* __restrict__ scal, int a, int a_tile,
                          int width, int chunk_rows, uint32_t seed,
                          uint32_t off, int rows, int iters,
                          float* __restrict__ scratch) {
  extern __shared__ float smem[];
  __shared__ float sh[(PK_THREADS / 32) * N_SUMS];
  const int stride = width + 1;
  float* z1s = smem;
  float* z2s = smem + chunk_rows * stride;
  const int c_paths = width / a_tile;
  const float k = scal[0], p0 = scal[1], m = scal[2];
  const int b = blockIdx.x / iters, i = blockIdx.x - b * iters;
  const mct::Key key = mct::seed_key(seed, off + b);
  float v[N_SUMS];
  zero(v);
  for (int r0 = 0; r0 < rows; r0 += chunk_rows) {
    const int nr = min(chunk_rows, rows - r0);
    for (int e = threadIdx.x; e < nr * width; e += PK_THREADS) {
      const int row = e / width;
      const int lane = e - row * width;
      if (lane % a_tile < a) {
        float z1, z2;
        mct::draw_normal_pair(key, static_cast<uint32_t>(r0 * width + e),
                              static_cast<uint32_t>(i), z1, z2);
        z1s[row * stride + lane] = z1;
        z2s[row * stride + lane] = z2;
      }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < nr * c_paths * 2; q += PK_THREADS) {
      const int path = q >> 1;
      const int row = path / c_paths;
      const int pp = path - row * c_paths;
      const float* z = ((q & 1) ? z2s : z1s) + row * stride + pp * a_tile;
      float bk, bm;
      mct::packed_baskets<ANTI>(z, lt, par, a, bk, bm);
      float p = fmaxf(bk - k, 0.0f), cv = bk;
      if (ANTI) {
        p = 0.5f * (p + fmaxf(bm - k, 0.0f));
        cv = 0.5f * (cv + bm);
      }
      add_moments(p, cv, p0, m, v);
    }
    __syncthreads();
  }
  mct::block_row<PK_THREADS, N_SUMS>(
      v, sh, scratch + static_cast<size_t>(blockIdx.x) * N_SUMS);
}

// Simulation block b's five sums: its iteration rows Kahan-carried in order
// (plain under !KAHAN), as BlockAccN carried them.
template <bool KAHAN>
__global__ void basket_cv_fold_kernel(const float* __restrict__ scratch,
                                      int n_blocks, int iters,
                                      float* __restrict__ out) {
  mct::slice_fold<N_SUMS, KAHAN>(scratch, n_blocks, iters, 1, 0,
                                 blockIdx.x * blockDim.x + threadIdx.x, out,
                                 nullptr);
}

// ---------------------------------------------------------------- K49

// The likelihood-ratio-weighted payoff of one draw z; neg_th = -theta and
// half_th2 = 0.5 theta theta, as mctpu's -theta * zt + 0.5 * theta * theta
// rounds them.
__device__ __forceinline__ float is_pay(float s0, float k, float mu,
                                        float sig, float th, float neg_th,
                                        float half_th2, float z) {
  const float zt = z + th;
  const float lr = expf(neg_th * zt + half_th2);
  const float st = s0 * expf(mu + sig * zt);
  return fmaxf(st - k, 0.0f) * lr;
}

template <bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(VAN_THREADS)
    vanilla_is_kernel(const float* __restrict__ par, uint32_t seed,
                      uint32_t off, int n_elems, int iters,
                      float* __restrict__ out) {
  // par: s0, k, mu, sig, theta
  const float s0 = par[0], k = par[1], mu = par[2], sig = par[3];
  const float th = par[4];
  const float neg_th = -th, half_th2 = (0.5f * th) * th;
  const mct::Key key = mct::seed_key(seed, off + blockIdx.x);
  mct::Acc2<KAHAN> acc;
  for (int i = 0; i < iters; ++i) {
    for (int e = threadIdx.x; e < n_elems; e += VAN_THREADS) {
      float z[2];
      mct::draw_normal_pair(key, e, i, z[0], z[1]);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float p = is_pay(s0, k, mu, sig, th, neg_th, half_th2, z[b]);
        if (ANTI) {
          p = 0.5f * (p + is_pay(s0, k, mu, sig, th, neg_th, half_th2,
                                 -z[b]));
        }
        acc.add(p);
      }
    }
  }
  mct::write_block_sums<VAN_THREADS, KAHAN>(acc, out);
}

}  // namespace

extern "C" int mctpu_vanilla_cv(const float* par, int seed, int off,
                                int n_blocks, int rows, int iters,
                                int antithetic, int kahan, float* out,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  const uint32_t of = static_cast<uint32_t>(off);
  const int n = rows * mct::LANES;
  const dim3 g(n_blocks), b(VAN_THREADS);
  switch ((antithetic ? 2 : 0) | (kahan ? 1 : 0)) {
    case 0: vanilla_cv_kernel<false, false><<<g, b, 0, s>>>(par, sd, of, n, iters, out); break;
    case 1: vanilla_cv_kernel<false, true><<<g, b, 0, s>>>(par, sd, of, n, iters, out); break;
    case 2: vanilla_cv_kernel<true, false><<<g, b, 0, s>>>(par, sd, of, n, iters, out); break;
    default: vanilla_cv_kernel<true, true><<<g, b, 0, s>>>(par, sd, of, n, iters, out); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// K45's C signature.
extern "C" int mctpu_vanilla_is(const float* par, int seed, int off,
                                int n_blocks, int rows, int iters,
                                int antithetic, int kahan, float* out,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  const uint32_t of = static_cast<uint32_t>(off);
  const int n = rows * mct::LANES;
  const dim3 g(n_blocks), b(VAN_THREADS);
  switch ((antithetic ? 2 : 0) | (kahan ? 1 : 0)) {
    case 0: vanilla_is_kernel<false, false><<<g, b, 0, s>>>(par, sd, of, n, iters, out); break;
    case 1: vanilla_is_kernel<false, true><<<g, b, 0, s>>>(par, sd, of, n, iters, out); break;
    case 2: vanilla_is_kernel<true, false><<<g, b, 0, s>>>(par, sd, of, n, iters, out); break;
    default: vanilla_is_kernel<true, true><<<g, b, 0, s>>>(par, sd, of, n, iters, out); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The single-asset walks' C signature (mctpu_torch/kernels/common.py,
// launch_walk); mode is unused.
extern "C" int mctpu_asian_cv(const float* scal, int n_obs, int seed, int off,
                              int n_blocks, int rows, int iters,
                              int antithetic, int kahan, int /*mode*/,
                              float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  const uint32_t of = static_cast<uint32_t>(off);
  const int n = rows * mct::LANES;
  const dim3 g(n_blocks), b(ASIAN_THREADS);
  switch ((antithetic ? 2 : 0) | (kahan ? 1 : 0)) {
    case 0: asian_cv_kernel<false, false><<<g, b, 0, s>>>(scal, n_obs, sd, of, n, iters, out); break;
    case 1: asian_cv_kernel<false, true><<<g, b, 0, s>>>(scal, n_obs, sd, of, n, iters, out); break;
    case 2: asian_cv_kernel<true, false><<<g, b, 0, s>>>(scal, n_obs, sd, of, n, iters, out); break;
    default: asian_cv_kernel<true, true><<<g, b, 0, s>>>(scal, n_obs, sd, of, n, iters, out); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mctpu_basket_cv_am(const float* lt, const float* par,
                                  const float* scal, int n_assets, int seed,
                                  int off, int n_blocks, int rows, int iters,
                                  int antithetic, int kahan, float* out,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  const uint32_t of = static_cast<uint32_t>(off);
  const int n = rows * mct::LANES;
  const bool anti = antithetic != 0, kh = kahan != 0;
  switch (n_assets) {
    case 1: launch_am<1>(anti, kh, lt, par, scal, sd, of, n_blocks, n, iters, out, s); break;
    case 2: launch_am<2>(anti, kh, lt, par, scal, sd, of, n_blocks, n, iters, out, s); break;
    case 3: launch_am<3>(anti, kh, lt, par, scal, sd, of, n_blocks, n, iters, out, s); break;
    case 4: launch_am<4>(anti, kh, lt, par, scal, sd, of, n_blocks, n, iters, out, s); break;
    case 5: launch_am<5>(anti, kh, lt, par, scal, sd, of, n_blocks, n, iters, out, s); break;
    case 6: launch_am<6>(anti, kh, lt, par, scal, sd, of, n_blocks, n, iters, out, s); break;
    case 7: launch_am<7>(anti, kh, lt, par, scal, sd, of, n_blocks, n, iters, out, s); break;
    case MAX_AM_ASSETS: launch_am<MAX_AM_ASSETS>(anti, kh, lt, par, scal, sd, of, n_blocks, n, iters, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K48's scratch in floats: a row of five sums per (block, iteration).
extern "C" int mctpu_basket_cv_packed_scratch_floats(int n_blocks,
                                                     int iters) {
  return n_blocks * iters * N_SUMS;
}

extern "C" int mctpu_basket_cv_packed(const float* lt, const float* par,
                                      const float* scal, int n_assets,
                                      int a_tile, int width, int seed,
                                      int off, int n_blocks, int rows,
                                      int iters, int antithetic, int kahan,
                                      float* scratch, float* out,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  const uint32_t of = static_cast<uint32_t>(off);
  // K3's chunk: about one (path, branch) per summing thread, both branches'
  // rows within SMEM_LIMIT.
  const int c = width / a_tile;
  const size_t row_bytes = 2 * static_cast<size_t>(width + 1) * sizeof(float);
  int chunk = std::min(rows, std::max(1, PK_THREADS / (2 * c)));
  chunk = std::min<int>(chunk, static_cast<int>(SMEM_LIMIT / row_bytes));
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int items = n_blocks * iters;
  using Fn = void (*)(const float*, const float*, const float*, int, int,
                      int, uint32_t, uint32_t, int, int, float*);
  using PathFn = void (*)(const float*, const float*, const float*, int, int,
                          int, int, uint32_t, uint32_t, int, int, float*);
  if (width == mct::LANES) {
    const Fn fn = antithetic ? &basket_cv_tiled_kernel<true>
                             : &basket_cv_tiled_kernel<false>;
    const size_t smem = mct::tiled_smem_bytes(n_assets, antithetic != 0);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
      }
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    fn<<<items, mct::TILED_THREADS, smem, s>>>(lt, par, scal, n_assets,
                                               a_tile, chunk, sd, of, rows,
                                               iters, scratch);
  } else {
    const PathFn fn = antithetic ? &basket_cv_path_kernel<true>
                                 : &basket_cv_path_kernel<false>;
    const size_t smem = chunk * row_bytes;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    fn<<<items, PK_THREADS, smem, s>>>(lt, par, scal, n_assets, a_tile,
                                       width, chunk, sd, of, rows, iters,
                                       scratch);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int FOLD_THREADS = 128;
  const int fold_blocks = (n_blocks * N_SUMS + FOLD_THREADS - 1) / FOLD_THREADS;
  if (kahan) {
    basket_cv_fold_kernel<true><<<fold_blocks, FOLD_THREADS, 0, s>>>(
        scratch, n_blocks, iters, out);
  } else {
    basket_cv_fold_kernel<false><<<fold_blocks, FOLD_THREADS, 0, s>>>(
        scratch, n_blocks, iters, out);
  }
  return static_cast<int>(cudaGetLastError());
}
