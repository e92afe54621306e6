// K21 and K22: the strike ladder, K vanilla payoffs (K21) or their six Greek
// integrands (K22) from one terminal draw per path.
//
// K21 replaces mctpu/kernels/ladder.py::_ladder_kernel, K22
// _ladder_greeks_kernel.  K1's stream: per simulation block b seed (seed,
// off + b); in iteration i tile element e draws Philox block (e, i, 0, 0)
// and both Box-Muller branches are terminal draws.  Per draw the shared
// values are formed once (K21: st = s0 exp(mu + sig z); K22 also the vega
// weight wv = sqt z - v t and the theta weight q = a + b z), then every
// strike k_m adds its terms: K21 max(+-(st - k_m), 0), the antithetic pair
// as (p(z) + p(-z)) / 2; K22 the price, pathwise delta, vega, rho, theta and
// the likelihood-ratio gamma (mctpu's _greek_ladder_quants), each pair-
// meaned after the sum.  (sum x, sum x^2) per strike: (B, K, 2) or
// (B, K, 12).
//
// Bound on the H100: arithmetic.  K21 adds ~4 float32 operations per path
// and strike to K1's draw and expf; K22 ~24 (four multiplies, the theta
// FMA, the indicator and its selects, the squares and adds).
//
// Simple design: up to 64 strikes carry 128 or 768 sums per simulation
// block, more than one thread's registers, so the grid is two-dimensional:
// blockIdx.x the simulation block, blockIdx.y a group of G strikes (16 in
// K21, 4 in K22).  Every group's CUDA block redraws the simulation block's
// normals (the stream is counter-based, so each sees the identical z), sums
// its own strikes plainly per thread, and mct::BlockAccN reduces them once
// per iteration in a fixed tree and Kahan-adds them across iterations (the
// JAX kernels' acc_add_n).  A group writes its own columns of out[b, :, :];
// a last group that is not full skips its missing strikes.  No atomics: two
// launches give the same bits.  The redraw costs one Philox block and one
// Box-Muller pair per pair of paths and group (PERF.md).
//
// Built without FMA contraction (-fmad=false, mctpu_torch/_build.py), so
// every path rounds as the plain version's separate operations: contracted,
// s0 e - k kept the unrounded product and moved a deep out-of-the-money
// payoff by an ulp of st (1.4e-5 of a block's sum at k = 50), and the
// antithetic pair cg (ind z) + cg (ind (-z)) left a rounding residual where
// the plain version cancels exactly (a deep in-the-money gamma column).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_STRIKES = 64;
constexpr int PRICE_GROUP = 16;  // K21: 32 sums per CUDA block
constexpr int GREEK_GROUP = 4;   // K22: 48 sums per CUDA block
constexpr int N_GREEK = 12;      // (sum, sum^2) of p, delta, vega, rho,
                                 // theta, gamma

template <bool PUT>
__device__ __forceinline__ float pay(float st, float k) {
  return PUT ? fmaxf(k - st, 0.0f) : fmaxf(st - k, 0.0f);
}

// ---------------------------------------------------------------- K21 price

// One draw z: every strike j < m of the group adds its payoff (pair-meaned
// under antithetic) and its square.
template <bool ANTI, bool PUT, int G>
__device__ __forceinline__ void price_add(float s0, float mu, float sig,
                                          const float (&k)[G], int m, float z,
                                          float (&v)[2 * G]) {
  const float st = s0 * expf(mu + sig * z);
  const float sm = ANTI ? s0 * expf(mu - sig * z) : 0.0f;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j < m) {
      float p = pay<PUT>(st, k[j]);
      if (ANTI) p = 0.5f * (p + pay<PUT>(sm, k[j]));
      v[2 * j] += p;
      v[2 * j + 1] += p * p;
    }
  }
}

template <bool ANTI, bool PUT, bool KAHAN>
__global__ void __launch_bounds__(THREADS)
    ladder_kernel(const float* __restrict__ par, const float* __restrict__ ks,
                  int n_k, uint32_t seed, uint32_t off, int n_elems, int iters,
                  float* __restrict__ out) {
  constexpr int G = PRICE_GROUP;
  constexpr int N = 2 * G;
  __shared__ float sh[WARPS * N];
  const mct::Key key = mct::seed_key(seed, off + blockIdx.x);
  const int g0 = blockIdx.y * G;
  const int m = min(G, n_k - g0);
  const float s0 = par[0], mu = par[1], sig = par[2];
  float k[G];
#pragma unroll
  for (int j = 0; j < G; ++j) k[j] = j < m ? ks[g0 + j] : 0.0f;
  mct::BlockAccN<THREADS, N, KAHAN> acc;
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    for (int e = threadIdx.x; e < n_elems; e += THREADS) {
      float z1, z2;
      mct::draw_normal_pair(key, e, i, z1, z2);
      price_add<ANTI, PUT, G>(s0, mu, sig, k, m, z1, v);
      price_add<ANTI, PUT, G>(s0, mu, sig, k, m, z2, v);
    }
    acc.add(v, nullptr, sh);
  }
  acc.write_n(out + (static_cast<size_t>(blockIdx.x) * n_k + g0) * 2, 2 * m);
}

// ---------------------------------------------------------------- K22 Greeks

// par: s0, mu, sig, v, t, sqt, r, 1/s0, 1/(s0^2 v sqt) (greek_params), plus
// the launch constants the JAX kernel forms from them.
struct GreekPar {
  float s0, mu, sig, v, t, sqt, r, inv_s0, cg_over_k;
  float a, b, vt;  // r - v^2/2, 0.5 v / sqt, v t
};

// The six integrands of strike k on one side of a draw (mctpu
// _greek_ladder_quants): st, wv and q shared by every strike, zz the signed
// normal of the gamma weight, cg = cg_over_k k and tk = t k.
template <bool PUT>
__device__ __forceinline__ void greek_quants(const GreekPar& P, float st,
                                             float zz, float wv, float q,
                                             float k, float cg, float tk,
                                             float (&x)[6]) {
  float ind, p;
  if (PUT) {
    ind = st < k ? -1.0f : 0.0f;
    p = fmaxf(k - st, 0.0f);
  } else {
    ind = st > k ? 1.0f : 0.0f;
    p = fmaxf(st - k, 0.0f);
  }
  const float w = ind * st;
  x[0] = p;
  x[1] = w * P.inv_s0;
  x[2] = w * wv;
  x[3] = tk * ind;
  x[4] = w * q - P.r * p;
  x[5] = cg * (ind * zz);
}

template <bool ANTI, bool PUT, int G>
__device__ __forceinline__ void greek_add(const GreekPar& P,
                                          const float (&k)[G],
                                          const float (&cg)[G],
                                          const float (&tk)[G], int m,
                                          float z, float (&v)[N_GREEK * G]) {
  const float st = P.s0 * expf(P.mu + P.sig * z);
  const float wv = P.sqt * z - P.vt;
  const float q = P.a + P.b * z;
  float stm = 0.0f, wvm = 0.0f, qm = 0.0f;
  if (ANTI) {
    stm = P.s0 * expf(P.mu + P.sig * -z);
    wvm = P.sqt * -z - P.vt;
    qm = P.a + P.b * -z;
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j < m) {
      float x[6];
      greek_quants<PUT>(P, st, z, wv, q, k[j], cg[j], tk[j], x);
      if (ANTI) {
        float y[6];
        greek_quants<PUT>(P, stm, -z, wvm, qm, k[j], cg[j], tk[j], y);
#pragma unroll
        for (int i = 0; i < 6; ++i) x[i] = 0.5f * (x[i] + y[i]);
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        v[N_GREEK * j + 2 * i] += x[i];
        v[N_GREEK * j + 2 * i + 1] += x[i] * x[i];
      }
    }
  }
}

template <bool ANTI, bool PUT, bool KAHAN>
__global__ void __launch_bounds__(THREADS)
    ladder_greeks_kernel(const float* __restrict__ par,
                         const float* __restrict__ ks, int n_k, uint32_t seed,
                         uint32_t off, int n_elems, int iters,
                         float* __restrict__ out) {
  constexpr int G = GREEK_GROUP;
  constexpr int N = N_GREEK * G;
  __shared__ float sh[WARPS * N];
  const mct::Key key = mct::seed_key(seed, off + blockIdx.x);
  const int g0 = blockIdx.y * G;
  const int m = min(G, n_k - g0);
  GreekPar P;
  P.s0 = par[0];
  P.mu = par[1];
  P.sig = par[2];
  P.v = par[3];
  P.t = par[4];
  P.sqt = par[5];
  P.r = par[6];
  P.inv_s0 = par[7];
  P.cg_over_k = par[8];
  P.a = P.r - 0.5f * P.v * P.v;  // the JAX kernel's order
  P.b = 0.5f * P.v / P.sqt;
  P.vt = P.v * P.t;
  float k[G], cg[G], tk[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    k[j] = j < m ? ks[g0 + j] : 0.0f;
    cg[j] = P.cg_over_k * k[j];
    tk[j] = P.t * k[j];
  }
  mct::BlockAccN<THREADS, N, KAHAN> acc;
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    for (int e = threadIdx.x; e < n_elems; e += THREADS) {
      float z1, z2;
      mct::draw_normal_pair(key, e, i, z1, z2);
      greek_add<ANTI, PUT, G>(P, k, cg, tk, m, z1, v);
      greek_add<ANTI, PUT, G>(P, k, cg, tk, m, z2, v);
    }
    acc.add(v, nullptr, sh);
  }
  acc.write_n(out + (static_cast<size_t>(blockIdx.x) * n_k + g0) * N_GREEK,
              N_GREEK * m);
}

template <bool ANTI, bool PUT, bool KAHAN>
void launch(bool greeks, const float* par, const float* ks, int n_k,
            uint32_t seed, uint32_t off, int n_blocks, int n_elems, int iters,
            float* out, cudaStream_t stream) {
  if (greeks) {
    const dim3 grid(n_blocks, (n_k + GREEK_GROUP - 1) / GREEK_GROUP);
    ladder_greeks_kernel<ANTI, PUT, KAHAN><<<grid, THREADS, 0, stream>>>(
        par, ks, n_k, seed, off, n_elems, iters, out);
  } else {
    const dim3 grid(n_blocks, (n_k + PRICE_GROUP - 1) / PRICE_GROUP);
    ladder_kernel<ANTI, PUT, KAHAN><<<grid, THREADS, 0, stream>>>(
        par, ks, n_k, seed, off, n_elems, iters, out);
  }
}

int dispatch(bool greeks, const float* par, const float* ks, int n_k,
             int seed, int off, int n_blocks, int rows, int iters,
             int antithetic, int put, int kahan, float* out, void* stream) {
  if (n_k < 1 || n_k > MAX_STRIKES || n_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  const uint32_t of = static_cast<uint32_t>(off);
  const int n = rows * mct::LANES;
  switch ((antithetic ? 4 : 0) | (put ? 2 : 0) | (kahan ? 1 : 0)) {
    case 0: launch<false, false, false>(greeks, par, ks, n_k, sd, of, n_blocks, n, iters, out, s); break;
    case 1: launch<false, false, true>(greeks, par, ks, n_k, sd, of, n_blocks, n, iters, out, s); break;
    case 2: launch<false, true, false>(greeks, par, ks, n_k, sd, of, n_blocks, n, iters, out, s); break;
    case 3: launch<false, true, true>(greeks, par, ks, n_k, sd, of, n_blocks, n, iters, out, s); break;
    case 4: launch<true, false, false>(greeks, par, ks, n_k, sd, of, n_blocks, n, iters, out, s); break;
    case 5: launch<true, false, true>(greeks, par, ks, n_k, sd, of, n_blocks, n, iters, out, s); break;
    case 6: launch<true, true, false>(greeks, par, ks, n_k, sd, of, n_blocks, n, iters, out, s); break;
    default: launch<true, true, true>(greeks, par, ks, n_k, sd, of, n_blocks, n, iters, out, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// par (3: s0, mu, sig), ks (n_k strikes) -> out (n_blocks, n_k, 2).
extern "C" int mctpu_ladder(const float* par, const float* ks, int n_k,
                            int seed, int off, int n_blocks, int rows,
                            int iters, int antithetic, int put, int kahan,
                            float* out, void* stream) {
  return dispatch(false, par, ks, n_k, seed, off, n_blocks, rows, iters,
                  antithetic, put, kahan, out, stream);
}

// par (9, see GreekPar), ks (n_k strikes) -> out (n_blocks, n_k, 12).
extern "C" int mctpu_ladder_greeks(const float* par, const float* ks, int n_k,
                                   int seed, int off, int n_blocks, int rows,
                                   int iters, int antithetic, int put,
                                   int kahan, float* out, void* stream) {
  return dispatch(true, par, ks, n_k, seed, off, n_blocks, rows, iters,
                  antithetic, put, kahan, out, stream);
}
