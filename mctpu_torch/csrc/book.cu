// K23 and K24: the vanilla book, M heterogeneous calls and puts priced
// (K23) or risked (K24) from one terminal draw per path.
//
// K23 replaces mctpu/kernels/book.py::_book_kernel, K24
// _book_greeks_kernel.  K1's stream: per simulation block b seed (seed,
// off + b); in iteration i tile element e draws Philox block (e, i, 0, 0)
// and both Box-Muller branches are terminal draws, shared by the whole book.
// Instrument j maps z to its own terminal spot s0_j exp(mu_j + sig_j z) (one
// expf per instrument and draw) and its call/put sign sgn_j = +-1 is data:
// K23 sums max(sgn_j (st - k_j), 0), the antithetic pair as 0.5 (p(z) +
// p(-z)) (mctpu _inst_sums); K24 the price, pathwise delta, vega, rho,
// theta and the likelihood-ratio gamma with the indicator sgn_j 1{sgn_j (st
// - k_j) > 0} (mctpu _book_greek_quants), each pair-meaned after the sum.
// (sum x, sum x^2) per instrument: (B, M, 2) or (B, M, 12).
//
// Operands: K23 a (5, M) table of rows s0, mu, sig, k, sgn; K24 the (13, M)
// table of mctpu's greek_const_rows (s0, mu, sig, sqt, v t, r - v^2/2,
// 0.5 v / sqt, r, 1/s0, k/(s0^2 v sqt), t k, k, sgn), formed on the host, so
// the hot loop has no divide.
//
// Bound on the H100: arithmetic, one expf per instrument and draw on the
// SFU beside K1's draw; ~5 float32 operations per path and instrument in
// K23, ~28 in K24.
//
// Simple design, as the strike ladder (csrc/ladder.cu): a two-dimensional
// grid of simulation blocks x groups of G instruments (16 in K23, 4 in
// K24), each group's CUDA block redrawing the simulation block's normals,
// keeping its instruments' constants in registers, summing plainly per
// thread and reducing once per iteration through mct::BlockAccN (fixed
// tree, Kahan across iterations).  A group writes its own columns of
// out[b, :, :]; a last group that is not full skips its missing
// instruments.  No atomics: two launches give the same bits.  Built without
// FMA contraction (-fmad=false), as the ladder and for its reasons.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BOOK = 64;
constexpr int PRICE_GROUP = 16;  // K23: 32 sums per CUDA block
constexpr int GREEK_GROUP = 4;   // K24: 48 sums per CUDA block
constexpr int N_GREEK = 12;      // (sum, sum^2) of p, delta, vega, rho,
                                 // theta, gamma
constexpr int N_PRICE_ROWS = 5;
constexpr int N_GREEK_ROWS = 13;

// Loads rows x G constants of the group's instruments (zeros past m).
template <int ROWS, int G>
__device__ __forceinline__ void load_group(const float* __restrict__ table,
                                           int m_total, int g0, int m,
                                           float (&c)[ROWS][G]) {
#pragma unroll
  for (int row = 0; row < ROWS; ++row) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      c[row][j] = j < m ? table[row * m_total + g0 + j] : 0.0f;
    }
  }
}

// ---------------------------------------------------------------- K23 price

// Instrument j's payoff on normal z (mctpu _inst_sums).
template <int G>
__device__ __forceinline__ float book_pay(const float (&c)[N_PRICE_ROWS][G],
                                          int j, float z) {
  return fmaxf(c[4][j] * (c[0][j] * expf(c[1][j] + c[2][j] * z) - c[3][j]),
               0.0f);
}

// At most 128 registers, so two blocks share an SM: left alone, nvcc gives
// the non-antithetic instances 154 and the SM one block of 8 warps.
template <bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(THREADS, 2)
    book_kernel(const float* __restrict__ par, int m_total, uint32_t seed,
                uint32_t off, int n_elems, int iters,
                float* __restrict__ out) {
  constexpr int G = PRICE_GROUP;
  constexpr int N = 2 * G;
  __shared__ float sh[WARPS * N];
  const mct::Key key = mct::seed_key(seed, off + blockIdx.x);
  const int g0 = blockIdx.y * G;
  const int m = min(G, m_total - g0);
  float c[N_PRICE_ROWS][G];
  load_group<N_PRICE_ROWS, G>(par, m_total, g0, m, c);
  mct::BlockAccN<THREADS, N, KAHAN> acc;
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    for (int e = threadIdx.x; e < n_elems; e += THREADS) {
      float z[2];
      mct::draw_normal_pair(key, e, i, z[0], z[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j < m) {
            float p = book_pay<G>(c, j, z[h]);
            if (ANTI) p = 0.5f * (p + book_pay<G>(c, j, -z[h]));
            v[2 * j] += p;
            v[2 * j + 1] += p * p;
          }
        }
      }
    }
    acc.add(v, nullptr, sh);
  }
  acc.write_n(out + (static_cast<size_t>(blockIdx.x) * m_total + g0) * 2,
              2 * m);
}

// ---------------------------------------------------------------- K24 Greeks

// The six integrands of instrument j on normal zz (mctpu
// _book_greek_quants: the antithetic mirror passes -z for both).
template <int G>
__device__ __forceinline__ void book_quants(const float (&c)[N_GREEK_ROWS][G],
                                            int j, float zz, float (&x)[6]) {
  const float st = c[0][j] * expf(c[1][j] + c[2][j] * zz);
  const float wv = c[3][j] * zz - c[4][j];
  const float q = c[5][j] + c[6][j] * zz;
  const float sgn = c[12][j];
  const float edge = sgn * (st - c[11][j]);
  const float ind = edge > 0.0f ? sgn : 0.0f;
  const float p = fmaxf(edge, 0.0f);
  const float w = ind * st;
  x[0] = p;
  x[1] = w * c[8][j];
  x[2] = w * wv;
  x[3] = c[10][j] * ind;
  x[4] = w * q - c[7][j] * p;
  x[5] = c[9][j] * (ind * zz);
}

template <bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(THREADS)
    book_greeks_kernel(const float* __restrict__ cvec, int m_total,
                       uint32_t seed, uint32_t off, int n_elems, int iters,
                       float* __restrict__ out) {
  constexpr int G = GREEK_GROUP;
  constexpr int N = N_GREEK * G;
  __shared__ float sh[WARPS * N];
  const mct::Key key = mct::seed_key(seed, off + blockIdx.x);
  const int g0 = blockIdx.y * G;
  const int m = min(G, m_total - g0);
  float c[N_GREEK_ROWS][G];
  load_group<N_GREEK_ROWS, G>(cvec, m_total, g0, m, c);
  mct::BlockAccN<THREADS, N, KAHAN> acc;
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    for (int e = threadIdx.x; e < n_elems; e += THREADS) {
      float z[2];
      mct::draw_normal_pair(key, e, i, z[0], z[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j < m) {
            float x[6];
            book_quants<G>(c, j, z[h], x);
            if (ANTI) {
              float y[6];
              book_quants<G>(c, j, -z[h], y);
#pragma unroll
              for (int q = 0; q < 6; ++q) x[q] = 0.5f * (x[q] + y[q]);
            }
#pragma unroll
            for (int q = 0; q < 6; ++q) {
              v[N_GREEK * j + 2 * q] += x[q];
              v[N_GREEK * j + 2 * q + 1] += x[q] * x[q];
            }
          }
        }
      }
    }
    acc.add(v, nullptr, sh);
  }
  acc.write_n(
      out + (static_cast<size_t>(blockIdx.x) * m_total + g0) * N_GREEK,
      N_GREEK * m);
}

template <bool ANTI, bool KAHAN>
void launch(bool greeks, const float* table, int m_total, uint32_t seed,
            uint32_t off, int n_blocks, int n_elems, int iters, float* out,
            cudaStream_t stream) {
  if (greeks) {
    const dim3 grid(n_blocks, (m_total + GREEK_GROUP - 1) / GREEK_GROUP);
    book_greeks_kernel<ANTI, KAHAN><<<grid, THREADS, 0, stream>>>(
        table, m_total, seed, off, n_elems, iters, out);
  } else {
    const dim3 grid(n_blocks, (m_total + PRICE_GROUP - 1) / PRICE_GROUP);
    book_kernel<ANTI, KAHAN><<<grid, THREADS, 0, stream>>>(
        table, m_total, seed, off, n_elems, iters, out);
  }
}

int dispatch(bool greeks, const float* table, int m_total, int seed, int off,
             int n_blocks, int rows, int iters, int antithetic, int kahan,
             float* out, void* stream) {
  if (m_total < 1 || m_total > MAX_BOOK || n_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  const uint32_t of = static_cast<uint32_t>(off);
  const int n = rows * mct::LANES;
  switch ((antithetic ? 2 : 0) | (kahan ? 1 : 0)) {
    case 0: launch<false, false>(greeks, table, m_total, sd, of, n_blocks, n, iters, out, s); break;
    case 1: launch<false, true>(greeks, table, m_total, sd, of, n_blocks, n, iters, out, s); break;
    case 2: launch<true, false>(greeks, table, m_total, sd, of, n_blocks, n, iters, out, s); break;
    default: launch<true, true>(greeks, table, m_total, sd, of, n_blocks, n, iters, out, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// par (5, m: s0, mu, sig, k, sgn) -> out (n_blocks, m, 2).
extern "C" int mctpu_book(const float* par, int m, int seed, int off,
                          int n_blocks, int rows, int iters, int antithetic,
                          int kahan, float* out, void* stream) {
  return dispatch(false, par, m, seed, off, n_blocks, rows, iters,
                  antithetic, kahan, out, stream);
}

// cvec (13, m: greek_const_rows) -> out (n_blocks, m, 12).
extern "C" int mctpu_book_greeks(const float* cvec, int m, int seed, int off,
                                 int n_blocks, int rows, int iters,
                                 int antithetic, int kahan, float* out,
                                 void* stream) {
  return dispatch(true, cvec, m, seed, off, n_blocks, rows, iters,
                  antithetic, kahan, out, stream);
}
