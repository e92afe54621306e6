// K6, K7 and K8: in-kernel pathwise Greeks of the vanilla and basket calls.
//
// K6 replaces mctpu/kernels/greeks.py::_greeks_kernel.  K1's stream: per
// simulation block b seed (seed, off + b); in iteration i tile element e
// draws Philox block (e, i, 0, 0) and both Box-Muller branches are terminal
// draws.  Per draw: payoff and the delta, vega, rho, theta, gamma, vanna and
// volga integrands (pathwise first order; gamma, vanna and volga by the
// mixed pathwise-likelihood-ratio device, derivations in the JAX module;
// greeks.cuh, shared with K53), pair-meaned under antithetic: 16 sums
// (x, x^2).
//
// K7 replaces _basket_greeks_am_kernel (<= 8 assets).  K2's stream: element
// e draws Philox blocks (e, i*a + p, 0, 0) for asset p; cosine branches are
// path tile A, sine branches tile B.  Payoff, rho, theta and per asset
// delta, vega and the diagonal Stein-tilt gamma: 6 + 6a sums.
//
// K8 replaces _basket_greeks_kernel (> 8 assets).  K3's stream: a
// (rows, width) tile with element index row * width + lane, path (row, p)
// on lanes p*a_tile .. p*a_tile + a - 1; iteration i draws (element, i, 0,
// 0), the cosine tile and the sine tile are two sets of paths.  Scalars
// (payoff, rho, theta: 6 sums) plus per lane slot the delta, vega and gamma
// pairs summed over every path of the block: (6, width) per block.  The
// TPU's block-diagonal Cholesky and fold/expand matmuls become an FP32 FFMA
// product over the lower triangle and plain segment sums and broadcasts.
// Not TF32: a reduced-precision product biased the TPU price by +4%
// (mctpu/kernels/basket.py).
//
// Bound on the H100: arithmetic.  K6 spends ~60 flops on the integrands per
// draw beside K1's draw and expf; K7 adds ~25a flops per path to K2; K8 at
// a = 100 is K3's 5050-FMA correlation product per path plus per-slot
// integrands.  Simple design, as K1-K3: one CUDA block per simulation block
// writing its own partial row.  Each thread sums its elements of an
// iteration plainly; mct::BlockAccN reduces the block's sums once per
// iteration in a fixed tree and Kahan-adds them in the carrying threads
// (the JAX kernels' acc_add_n), so registers hold one plain float per sum
// (16, or 6 + 6a <= 54) instead of compensated pairs.  K8 stages a chunk of
// rows in shared memory in four passes: draw the normals; one thread per
// (row, slot, branch) forms bt = L z + d and S_T; one thread per (row,
// path, branch) folds its slots into the basket, the indicator and the
// Stein path scalars; one thread per (branch, slot) owns that slot's column
// and adds the chunk's delta/vega/gamma pairs into it (compensated).  The
// per-slot vectors are thus a per-column reduction, never a per-thread
// register array.  Padded slots are never touched and stay exactly 0.  No
// atomics: two launches give the same bits.
#include <algorithm>

#include "common.cuh"
#include "greeks.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_AM_ASSETS = 8;
constexpr size_t SMEM_LIMIT = 96 * 1024;

// ---------------------------------------------------------------- K6 vanilla

constexpr int N_VAN = 16;

template <bool ANTI, bool PUT>
__device__ __forceinline__ void van_add(const mct::VanPar& P, float z,
                                        float (&v)[N_VAN]) {
  float q[8];
  mct::van_quants<PUT>(P, z, q);
  if (ANTI) {
    float m[8];
    mct::van_quants<PUT>(P, -z, m);
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = 0.5f * (q[j] + m[j]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[2 * j] += q[j];
    v[2 * j + 1] += q[j] * q[j];
  }
}

template <bool ANTI, bool PUT, bool KAHAN>
__global__ void __launch_bounds__(THREADS)
    greeks_vanilla_kernel(const float* __restrict__ par, uint32_t seed,
                          uint32_t off, int n_elems, int iters,
                          float* __restrict__ out) {
  __shared__ float sh[WARPS * N_VAN];
  const mct::Key key = mct::seed_key(seed, off + blockIdx.x);
  const mct::VanPar P = mct::van_par(par);
  mct::BlockAccN<THREADS, N_VAN, KAHAN> acc;
  float v[N_VAN];
#pragma unroll
  for (int j = 0; j < N_VAN; ++j) v[j] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    for (int e = threadIdx.x; e < n_elems; e += THREADS) {
      float z1, z2;
      mct::draw_normal_pair(key, e, i, z1, z2);
      van_add<ANTI, PUT>(P, z1, v);
      van_add<ANTI, PUT>(P, z2, v);
    }
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
}

template <bool ANTI, bool PUT, bool KAHAN>
void launch_vanilla(const float* par, uint32_t seed, uint32_t off,
                    int n_blocks, int n_elems, int iters, float* out,
                    cudaStream_t stream) {
  greeks_vanilla_kernel<ANTI, PUT, KAHAN>
      <<<n_blocks, THREADS, 0, stream>>>(par, seed, off, n_elems, iters, out);
}

// ---------------------------------------------------- K7 basket, asset-major

// One path from its A normals z, one antithetic sign: the basket terms, the
// correlated shifts btd, the basket, and zu = <sgn z, e>.
template <int A>
struct AmPath {
  float terms[A], btds[A], basket, zu;
};

// Operands in shared memory: lt (A*A), par (4*A: drift, vol, d, w*s0), vec
// (3*A: 1/s0, tilt e, tilt g), scal (k, t, sqrt(t), r).
template <int A>
__device__ __forceinline__ void am_path(const float* z, const float* lt,
                                        const float* par, const float* vec,
                                        float sgn, AmPath<A>& P) {
#pragma unroll
  for (int i = 0; i < A; ++i) {
    float bt = lt[i * A] * z[0];
#pragma unroll
    for (int j = 1; j <= i; ++j) bt = bt + lt[i * A + j] * z[j];
    const float btd = sgn * bt + par[2 * A + i];
    const float term = par[3 * A + i] * expf(par[i] + par[A + i] * btd);
    P.terms[i] = term;
    P.btds[i] = btd;
    P.basket = (i == 0) ? term : P.basket + term;
    const float x = vec[A + i] * (sgn * z[i]);
    P.zu = (i == 0) ? x : P.zu + x;
  }
}

// (p, ind, th, gd[A], gv[A], gg[A]) of one path and sign
// (mctpu _am_greek_quants' one()).
template <int A>
struct AmQuants {
  float p, ind, th, gd[A], gv[A], gg[A];
};

template <int A>
__device__ __forceinline__ void am_quants(const AmPath<A>& P, const float* par,
                                          const float* vec, const float* scal,
                                          AmQuants<A>& Q) {
  const float k = scal[0], t = scal[1], sqt = scal[2], r = scal[3];
  Q.ind = P.basket > k ? 1.0f : 0.0f;
  Q.p = fmaxf(P.basket - k, 0.0f);
  float th = 0.0f, bu = 0.0f, bu2 = 0.0f;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const float vol = par[A + i];
    Q.gd[i] = Q.ind * P.terms[i];
    Q.gv[i] = Q.gd[i] * (sqt * P.btds[i] - (vol / sqt) * t);
    const float x = Q.gd[i] * (par[i] + 0.5f * vol * P.btds[i]);
    th = (i == 0) ? x : th + x;
    const float vg = vol * vec[2 * A + i];
    const float y = P.terms[i] * vg;
    bu = (i == 0) ? y : bu + y;
    const float y2 = y * vg;
    bu2 = (i == 0) ? y2 : bu2 + y2;
  }
  Q.th = th * (1.0f / t) - r * Q.p;
  const float inv_bu = 1.0f / bu;
  const float path_term = (P.zu + bu2 * inv_bu) * inv_bu;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    Q.gg[i] = Q.gd[i] * P.terms[i] *
              (path_term - (2.0f * par[A + i] * vec[2 * A + i]) * inv_bu);
  }
}

template <int A, bool ANTI>
__device__ __forceinline__ void am_add(const float* z, const float* lt,
                                       const float* par, const float* vec,
                                       const float* scal,
                                       float (&v)[6 + 6 * A]) {
  AmQuants<A> Q;
  {
    AmPath<A> P;
    am_path<A>(z, lt, par, vec, 1.0f, P);
    am_quants<A>(P, par, vec, scal, Q);
  }
  if (ANTI) {
    AmQuants<A> M;
    {
      AmPath<A> P;
      am_path<A>(z, lt, par, vec, -1.0f, P);
      am_quants<A>(P, par, vec, scal, M);
    }
    Q.p = 0.5f * (Q.p + M.p);
    Q.ind = 0.5f * (Q.ind + M.ind);
    Q.th = 0.5f * (Q.th + M.th);
#pragma unroll
    for (int i = 0; i < A; ++i) {
      Q.gd[i] = 0.5f * (Q.gd[i] + M.gd[i]);
      Q.gv[i] = 0.5f * (Q.gv[i] + M.gv[i]);
      Q.gg[i] = 0.5f * (Q.gg[i] + M.gg[i]);
    }
  }
  const float ri = (scal[1] * scal[0]) * Q.ind;
  v[0] += Q.p;
  v[1] += Q.p * Q.p;
  v[2] += ri;
  v[3] += ri * ri;
  v[4] += Q.th;
  v[5] += Q.th * Q.th;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    float* vi = v + 6 + 6 * i;
    vi[0] += Q.gd[i];
    vi[1] += Q.gd[i] * Q.gd[i];
    vi[2] += Q.gv[i];
    vi[3] += Q.gv[i] * Q.gv[i];
    vi[4] += Q.gg[i];
    vi[5] += Q.gg[i] * Q.gg[i];
  }
}

template <int A, bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(THREADS)
    greeks_am_kernel(const float* __restrict__ scal_g,
                     const float* __restrict__ lt_g,
                     const float* __restrict__ par_g,
                     const float* __restrict__ vec_g, uint32_t seed,
                     uint32_t off, int n_elems, int iters,
                     float* __restrict__ out) {
  constexpr int N = 6 + 6 * A;
  __shared__ float lt[A * A], par[4 * A], vec[3 * A], scal[4], scale[N];
  __shared__ float sh[WARPS * N];
  for (int t = threadIdx.x; t < A * A; t += THREADS) lt[t] = lt_g[t];
  for (int t = threadIdx.x; t < 4 * A; t += THREADS) par[t] = par_g[t];
  for (int t = threadIdx.x; t < 3 * A; t += THREADS) vec[t] = vec_g[t];
  if (threadIdx.x < 4) scal[threadIdx.x] = scal_g[threadIdx.x];
  if (threadIdx.x < N) {  // per-asset 1/s0 factors of the delta and gamma sums
    const int k = threadIdx.x;
    float f = 1.0f;
    if (k >= 6) {
      const float inv = vec_g[(k - 6) / 6];
      const float inv2 = inv * inv;
      const int col = (k - 6) % 6;
      f = col == 0 ? inv : col == 1 ? inv * inv : col == 4 ? inv2
        : col == 5 ? inv2 * inv2 : 1.0f;
    }
    scale[k] = f;
  }
  __syncthreads();
  const mct::Key key = mct::seed_key(seed, off + blockIdx.x);
  mct::BlockAccN<THREADS, N, KAHAN> acc;
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    for (int e = threadIdx.x; e < n_elems; e += THREADS) {
      float za[A], zb[A];
#pragma unroll
      for (int p = 0; p < A; ++p) {
        mct::draw_normal_pair(key, e, static_cast<uint32_t>(i * A + p), za[p],
                              zb[p]);
      }
      am_add<A, ANTI>(za, lt, par, vec, scal, v);
      am_add<A, ANTI>(zb, lt, par, vec, scal, v);
    }
    acc.add(v, scale, sh);
  }
  acc.write(out);
}

template <int A>
void launch_am(bool anti, bool kahan, const float* scal, const float* lt,
               const float* par, const float* vec, uint32_t seed,
               uint32_t off, int n_blocks, int n_elems, int iters, float* out,
               cudaStream_t s) {
  if (anti) {
    if (kahan) greeks_am_kernel<A, true, true><<<n_blocks, THREADS, 0, s>>>(scal, lt, par, vec, seed, off, n_elems, iters, out);
    else greeks_am_kernel<A, true, false><<<n_blocks, THREADS, 0, s>>>(scal, lt, par, vec, seed, off, n_elems, iters, out);
  } else {
    if (kahan) greeks_am_kernel<A, false, true><<<n_blocks, THREADS, 0, s>>>(scal, lt, par, vec, seed, off, n_elems, iters, out);
    else greeks_am_kernel<A, false, false><<<n_blocks, THREADS, 0, s>>>(scal, lt, par, vec, seed, off, n_elems, iters, out);
  }
}

// ----------------------------------------------------------- K8 basket, packed

// Rows of the per-slot operand table (mctpu_torch/kernels/greeks.py, ROWS).
enum Row { S0, DRIFT, VOL, D, W, INV_S0, VG, WV, WV2, E, V_ROW, N_ROWS };

// Shared-memory floats of one block: fixed tables, and per chunk row.
struct PkLayout {
  int width, stride, c, ns;
  __host__ __device__ int fixed() const { return (N_ROWS + 24) * width; }
  __host__ __device__ int per_row() const {
    return (2 + 4 * ns) * stride + 3 * ns * 2 * c;
  }
};

template <bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(THREADS)
    greeks_packed_kernel(const float* __restrict__ scal_g,
                         const float* __restrict__ lt,
                         const float* __restrict__ rows_g, int a, int a_tile,
                         int width, int chunk, uint32_t seed, uint32_t off,
                         int rows, int iters, float* __restrict__ out,
                         float* __restrict__ vec_out) {
  constexpr int NS = ANTI ? 2 : 1;  // antithetic signs
  extern __shared__ float smem[];
  __shared__ float sh[WARPS * 6];
  const int stride = width + 1;  // odd row stride: rows on distinct banks
  const int c = width / a_tile;
  float* srow = smem;                             // [N_ROWS][width]
  float* colacc = srow + N_ROWS * width;          // [6][2][width] sums
  float* colcmp = colacc + 12 * width;            // [6][2][width] comps
  float* zs = colcmp + 12 * width;                // [2][chunk][stride]
  float* bts = zs + 2 * chunk * stride;           // [NS][2][chunk][stride]
  float* sts = bts + NS * 2 * chunk * stride;     // [NS][2][chunk][stride]
  float* pth = sts + NS * 2 * chunk * stride;     // [3][NS][2][chunk * c]
  const int pstride = NS * 2 * chunk * c;         // ind | path_term | inv_bu
  for (int t = threadIdx.x; t < N_ROWS * width; t += THREADS) srow[t] = rows_g[t];
  for (int t = threadIdx.x; t < 24 * width; t += THREADS) colacc[t] = 0.0f;
  __syncthreads();
  const float k = scal_g[0], t = scal_g[1], sqt = scal_g[2], r = scal_g[3];
  const float inv_t = 1.0f / t;
  const float tk = t * k;
  const mct::Key key = mct::seed_key(seed, off + blockIdx.x);
  mct::BlockAccN<THREADS, 6, KAHAN> acc;
  float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  for (int i = 0; i < iters; ++i) {
    for (int r0 = 0; r0 < rows; r0 += chunk) {
      const int nr = min(chunk, rows - r0);
      const int tile = nr * width;
      // 1. Both Box-Muller branches of the chunk (padded slots not drawn).
      for (int e = threadIdx.x; e < tile; e += THREADS) {
        const int row = e / width;
        const int lane = e - row * width;
        if (lane % a_tile < a) {
          float z1, z2;
          mct::draw_normal_pair(key, static_cast<uint32_t>(r0 * width + e),
                                static_cast<uint32_t>(i), z1, z2);
          zs[row * stride + lane] = z1;
          zs[(chunk + row) * stride + lane] = z2;
        }
      }
      __syncthreads();
      // 2. Per (branch, row, slot): bt = L z + d and S_T, each sign.
      for (int q = threadIdx.x; q < 2 * tile; q += THREADS) {
        const int br = q / tile;
        const int e = q - br * tile;
        const int row = e / width;
        const int lane = e - row * width;
        const int j = lane % a_tile;
        if (j >= a) continue;
        const float* z = zs + (br * chunk + row) * stride + (lane - j);
        const float* lrow = lt + j * a;
        float lz = 0.0f;
        for (int l = 0; l <= j; ++l) lz = fmaf(__ldg(lrow + l), z[l], lz);
        const float d = srow[D * width + lane];
        const float s0 = srow[S0 * width + lane];
        const float drift = srow[DRIFT * width + lane];
        const float vol = srow[VOL * width + lane];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float bt = (s ? -lz : lz) + d;
          const int at = ((s * 2 + br) * chunk + row) * stride + lane;
          bts[at] = bt;
          sts[at] = s0 * expf(drift + vol * bt);
        }
      }
      __syncthreads();
      // 3. Per (branch, row, path): fold the slots into the basket, the
      //    exercise indicator, theta and the Stein path scalars.
      for (int q = threadIdx.x; q < 2 * nr * c; q += THREADS) {
        const int br = q / (nr * c);
        const int pr = q - br * nr * c;
        const int row = pr / c;
        const int base = (pr - row * c) * a_tile;
        const float* z = zs + (br * chunk + row) * stride + base;
        float pm = 0.0f, im = 0.0f, tm = 0.0f;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int at = ((s * 2 + br) * chunk + row) * stride + base;
          const float sgn = s ? -1.0f : 1.0f;
          float basket = 0.0f, bu = 0.0f, bu2 = 0.0f, zu = 0.0f, ths = 0.0f;
          for (int j = 0; j < a; ++j) {
            const int lane = base + j;
            const float st = sts[at + j];
            const float w = srow[W * width + lane];
            basket = basket + st * w;
            bu = bu + st * srow[WV * width + lane];
            bu2 = bu2 + st * srow[WV2 * width + lane];
            zu = zu + (sgn * z[j]) * srow[E * width + lane];
            ths = ths + (w * st) * ((srow[DRIFT * width + lane] +
                                     0.5f * srow[VOL * width + lane] *
                                         bts[at + j]) * inv_t);
          }
          const float ind = basket > k ? 1.0f : 0.0f;
          const float p = fmaxf(basket - k, 0.0f);
          const float th = (ind != 0.0f ? ths : 0.0f) - r * p;
          const float inv_bu = 1.0f / bu;
          const int pi = (s * 2 + br) * chunk * c + pr;
          pth[pi] = ind;
          pth[pstride + pi] = (zu + bu2 * inv_bu) * inv_bu;
          pth[2 * pstride + pi] = inv_bu;
          pm += p;
          im += ind;
          tm += th;
        }
        if (ANTI) {
          pm *= 0.5f;
          im *= 0.5f;
          tm *= 0.5f;
        }
        const float ri = tk * im;
        v[0] += pm;
        v[1] += pm * pm;
        v[2] += ri;
        v[3] += ri * ri;
        v[4] += tm;
        v[5] += tm * tm;
      }
      __syncthreads();
      // 4. Per (branch, slot): this thread's column of delta, vega and gamma
      //    pairs over the chunk's rows, then compensated into the block's.
      for (int q = threadIdx.x; q < 2 * width; q += THREADS) {
        const int br = q / width;
        const int lane = q - br * width;
        const int j = lane % a_tile;
        if (j >= a) continue;
        const int path = lane / a_tile;
        const float w = srow[W * width + lane];
        const float inv_s0 = srow[INV_S0 * width + lane];
        const float vg2 = 2.0f * srow[VG * width + lane];
        const float vrt = srow[V_ROW * width + lane] * t;
        float l[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int row = 0; row < nr; ++row) {
          float gd = 0.0f, gv = 0.0f, gg = 0.0f;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int at = ((s * 2 + br) * chunk + row) * stride + lane;
            const int pi = (s * 2 + br) * chunk * c + row * c + path;
            const float st = sts[at];
            const float ws = (pth[pi] * w) * st;
            const float wss = ws * (w * st);
            gd += ws * inv_s0;
            gv += ws * (sqt * bts[at] - vrt);
            gg += (wss * (inv_s0 * inv_s0)) *
                  (pth[pstride + pi] - vg2 * pth[2 * pstride + pi]);
          }
          if (ANTI) {
            gd *= 0.5f;
            gv *= 0.5f;
            gg *= 0.5f;
          }
          l[0] += gd;
          l[1] += gd * gd;
          l[2] += gv;
          l[3] += gv * gv;
          l[4] += gg;
          l[5] += gg * gg;
        }
#pragma unroll
        for (int m = 0; m < 6; ++m) {
          const int at = (m * 2 + br) * width + lane;
          mct::kahan_add(colacc[at], colcmp[at], l[m]);
        }
      }
      __syncthreads();
    }
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
  for (int q = threadIdx.x; q < 6 * width; q += THREADS) {
    const int m = q / width;
    const int lane = q - m * width;
    const int a0 = (m * 2) * width + lane, a1 = a0 + width;
    vec_out[static_cast<size_t>(blockIdx.x) * 6 * width + q] =
        __fadd_rn(__fadd_rn(colacc[a0], colcmp[a0]),
                  __fadd_rn(colacc[a1], colcmp[a1]));
  }
}

template <bool ANTI, bool KAHAN>
int launch_packed(const float* scal, const float* lt, const float* rows_g,
                  int a, int a_tile, int width, int chunk, size_t smem,
                  uint32_t seed, uint32_t off, int n_blocks, int rows,
                  int iters, float* out, float* vecs, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        greeks_packed_kernel<ANTI, KAHAN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  greeks_packed_kernel<ANTI, KAHAN><<<n_blocks, THREADS, smem, stream>>>(
      scal, lt, rows_g, a, a_tile, width, chunk, seed, off, rows, iters, out,
      vecs);
  return 0;
}

}  // namespace

extern "C" int mctpu_greeks_vanilla(const float* par, int seed, int off,
                                    int n_blocks, int rows, int iters,
                                    int antithetic, int put, int kahan,
                                    float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  const uint32_t of = static_cast<uint32_t>(off);
  const int n = rows * mct::LANES;
  switch ((antithetic ? 4 : 0) | (put ? 2 : 0) | (kahan ? 1 : 0)) {
    case 0: launch_vanilla<false, false, false>(par, sd, of, n_blocks, n, iters, out, s); break;
    case 1: launch_vanilla<false, false, true>(par, sd, of, n_blocks, n, iters, out, s); break;
    case 2: launch_vanilla<false, true, false>(par, sd, of, n_blocks, n, iters, out, s); break;
    case 3: launch_vanilla<false, true, true>(par, sd, of, n_blocks, n, iters, out, s); break;
    case 4: launch_vanilla<true, false, false>(par, sd, of, n_blocks, n, iters, out, s); break;
    case 5: launch_vanilla<true, false, true>(par, sd, of, n_blocks, n, iters, out, s); break;
    case 6: launch_vanilla<true, true, false>(par, sd, of, n_blocks, n, iters, out, s); break;
    default: launch_vanilla<true, true, true>(par, sd, of, n_blocks, n, iters, out, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mctpu_greeks_basket_am(const float* scal, const float* lt,
                                      const float* par, const float* vec,
                                      int n_assets, int seed, int off,
                                      int n_blocks, int rows, int iters,
                                      int antithetic, int kahan, float* out,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  const uint32_t of = static_cast<uint32_t>(off);
  const int n = rows * mct::LANES;
  const bool an = antithetic != 0, kh = kahan != 0;
  switch (n_assets) {
    case 1: launch_am<1>(an, kh, scal, lt, par, vec, sd, of, n_blocks, n, iters, out, s); break;
    case 2: launch_am<2>(an, kh, scal, lt, par, vec, sd, of, n_blocks, n, iters, out, s); break;
    case 3: launch_am<3>(an, kh, scal, lt, par, vec, sd, of, n_blocks, n, iters, out, s); break;
    case 4: launch_am<4>(an, kh, scal, lt, par, vec, sd, of, n_blocks, n, iters, out, s); break;
    case 5: launch_am<5>(an, kh, scal, lt, par, vec, sd, of, n_blocks, n, iters, out, s); break;
    case 6: launch_am<6>(an, kh, scal, lt, par, vec, sd, of, n_blocks, n, iters, out, s); break;
    case 7: launch_am<7>(an, kh, scal, lt, par, vec, sd, of, n_blocks, n, iters, out, s); break;
    case MAX_AM_ASSETS: launch_am<MAX_AM_ASSETS>(an, kh, scal, lt, par, vec, sd, of, n_blocks, n, iters, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mctpu_greeks_basket_packed(const float* scal, const float* lt,
                                          const float* rows_g, int n_assets,
                                          int a_tile, int width, int seed,
                                          int off, int n_blocks, int rows,
                                          int iters, int antithetic,
                                          int kahan, float* out, float* vecs,
                                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PkLayout L{width, width + 1, width / a_tile, antithetic ? 2 : 1};
  const size_t fixed = static_cast<size_t>(L.fixed()) * sizeof(float);
  const size_t row_bytes = static_cast<size_t>(L.per_row()) * sizeof(float);
  if (fixed + row_bytes > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = std::min<int>(rows, static_cast<int>((SMEM_LIMIT - fixed) / row_bytes));
  const size_t smem = fixed + chunk * row_bytes;
  const uint32_t sd = static_cast<uint32_t>(seed);
  const uint32_t of = static_cast<uint32_t>(off);
  int err;
  if (antithetic) {
    err = kahan ? launch_packed<true, true>(scal, lt, rows_g, n_assets, a_tile, width, chunk, smem, sd, of, n_blocks, rows, iters, out, vecs, s)
                : launch_packed<true, false>(scal, lt, rows_g, n_assets, a_tile, width, chunk, smem, sd, of, n_blocks, rows, iters, out, vecs, s);
  } else {
    err = kahan ? launch_packed<false, true>(scal, lt, rows_g, n_assets, a_tile, width, chunk, smem, sd, of, n_blocks, rows, iters, out, vecs, s)
                : launch_packed<false, false>(scal, lt, rows_g, n_assets, a_tile, width, chunk, smem, sd, of, n_blocks, rows, iters, out, vecs, s);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
