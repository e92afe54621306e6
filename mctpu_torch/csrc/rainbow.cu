// K36, K37 and K38: the rainbow call on the maximum or minimum of
// correlated assets, and its asset-major pathwise Greeks.
//
// K36 replaces mctpu/kernels/rainbow.py::_rainbow_am_kernel (<= 8 assets,
// K2's stream map): in iteration i, tile element e draws Philox blocks
// (e, i*a + p, 0, 0) for asset p; the cosine branches are path A's asset
// normals, the sine branches path B's.  bt_i = sum_{j <= i} L_ij z_j from
// the first product, S_i = s0_i expf(drift_i + vol_i (sgn bt_i)), the
// extreme a strict-compare select chain over the assets, payoff
// max(ext - k, 0), pair-meaned under antithetic.
//
// K37 replaces ::_rainbow_kernel (> 8 assets, K3's lane-packed map): the
// tile is (rows, width) with element index row * width + lane, path
// (row, p) on lanes p*a_tile .. p*a_tile + a - 1 (pack_factor); iteration
// i draws Philox block (element, i, 0, 0), the cosine tile feeds one set of
// paths and the sine tile another.  The TPU kernel forms bt = z @ chol_bd
// on the MXU and takes each path's extreme with a lane butterfly over
// extreme-neutral padding (spot 0 for max, +inf for min); here one thread
// per packed path forms L z over the lower triangle and takes the extreme
// over the path's real assets: the padding never changed it, and a padded
// lane is never drawn nor read (its +inf never meets a 0).
//
// K38 replaces ::_rainbow_greeks_kernel: K36's paths, and per path the
// arg-extreme asset (the first extreme wins a tie), I = 1{ext > k}, per
// asset gd_i = 1{argext = i} I S_i and gv_i = gd_i sqrt(t) (bt_i - vol_i),
// th = sum_i gd_i (drift_i + vol_i bt_i / 2) / t - r P and rho = t k I:
// 6 + 4a sums, the delta pairs scaled by 1/s0_i and 1/s0_i^2 after the
// block reduction (mctpu applies them to each tile's sums).
//
// This file is built with -fmad=false (mctpu_torch/_build.py): the
// arg-extreme and the in-the-money indicator are discontinuous, so each
// path must round as the plain PyTorch version's separate multiplies and
// adds do.  K36 and K38 share am_spots and am_extreme, the thread count and
// BlockAccN's reduction of (p, p^2), so K38's price sums equal K36's bit
// for bit.
//
// Bound on the H100: arithmetic.  Per asset a Philox block and a
// Box-Muller pair per two paths, an expf and the i+1 multiply-adds of row i
// of L z per path (a(a+1)/2 in all), a compare and select; K38 adds ~10
// float operations per asset.  K37 at 16 assets spends 136 multiply-adds a
// path; L is read through the read-only cache, every thread of a warp on
// the same entry, and z from shared memory.  Simple design, as K2, K3 and
// K7: one CUDA block per simulation block.  K36 and K38: 256 threads stride
// over the tile's elements, L and the per-asset rows in shared memory,
// per-iteration sums through mct::BlockAccN.  K37: 128 threads first draw a
// chunk of the tile's rows into shared memory (both branches, odd row
// stride against bank conflicts, padded lanes not drawn), then one thread
// per (row, packed path, branch) forms its payoff.  No atomics: two
// launches give the same bits.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int AM_THREADS = 256;
constexpr int AM_WARPS = AM_THREADS / 32;
constexpr int PK_THREADS = 128;
constexpr int MAX_AM_ASSETS = 8;
constexpr size_t SMEM_LIMIT = 96 * 1024;

// ------------------------------------------------------ K36, K38 (a <= 8)

// The A spots of one path and sign, and the signed bt (mctpu's _am_payoff
// and _greek_quants order).  par rows (A each): drift, vol, s0.
template <int A>
__device__ __forceinline__ void am_spots(const float* z, const float* lt,
                                         const float* par, float sgn,
                                         float (&s)[A], float (&btd)[A]) {
#pragma unroll
  for (int i = 0; i < A; ++i) {
    float bt = lt[i * A] * z[0];
#pragma unroll
    for (int j = 1; j <= i; ++j) bt = bt + lt[i * A + j] * z[j];
    btd[i] = sgn * bt;
    s[i] = par[2 * A + i] * expf(par[i] + par[A + i] * btd[i]);
  }
}

// The strict-compare select chain: the extreme spot and its asset.
template <int A>
__device__ __forceinline__ float am_extreme(const float (&s)[A], bool mn,
                                            int& idx) {
  float ext = s[0];
  idx = 0;
#pragma unroll
  for (int i = 1; i < A; ++i) {
    const bool better = mn ? s[i] < ext : s[i] > ext;
    if (better) {
      ext = s[i];
      idx = i;
    }
  }
  return ext;
}

template <int A, bool ANTI>
__device__ __forceinline__ float am_pay(const float* z, const float* lt,
                                        const float* par, float k, bool mn) {
  float s[A], btd[A];
  int idx;
  am_spots<A>(z, lt, par, 1.0f, s, btd);
  const float p = fmaxf(am_extreme<A>(s, mn, idx) - k, 0.0f);
  if (ANTI) {
    am_spots<A>(z, lt, par, -1.0f, s, btd);
    return 0.5f * (p + fmaxf(am_extreme<A>(s, mn, idx) - k, 0.0f));
  }
  return p;
}

template <int A, bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(AM_THREADS)
    rainbow_am_kernel(const float* __restrict__ lt_g,
                      const float* __restrict__ par_g,
                      const float* __restrict__ kp, int mn, uint32_t seed,
                      uint32_t off, int n_elems, int iters,
                      float* __restrict__ out) {
  __shared__ float lt[A * A], par[3 * A], sh[AM_WARPS * 2];
  for (int t = threadIdx.x; t < A * A; t += AM_THREADS) lt[t] = lt_g[t];
  for (int t = threadIdx.x; t < 3 * A; t += AM_THREADS) par[t] = par_g[t];
  __syncthreads();
  const float k = kp[0];
  const mct::Key key = mct::seed_key(seed, off + blockIdx.x);
  mct::BlockAccN<AM_THREADS, 2, KAHAN> acc;
  float v[2] = {0.0f, 0.0f};
  for (int i = 0; i < iters; ++i) {
    for (int e = threadIdx.x; e < n_elems; e += AM_THREADS) {
      float za[A], zb[A];
#pragma unroll
      for (int p = 0; p < A; ++p) {
        mct::draw_normal_pair(key, e, static_cast<uint32_t>(i * A + p), za[p],
                              zb[p]);
      }
      const float pa = am_pay<A, ANTI>(za, lt, par, k, mn != 0);
      v[0] += pa;
      v[1] += pa * pa;
      const float pb = am_pay<A, ANTI>(zb, lt, par, k, mn != 0);
      v[0] += pb;
      v[1] += pb * pb;
    }
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
}

// (p, ind, th, gd[A], gv[A]) of one path and sign.  sc: k, t, sqrt(t), r.
template <int A>
struct RbQuants {
  float p, ind, th, gd[A], gv[A];
};

template <int A>
__device__ __forceinline__ void rb_quants(const float* z, const float* lt,
                                          const float* par, const float* sc,
                                          bool mn, float sgn,
                                          RbQuants<A>& Q) {
  const float k = sc[0], t = sc[1], sqt = sc[2], r = sc[3];
  float s[A], btd[A];
  int idx;
  am_spots<A>(z, lt, par, sgn, s, btd);
  const float ext = am_extreme<A>(s, mn, idx);
  Q.ind = ext > k ? 1.0f : 0.0f;
  Q.p = fmaxf(ext - k, 0.0f);
  float th = 0.0f;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const float vol = par[A + i];
    Q.gd[i] = (idx == i) ? Q.ind * s[i] : 0.0f;
    Q.gv[i] = Q.gd[i] * sqt * (btd[i] - vol);
    const float x = Q.gd[i] * (par[i] + 0.5f * vol * btd[i]);
    th = (i == 0) ? x : th + x;
  }
  Q.th = th * (1.0f / t) - r * Q.p;
}

// Adds one path's outputs (pair-meaned under antithetic) to the per-thread
// sums [p, p2, rho, rho2, th, th2, then per asset gd, gd2, gv, gv2].
template <int A, bool ANTI>
__device__ __forceinline__ void rb_add(const float* z, const float* lt,
                                       const float* par, const float* sc,
                                       bool mn, float tk,
                                       float (&v)[6 + 4 * A]) {
  RbQuants<A> Q;
  rb_quants<A>(z, lt, par, sc, mn, 1.0f, Q);
  if (ANTI) {
    RbQuants<A> M;
    rb_quants<A>(z, lt, par, sc, mn, -1.0f, M);
    Q.p = 0.5f * (Q.p + M.p);
    Q.ind = 0.5f * (Q.ind + M.ind);
    Q.th = 0.5f * (Q.th + M.th);
#pragma unroll
    for (int i = 0; i < A; ++i) {
      Q.gd[i] = 0.5f * (Q.gd[i] + M.gd[i]);
      Q.gv[i] = 0.5f * (Q.gv[i] + M.gv[i]);
    }
  }
  const float ri = tk * Q.ind;
  v[0] += Q.p;
  v[1] += Q.p * Q.p;
  v[2] += ri;
  v[3] += ri * ri;
  v[4] += Q.th;
  v[5] += Q.th * Q.th;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    float* vi = v + 6 + 4 * i;
    vi[0] += Q.gd[i];
    vi[1] += Q.gd[i] * Q.gd[i];
    vi[2] += Q.gv[i];
    vi[3] += Q.gv[i] * Q.gv[i];
  }
}

template <int A, bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(AM_THREADS)
    rainbow_greeks_kernel(const float* __restrict__ scal_g,
                          const float* __restrict__ lt_g,
                          const float* __restrict__ par_g,
                          const float* __restrict__ inv_g, int mn,
                          uint32_t seed, uint32_t off, int n_elems, int iters,
                          float* __restrict__ out) {
  constexpr int N = 6 + 4 * A;
  __shared__ float lt[A * A], par[3 * A], sc[4], scale[N], sh[AM_WARPS * N];
  for (int t = threadIdx.x; t < A * A; t += AM_THREADS) lt[t] = lt_g[t];
  for (int t = threadIdx.x; t < 3 * A; t += AM_THREADS) par[t] = par_g[t];
  if (threadIdx.x < 4) sc[threadIdx.x] = scal_g[threadIdx.x];
  if (threadIdx.x < N) {  // 1/s0_i and its square on the delta pairs
    const int q = threadIdx.x;
    float f = 1.0f;
    if (q >= 6 && (q - 6) % 4 < 2) {
      const float inv = inv_g[(q - 6) / 4];
      f = (q - 6) % 4 == 0 ? inv : inv * inv;
    }
    scale[q] = f;
  }
  __syncthreads();
  const float tk = sc[1] * sc[0];
  const mct::Key key = mct::seed_key(seed, off + blockIdx.x);
  mct::BlockAccN<AM_THREADS, N, KAHAN> acc;
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    for (int e = threadIdx.x; e < n_elems; e += AM_THREADS) {
      float za[A], zb[A];
#pragma unroll
      for (int p = 0; p < A; ++p) {
        mct::draw_normal_pair(key, e, static_cast<uint32_t>(i * A + p), za[p],
                              zb[p]);
      }
      rb_add<A, ANTI>(za, lt, par, sc, mn != 0, tk, v);
      rb_add<A, ANTI>(zb, lt, par, sc, mn != 0, tk, v);
    }
    acc.add(v, scale, sh);
  }
  acc.write(out);
}

// The launch shape of the asset-major kernels.
struct AmLaunch {
  int mn;
  uint32_t seed, off;
  int n_elems, iters;
};

template <int A>
void launch_am(bool anti, bool kahan, const float* lt, const float* par,
               const float* kp, const AmLaunch& g, int n_blocks, float* out,
               cudaStream_t s) {
  using Fn = void (*)(const float*, const float*, const float*, int, uint32_t,
                      uint32_t, int, int, float*);
  static const Fn FNS[4] = {
      rainbow_am_kernel<A, false, false>, rainbow_am_kernel<A, false, true>,
      rainbow_am_kernel<A, true, false>, rainbow_am_kernel<A, true, true>};
  const Fn fn = FNS[(anti ? 2 : 0) | (kahan ? 1 : 0)];
  fn<<<n_blocks, AM_THREADS, 0, s>>>(lt, par, kp, g.mn, g.seed, g.off,
                                     g.n_elems, g.iters, out);
}

template <int A>
void launch_greeks(bool anti, bool kahan, const float* scal, const float* lt,
                   const float* par, const float* inv, const AmLaunch& g,
                   int n_blocks, float* out, cudaStream_t s) {
  using Fn = void (*)(const float*, const float*, const float*, const float*,
                      int, uint32_t, uint32_t, int, int, float*);
  static const Fn FNS[4] = {rainbow_greeks_kernel<A, false, false>,
                            rainbow_greeks_kernel<A, false, true>,
                            rainbow_greeks_kernel<A, true, false>,
                            rainbow_greeks_kernel<A, true, true>};
  const Fn fn = FNS[(anti ? 2 : 0) | (kahan ? 1 : 0)];
  fn<<<n_blocks, AM_THREADS, 0, s>>>(scal, lt, par, inv, g.mn, g.seed, g.off,
                                     g.n_elems, g.iters, out);
}

// ------------------------------------------------------------ K37 (a > 8)

// Payoff of one packed path from its a normals z (shared memory): L z over
// the lower triangle from 0, the mirror's the negated sum, exactly.  par
// rows (a each): drift, vol, s0.
template <bool ANTI>
__device__ __forceinline__ float packed_pay(const float* z,
                                            const float* __restrict__ lt,
                                            const float* __restrict__ par,
                                            int a, float k, bool mn) {
  float ext = 0.0f, ext_m = 0.0f;
  for (int j = 0; j < a; ++j) {
    const float* lrow = lt + j * a;
    float bt = 0.0f;
    for (int l = 0; l <= j; ++l) bt = bt + __ldg(lrow + l) * z[l];
    const float drift = __ldg(par + j), vol = __ldg(par + a + j);
    const float s0 = __ldg(par + 2 * a + j);
    const float s = s0 * expf(drift + vol * bt);
    ext = (j == 0 || (mn ? s < ext : s > ext)) ? s : ext;
    if (ANTI) {
      const float sm = s0 * expf(drift + vol * (-bt));
      ext_m = (j == 0 || (mn ? sm < ext_m : sm > ext_m)) ? sm : ext_m;
    }
  }
  const float p = fmaxf(ext - k, 0.0f);
  if (ANTI) return 0.5f * (p + fmaxf(ext_m - k, 0.0f));
  return p;
}

template <bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(PK_THREADS)
    rainbow_packed_kernel(const float* __restrict__ lt,
                          const float* __restrict__ par,
                          const float* __restrict__ kp, int a, int a_tile,
                          int width, int chunk_rows, int mn, uint32_t seed,
                          uint32_t off, int rows, int iters,
                          float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float sh[(PK_THREADS / 32) * 2];
  const int stride = width + 1;  // odd row stride: rows on distinct banks
  float* z1s = smem;
  float* z2s = smem + chunk_rows * stride;
  const int c = width / a_tile;
  const float k = kp[0];
  const mct::Key key = mct::seed_key(seed, off + blockIdx.x);
  mct::BlockAccN<PK_THREADS, 2, KAHAN> acc;
  float v[2] = {0.0f, 0.0f};
  for (int i = 0; i < iters; ++i) {
    for (int r0 = 0; r0 < rows; r0 += chunk_rows) {
      const int nr = min(chunk_rows, rows - r0);
      for (int e = threadIdx.x; e < nr * width; e += PK_THREADS) {
        const int row = e / width;
        const int lane = e - row * width;
        if (lane % a_tile < a) {  // padded lanes are never read
          float z1, z2;
          mct::draw_normal_pair(key, static_cast<uint32_t>(r0 * width + e),
                                static_cast<uint32_t>(i), z1, z2);
          z1s[row * stride + lane] = z1;
          z2s[row * stride + lane] = z2;
        }
      }
      __syncthreads();
      for (int q = threadIdx.x; q < nr * c * 2; q += PK_THREADS) {
        const int path = q >> 1;
        const int row = path / c;
        const int p = path - row * c;
        const float* z = ((q & 1) ? z2s : z1s) + row * stride + p * a_tile;
        const float pay = packed_pay<ANTI>(z, lt, par, a, k, mn != 0);
        v[0] += pay;
        v[1] += pay * pay;
      }
      __syncthreads();
    }
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
}

}  // namespace

// Dispatches the asset-major kernels on n_assets = 1..8.
#define MCT_DISPATCH_A(CALL)                             \
  switch (n_assets) {                                    \
    case 1: CALL(1); break;                              \
    case 2: CALL(2); break;                              \
    case 3: CALL(3); break;                              \
    case 4: CALL(4); break;                              \
    case 5: CALL(5); break;                              \
    case 6: CALL(6); break;                              \
    case 7: CALL(7); break;                              \
    case MAX_AM_ASSETS: CALL(MAX_AM_ASSETS); break;      \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

extern "C" int mctpu_rainbow_am(const float* lt, const float* par,
                                const float* kp, int n_assets, int use_min,
                                int seed, int off, int n_blocks, int rows,
                                int iters, int antithetic, int kahan,
                                float* out, void* stream) {
  const AmLaunch g{use_min, static_cast<uint32_t>(seed),
                   static_cast<uint32_t>(off), rows * mct::LANES, iters};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MCT_CALL(A) \
  launch_am<A>(antithetic != 0, kahan != 0, lt, par, kp, g, n_blocks, out, s)
  MCT_DISPATCH_A(MCT_CALL)
#undef MCT_CALL
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mctpu_rainbow_greeks(const float* scal, const float* lt,
                                    const float* par, const float* inv_s0,
                                    int n_assets, int use_min, int seed,
                                    int off, int n_blocks, int rows,
                                    int iters, int antithetic, int kahan,
                                    float* out, void* stream) {
  const AmLaunch g{use_min, static_cast<uint32_t>(seed),
                   static_cast<uint32_t>(off), rows * mct::LANES, iters};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MCT_CALL(A)                                                         \
  launch_greeks<A>(antithetic != 0, kahan != 0, scal, lt, par, inv_s0, g,  \
                   n_blocks, out, s)
  MCT_DISPATCH_A(MCT_CALL)
#undef MCT_CALL
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mctpu_rainbow_packed(const float* lt, const float* par,
                                    const float* kp, int n_assets, int a_tile,
                                    int width, int use_min, int seed, int off,
                                    int n_blocks, int rows, int iters,
                                    int antithetic, int kahan, float* out,
                                    void* stream) {
  if (a_tile < n_assets || width % a_tile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Rows per shared-memory chunk: about one (path, branch) per thread, and
  // both branches' rows within SMEM_LIMIT.
  const int c = width / a_tile;
  const size_t row_bytes = 2 * static_cast<size_t>(width + 1) * sizeof(float);
  int chunk = std::min(rows, std::max(1, PK_THREADS / (2 * c)));
  chunk = std::min<int>(chunk, static_cast<int>(SMEM_LIMIT / row_bytes));
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = chunk * row_bytes;
  using Fn = void (*)(const float*, const float*, const float*, int, int, int,
                      int, int, uint32_t, uint32_t, int, int, float*);
  static const Fn FNS[4] = {
      rainbow_packed_kernel<false, false>, rainbow_packed_kernel<false, true>,
      rainbow_packed_kernel<true, false>, rainbow_packed_kernel<true, true>};
  const Fn fn = FNS[(antithetic ? 2 : 0) | (kahan ? 1 : 0)];
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<n_blocks, PK_THREADS, smem, s>>>(
      lt, par, kp, n_assets, a_tile, width, chunk, use_min,
      static_cast<uint32_t>(seed), static_cast<uint32_t>(off), rows, iters,
      out);
  return static_cast<int>(cudaGetLastError());
}
