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
// rows in shared memory in four passes: draw the normals; form bt = L z + d
// and S_T per (row, slot, branch); one thread per (row, path, branch) folds
// its slots into the basket, the indicator and the Stein path scalars; one
// thread per (branch, slot) owns that slot's column and sums the chunk's
// delta/vega/gamma pairs, which are then compensated-added over (iteration,
// chunk).  The per-slot vectors are thus a per-column reduction, never a
// per-thread register array.  Padded slots are never touched and stay
// exactly 0.  K8 is split into one CUDA block per (simulation block,
// iteration) and an ordered fold, its L z a register-tiled product at width
// 128 (see "K8" below).  No atomics: two launches give the same bits.
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

// The simple design's shared-memory floats of one block: fixed tables, and
// per chunk row.  Its chunk (the rows SMEM_LIMIT holds) is the unit of
// every sum of K8, whatever a kernel below stages at once.
struct PkLayout {
  int width, stride, c, ns;
  __host__ __device__ int fixed() const { return (N_ROWS + 24) * width; }
  __host__ __device__ int per_row() const {
    return (2 + 4 * ns) * stride + 3 * ns * 2 * c;
  }
};

// K8 runs as a split kernel and a fold.  The simple design's CUDA block of
// THREADS threads walked one simulation block's iterations in series: per
// iteration, chunks of `chunk` rows in four passes (the normals; bt = L z +
// d and S_T per (branch, row, slot); per unit q = branch * nr c + row * c +
// path (strided over the threads) the basket, the indicator, theta and the
// Stein path scalars, added into the thread's six sums v; per (branch,
// slot) its column's delta, vega and gamma pairs over the chunk's rows,
// each from 0 and ascending, Kahan-added (mct::kahan_add) into the block's
// column sums), and BlockAccN reduced v once per iteration (warp tree,
// warps in order) and carried it.  Here one CUDA block takes one
// (simulation block b, iteration i) item with the same key, draws, chunks
// and unit-to-thread map: it writes the iteration's six sums reduced over
// the block (mct::block_row, the same tree) and each chunk's 12 x width
// column sums to scratch, [6][chunks][6][2][width] an item, and
// greeks_packed_fold_kernel carries the six rows over the iterations
// (BlockAccN's Kahan form, or plain) and runs each column's Kahan chain
// over (iteration, chunk), then writes the block's rows as the simple
// design did.  So both equal the simple design's bit for bit.  Scratch at
// a = 100 is ~16.9 k floats an item; past K40's cap (256 MB) simulation
// blocks and iterations go in groups (mct::scratch_groups), the fold's
// carry (the six pairs, the column sums and compensations) kept in scratch
// between them.
//
// At width 128 (9-128 assets) the item's L z is a register-tiled product
// (greeks_tiled_kernel, K48's): a chunk's normals sit in shared memory unit
// by unit ([a][ust], each asset's units contiguous) beside the slices of L
// that j-tiles of jt assets read (the tiles end at a; [l][jt] each, L[j][l]
// at l <= j, zero above the diagonal and below asset 0), staged once an
// item (a = 100: 35 KB), not per chunk and j-tile as K48 stages its slice:
// K8's items take 11 chunks.  Each thread holds a tile of 4 units x 4
// assets: per l one float4 of normals and one of L feed 16 fmaf.  The warps
// split into uh groups of units (64 each) and 8 / uh octets of assets (jt
// = 64 / uh): uh = 1 where a chunk has at most 64 units (a = 100: 50 units
// plain, 30 antithetic), so that every warp takes part, more where it has
// more.  Every bt_j is fmaf(L[j][l], z[l], bt) from 0.0f over l = 0 .. j
// ascending, as the simple design forms it, followed by fmaf(0, z, bt) for
// the l of its tile above j, which return bt exactly (the chain starts at
// +0.0f, so it is never -0).  The tile's threads keep lz = L z and S_T per
// sign ([sign][a][ust]); the passes that follow read bt = +-lz + d as the
// simple design formed it.  The simple design's per-unit fold over the
// slots runs as three groups of its chains on three threads (the basket
// with theta's ths, bu with bu2, zu), each chain's statements as there, so
// that nvcc contracts them alike: the basket's w S_T, shared with ths, stays
// a rounded product, as it did there.  The unit's summing thread then forms
// its path scalars and six sums.  Shared memory at a = 100: 104.5 KB plain,
// 98 KB antithetic, two blocks an SM (one past about 110 assets, where L's
// slices outgrow half of it).  Past width 128 the item keeps the simple
// design's passes (greeks_path_kernel).
constexpr int K8_UNIT_TILE = 64;  // units of a warp's tile row
// Floats of scratch a launch aims at: K40's cap.
constexpr size_t K8_SCRATCH_CAP = size_t{64} << 20;

// The launch plan: the simple design's chunk, the tiled kernel's unit
// stride ust, unit groups uh and the floats of its L slices, and the
// scratch groups.
struct K8Plan {
  int chunk, chunks, ust, uh;
  size_t smem, ls_floats, carry, per_item;
  mct::ScratchGroups groups;
};

// Floats of every j-tile's slice of L at j-tiles of jt assets ending at a:
// [kt][jt] each, kt = its last asset + 1.
inline size_t l_tiles_floats(int a, int jt) {
  const int n = (a + jt - 1) / jt, j0 = a - n * jt;
  return static_cast<size_t>(jt) * (n * j0 + jt * n * (n + 1) / 2);
}

// The tiled kernel's shared-memory floats at unit stride ust: the rows, the
// normals, lz, S_T a sign, the L slices (ls floats), the five path chains
// and the three path scalars a sign.
inline size_t tiled_floats(int a, int ust, size_t ls, int ns) {
  return static_cast<size_t>(N_ROWS) * mct::LANES +
         static_cast<size_t>(a) * ust * (2 + ns) + ls +
         8 * static_cast<size_t>(ns) * ust;
}

// Units a tiled item's threads sum in one chunk: unit q = br * np + dp, dp
// = row * c + path.
__device__ __forceinline__ int unit_base(int q, int np, int c, int a_tile,
                                         int& row) {
  const int pr = q >= np ? q - np : q;
  row = pr / c;
  return (pr - row * c) * a_tile;
}

// ONE: one path a row (a_tile 128), every unit's slots at lanes 0 .. a - 1.
template <bool ANTI, bool ONE>
__global__ void __launch_bounds__(THREADS, 2)
    greeks_tiled_kernel(const float* __restrict__ scal_g,
                        const float* __restrict__ lt,
                        const float* __restrict__ rows_g, int a, int a_tile,
                        int chunk, int ust, int uh, uint32_t seed,
                        uint32_t off, int rows, int b0, int i0, int ni,
                        size_t per_item, size_t ls_floats,
                        float* __restrict__ items) {
  constexpr int NS = ANTI ? 2 : 1;
  constexpr int width = mct::LANES;
  extern __shared__ float4 smem4[];
  __shared__ float sh[WARPS * 6];
  const int jt = K8_UNIT_TILE / uh;
  const int jshift = uh == 1 ? 6 : (uh == 2 ? 5 : 4);  // log2(jt)
  const int j0_first = a - (a + jt - 1) / jt * jt;
  float* srow = reinterpret_cast<float*>(smem4);  // [N_ROWS][width]
  float* zs = srow + N_ROWS * width;              // [a][ust]
  float* lzs = zs + a * ust;                      // [a][ust]
  float* sts = lzs + a * ust;                     // [NS][a][ust]
  float* ls = sts + NS * a * ust;                 // L slices
  float* chs = ls + ls_floats;                    // [5][NS][ust]
  float* pth = chs + 5 * NS * ust;                // [3][NS][ust]
  const int c = ONE ? 1 : width / a_tile;
  const int bl = blockIdx.x / ni, il = blockIdx.x - bl * ni;
  const mct::Key key = mct::seed_key(seed, off + static_cast<uint32_t>(b0 + bl));
  const uint32_t it = static_cast<uint32_t>(i0 + il);
  float* item = items + static_cast<size_t>(blockIdx.x) * per_item;
  for (int t = threadIdx.x; t < N_ROWS * width; t += THREADS) srow[t] = rows_g[t];
  {  // every j-tile's slice of L, one after another
    float* dst = ls;
    for (int j0 = j0_first; j0 < a; j0 += jt) {
      const int kt = j0 + jt;
      for (int q = threadIdx.x; q < kt * jt; q += THREADS) {
        const int l = q >> jshift, j = j0 + (q & (jt - 1));
        dst[q] = (j >= 0 && l <= j) ? __ldg(lt + j * a + l) : 0.0f;
      }
      dst += kt * jt;
    }
  }
  const float k = scal_g[0], t = scal_g[1], sqt = scal_g[2], r = scal_g[3];
  const float inv_t = 1.0f / t;
  const float tk = t * k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int uw = (warp % uh) * K8_UNIT_TILE, jw = (warp / uh) * 8;
  const int ul = (lane & 15) * 4;       // the thread's first unit in a row
  const int jb = jw + (lane >> 4) * 4;  // its first asset in the j-tile
  float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int r0 = 0, ck = 0; r0 < rows; r0 += chunk, ++ck) {
    const int nr = min(chunk, rows - r0);
    const int np = nr * c, nu = 2 * np;  // the chunk's paths and units
    // 1. The normals: thread t takes path t % np and assets t / np, + g, ...
    //    (g groups of np threads); branch 1's unit follows branch 0's np.
    {
      const int g = max(1, THREADS / np);
      for (int q = tid; q < np * g; q += THREADS) {
        const int dp = q % np, l0 = q / np;
        const int row = dp / c;
        const uint32_t e0 = static_cast<uint32_t>(
            (r0 + row) * width + (dp - row * c) * a_tile);
        for (int l = l0; l < a; l += g) {
          float z1, z2;
          mct::draw_normal_pair(key, e0 + static_cast<uint32_t>(l), it, z1,
                                z2);
          zs[l * ust + dp] = z1;
          zs[l * ust + np + dp] = z2;
        }
      }
    }
    // 2. L z by j-tiles ending at a, and S_T for each sign.
    __syncthreads();  // the normals drawn (and, first, L's slices staged)
    const float* lsl = ls;
    for (int j0 = j0_first; j0 < a; j0 += jt) {
      const float* lsj = lsl;
      lsl += (j0 + jt) * jt;
      if (j0 + jw + 8 <= 0) continue;  // the warp's assets lie below 0
      const int kmax = j0 + jw + 8;
      for (int u0 = uw + ul; u0 < nu; u0 += uh * K8_UNIT_TILE) {
        float acc[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[u][jj] = 0.0f;
        }
#pragma unroll 4
        for (int l = 0; l < kmax; ++l) {
          const float4 z4 = *reinterpret_cast<const float4*>(zs + l * ust + u0);
          const float4 l4 = *reinterpret_cast<const float4*>(lsj + l * jt + jb);
          const float zu[4] = {z4.x, z4.y, z4.z, z4.w};
          const float lj[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              acc[u][jj] = fmaf(lj[jj], zu[u], acc[u][jj]);
            }
          }
        }
        int pb[4];  // each unit's first lane slot
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          int row;
          pb[u] = ONE ? 0 : unit_base(u0 + u, np, c, a_tile, row);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j0 + jb + jj;
          if (j < 0) continue;
          *reinterpret_cast<float4*>(lzs + j * ust + u0) =
              make_float4(acc[0][jj], acc[1][jj], acc[2][jj], acc[3][jj]);
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            float st[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int ln = pb[u] + j;
              const float lz = acc[u][jj];
              const float bt = (s ? -lz : lz) + srow[D * width + ln];
              st[u] = srow[S0 * width + ln] *
                      expf(srow[DRIFT * width + ln] +
                           srow[VOL * width + ln] * bt);
            }
            *reinterpret_cast<float4*>(sts + (s * a + j) * ust + u0) =
                make_float4(st[0], st[1], st[2], st[3]);
          }
        }
      }
    }
    __syncthreads();
    // 3. Per unit and sign, its slots folded over j ascending in three
    //    groups of chains on three threads (the basket with theta's ths,
    //    which share w S_T as in the simple design's loop; bu and bu2; zu),
    //    each chain the simple design's operations.
    for (int q3 = tid; q3 < 3 * NS * nu; q3 += THREADS) {
      const int grp = q3 / (NS * nu);
      const int sq = q3 - grp * NS * nu;
      const int s = sq / nu, q = sq - s * nu;
      int row;
      const int base = ONE ? 0 : unit_base(q, np, c, a_tile, row);
      const float* st_q = sts + s * a * ust + q;
      float* ch = chs + s * ust + q;
      if (grp == 0) {
        float basket = 0.0f, ths = 0.0f;
        for (int j = 0; j < a; ++j) {
          const int ln = base + j;
          const float st = st_q[j * ust];
          const float lz = lzs[j * ust + q];
          const float bt = (s ? -lz : lz) + srow[D * width + ln];
          const float w = srow[W * width + ln];
          basket = basket + st * w;
          ths = ths + (w * st) * ((srow[DRIFT * width + ln] +
                                   0.5f * srow[VOL * width + ln] * bt) *
                                  inv_t);
        }
        ch[0] = basket;
        ch[4 * NS * ust] = ths;
      } else if (grp == 1) {
        float bu = 0.0f, bu2 = 0.0f;
        for (int j = 0; j < a; ++j) {
          const int ln = base + j;
          const float st = st_q[j * ust];
          bu = bu + st * srow[WV * width + ln];
          bu2 = bu2 + st * srow[WV2 * width + ln];
        }
        ch[NS * ust] = bu;
        ch[2 * NS * ust] = bu2;
      } else {
        const float sgn = s ? -1.0f : 1.0f;
        float zu = 0.0f;
        for (int j = 0; j < a; ++j) {
          zu = zu + (sgn * zs[j * ust + q]) * srow[E * width + base + j];
        }
        ch[3 * NS * ust] = zu;
      }
    }
    __syncthreads();
    // The unit's exercise indicator, theta and Stein path scalars from its
    //    chains, and the six sums on the simple design's summing thread.
    for (int q = tid; q < nu; q += THREADS) {
      float pm = 0.0f, im = 0.0f, tm = 0.0f;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float* ch = chs + s * ust + q;
        const float basket = ch[0], bu = ch[NS * ust], bu2 = ch[2 * NS * ust];
        const float zu = ch[3 * NS * ust], ths = ch[4 * NS * ust];
        const float ind = basket > k ? 1.0f : 0.0f;
        const float p = fmaxf(basket - k, 0.0f);
        const float th = (ind != 0.0f ? ths : 0.0f) - r * p;
        const float inv_bu = 1.0f / bu;
        pth[s * ust + q] = ind;
        pth[(NS + s) * ust + q] = (zu + bu2 * inv_bu) * inv_bu;
        pth[(2 * NS + s) * ust + q] = inv_bu;
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
    // 4. Per (branch, slot): its column of delta, vega and gamma pairs over
    //    the chunk's rows, from 0 and ascending, into the chunk's scratch.
    float* col = item + 6 + static_cast<size_t>(ck) * 12 * width;
    for (int q = tid; q < 2 * width; q += THREADS) {
      const int br = q / width;
      const int ln = q - br * width;
      const int j = ln % a_tile;
      if (j >= a) continue;
      const int path = ln / a_tile;
      const float w = srow[W * width + ln];
      const float inv_s0 = srow[INV_S0 * width + ln];
      const float vg2 = 2.0f * srow[VG * width + ln];
      const float vrt = srow[V_ROW * width + ln] * t;
      const float d = srow[D * width + ln];
      float l[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int row = 0; row < nr; ++row) {
        const int u = br * np + row * c + path;
        float gd = 0.0f, gv = 0.0f, gg = 0.0f;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float st = sts[(s * a + j) * ust + u];
          const float lz = lzs[j * ust + u];
          const float bt = (s ? -lz : lz) + d;
          const float ws = (pth[s * ust + u] * w) * st;
          const float wss = ws * (w * st);
          gd += ws * inv_s0;
          gv += ws * (sqt * bt - vrt);
          gg += (wss * (inv_s0 * inv_s0)) *
                (pth[(NS + s) * ust + u] - vg2 * pth[(2 * NS + s) * ust + u]);
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
      for (int m = 0; m < 6; ++m) col[(m * 2 + br) * width + ln] = l[m];
    }
  }
  mct::block_row<THREADS, 6>(v, sh, item);
}

// Past width 128: the simple design's four passes on one item.
template <bool ANTI>
__global__ void __launch_bounds__(THREADS)
    greeks_path_kernel(const float* __restrict__ scal_g,
                       const float* __restrict__ lt,
                       const float* __restrict__ rows_g, int a, int a_tile,
                       int width, int chunk, uint32_t seed, uint32_t off,
                       int rows, int b0, int i0, int ni, size_t per_item,
                       float* __restrict__ items) {
  constexpr int NS = ANTI ? 2 : 1;  // antithetic signs
  extern __shared__ float smem[];
  __shared__ float sh[WARPS * 6];
  const int stride = width + 1;  // odd row stride: rows on distinct banks
  const int c = width / a_tile;
  float* srow = smem;                             // [N_ROWS][width]
  float* zs = srow + N_ROWS * width;              // [2][chunk][stride]
  float* bts = zs + 2 * chunk * stride;           // [NS][2][chunk][stride]
  float* sts = bts + NS * 2 * chunk * stride;     // [NS][2][chunk][stride]
  float* pth = sts + NS * 2 * chunk * stride;     // [3][NS][2][chunk * c]
  const int pstride = NS * 2 * chunk * c;         // ind | path_term | inv_bu
  const int bl = blockIdx.x / ni, il = blockIdx.x - bl * ni;
  const mct::Key key = mct::seed_key(seed, off + static_cast<uint32_t>(b0 + bl));
  const int i = i0 + il;
  float* item = items + static_cast<size_t>(blockIdx.x) * per_item;
  for (int t = threadIdx.x; t < N_ROWS * width; t += THREADS) srow[t] = rows_g[t];
  __syncthreads();
  const float k = scal_g[0], t = scal_g[1], sqt = scal_g[2], r = scal_g[3];
  const float inv_t = 1.0f / t;
  const float tk = t * k;
  float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int r0 = 0, ck = 0; r0 < rows; r0 += chunk, ++ck) {
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
    // 4. Per (branch, slot): its column of delta, vega and gamma pairs over
    //    the chunk's rows, into the chunk's scratch.
    float* col = item + 6 + static_cast<size_t>(ck) * 12 * width;
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
      for (int m = 0; m < 6; ++m) col[(m * 2 + br) * width + lane] = l[m];
    }
    __syncthreads();
  }
  mct::block_row<THREADS, 6>(v, sh, item);
}

// K8_FOLD_BLOCKS(width) CUDA blocks per simulation block b0 + bl of a
// group: thread k < 6 of the first carries sum k's iteration rows in order
// (BlockAccN's Kahan form, plain under !KAHAN); thread (m, slot) runs its
// column's two Kahan chains (one a branch) over (iteration, chunk).  The
// carry starts at zero in the first group and is kept in scratch between
// groups; the last group writes the block's six sums and its (6, width)
// row of vectors, the branches' sums plus compensations added, padded
// slots exactly 0.
__host__ __device__ constexpr int k8_fold_blocks(int width) {
  return (6 * width + THREADS - 1) / THREADS;
}

template <bool KAHAN>
__global__ void __launch_bounds__(THREADS)
    greeks_packed_fold_kernel(const float* __restrict__ items,
                              float* __restrict__ carry, int a, int a_tile,
                              int width, int chunks, int b0, int ni,
                              size_t per_item, int first, int last,
                              float* __restrict__ out,
                              float* __restrict__ vec_out) {
  const int fb = k8_fold_blocks(width);
  const int bl = blockIdx.x / fb, cb = blockIdx.x - bl * fb;
  const size_t b = static_cast<size_t>(b0 + bl);
  float* cv = carry + static_cast<size_t>(bl) * (12 + 24 * width);
  float* colacc = cv + 12;              // [6][2][width]
  float* colcmp = colacc + 12 * width;  // [6][2][width]
  const float* it = items + static_cast<size_t>(bl) * ni * per_item;
  if (cb == 0 && threadIdx.x < 6) {
    const int k = threadIdx.x;
    float s = first ? 0.0f : cv[2 * k], c = first ? 0.0f : cv[2 * k + 1];
    for (int il = 0; il < ni; ++il) {
      const float x = it[il * per_item + k];
      if (KAHAN) {
        mct::kahan_add(s, c, x);
      } else {
        s = __fadd_rn(s, x);
      }
    }
    if (last) {
      out[b * 6 + k] = __fadd_rn(s, c);
    } else {
      cv[2 * k] = s;
      cv[2 * k + 1] = c;
    }
  }
  const int q = cb * THREADS + threadIdx.x;
  if (q >= 6 * width) return;
  const int m = q / width;
  const int lane = q - m * width;
  if (lane % a_tile >= a) {  // padded slots: never touched
    if (last) vec_out[b * 6 * width + q] = 0.0f;
    return;
  }
  const int a0 = (m * 2) * width + lane, a1 = a0 + width;
  float s0 = 0.0f, c0 = 0.0f, s1 = 0.0f, c1 = 0.0f;
  if (!first) {
    s0 = colacc[a0];
    c0 = colcmp[a0];
    s1 = colacc[a1];
    c1 = colcmp[a1];
  }
  for (int il = 0; il < ni; ++il) {
    const float* cols = it + il * per_item + 6;
#pragma unroll 4
    for (int ck = 0; ck < chunks; ++ck) {
      const float* col = cols + static_cast<size_t>(ck) * 12 * width;
      const float x0 = col[a0], x1 = col[a1];
      mct::kahan_add(s0, c0, x0);
      mct::kahan_add(s1, c1, x1);
    }
  }
  if (last) {
    vec_out[b * 6 * width + q] =
        __fadd_rn(__fadd_rn(s0, c0), __fadd_rn(s1, c1));
  } else {
    colacc[a0] = s0;
    colcmp[a0] = c0;
    colacc[a1] = s1;
    colcmp[a1] = c1;
  }
}

// The plan of a K8 launch under a cap in floats (0: K8_SCRATCH_CAP); chunk
// 0 where the simple design's fixed tables and one row exceed SMEM_LIMIT.
K8Plan k8_plan(int a, int a_tile, int width, int n_blocks, int rows,
               int iters, bool anti, size_t cap) {
  K8Plan P{};
  const int ns = anti ? 2 : 1;
  const PkLayout L{width, width + 1, width / a_tile, ns};
  const size_t fixed = static_cast<size_t>(L.fixed()) * sizeof(float);
  const size_t row_bytes = static_cast<size_t>(L.per_row()) * sizeof(float);
  if (fixed + row_bytes > SMEM_LIMIT) return P;
  P.chunk = std::min<int>(rows,
                          static_cast<int>((SMEM_LIMIT - fixed) / row_bytes));
  P.chunks = (rows + P.chunk - 1) / P.chunk;
  if (width == mct::LANES) {
    // Unit stride: a multiple of 4 (float4 rows), an odd one (columns read
    // at stride ust fall on 8 banks, not fewer).
    const int nu_max = 2 * P.chunk * L.c;
    P.ust = (nu_max + 3) / 4 * 4;
    if ((P.ust / 4) % 2 == 0) P.ust += 4;
    // The fewest unit groups whose rows of 64 hold the chunk's units.
    P.uh = nu_max <= K8_UNIT_TILE ? 1 : (nu_max <= 2 * K8_UNIT_TILE ? 2 : 4);
    P.ls_floats = l_tiles_floats(a, K8_UNIT_TILE / P.uh);
    P.smem = tiled_floats(a, P.ust, P.ls_floats, ns) * sizeof(float);
  } else {
    P.smem = (static_cast<size_t>(N_ROWS) * width +
              static_cast<size_t>(P.chunk) * (2 + 4 * ns) * L.stride +
              3 * static_cast<size_t>(ns) * 2 * P.chunk * L.c) *
             sizeof(float);
  }
  P.carry = 12 + 24 * static_cast<size_t>(width);
  P.per_item = 6 + static_cast<size_t>(P.chunks) * 12 * width;
  P.groups = mct::scratch_groups(n_blocks, iters, P.carry, P.per_item,
                                 cap == 0 ? K8_SCRATCH_CAP : cap);
  return P;
}

template <bool ANTI>
int launch_packed(bool kahan, const float* scal, const float* lt,
                  const float* rows_g, int a, int a_tile, int width,
                  const K8Plan& P, uint32_t seed, uint32_t off, int n_blocks,
                  int rows, int iters, float* scratch, float* out,
                  float* vecs, cudaStream_t s) {
  const bool tiled = width == mct::LANES, one = a_tile == mct::LANES;
  const auto tiled_fn = one ? greeks_tiled_kernel<ANTI, true>
                            : greeks_tiled_kernel<ANTI, false>;
  const void* fn = tiled ? reinterpret_cast<const void*>(tiled_fn)
                         : reinterpret_cast<const void*>(
                               &greeks_path_kernel<ANTI>);
  if (P.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(P.smem));
    if (err == cudaSuccess && tiled) {
      err = cudaFuncSetAttribute(fn,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto fold = kahan ? greeks_packed_fold_kernel<true>
                          : greeks_packed_fold_kernel<false>;
  const mct::ScratchGroups& G = P.groups;
  float* carry = scratch;
  float* items = scratch + G.blocks * P.carry;
  for (int b0 = 0; b0 < n_blocks; b0 += G.blocks) {
    const int nb = std::min(G.blocks, n_blocks - b0);
    for (int i0 = 0; i0 < iters; i0 += G.iters) {
      const int ni = std::min(G.iters, iters - i0);
      if (tiled) {
        tiled_fn<<<nb * ni, THREADS, P.smem, s>>>(
            scal, lt, rows_g, a, a_tile, P.chunk, P.ust, P.uh, seed, off,
            rows, b0, i0, ni, P.per_item, P.ls_floats, items);
      } else {
        greeks_path_kernel<ANTI><<<nb * ni, THREADS, P.smem, s>>>(
            scal, lt, rows_g, a, a_tile, width, P.chunk, seed, off, rows, b0,
            i0, ni, P.per_item, items);
      }
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      fold<<<nb * k8_fold_blocks(width), THREADS, 0, s>>>(
          items, carry, a, a_tile, width, P.chunks, b0, ni, P.per_item,
          i0 == 0, i0 + ni >= iters, out, vecs);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
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

// Floats of K8's scratch for a launch under a cap in floats (0: 256 MB):
// per block of a group the fold's carry, per (block, iteration) item its
// six sums and its chunks' column sums; 0 where K8 cannot run this width.
extern "C" int mctpu_greeks_basket_packed_scratch_floats(
    int n_assets, int a_tile, int width, int n_blocks, int rows, int iters,
    int antithetic, int cap) {
  const K8Plan P = k8_plan(n_assets, a_tile, width, n_blocks, rows, iters,
                           antithetic != 0, static_cast<size_t>(cap));
  return P.chunk < 1 ? 0 : static_cast<int>(P.groups.total);
}

extern "C" int mctpu_greeks_basket_packed(const float* scal, const float* lt,
                                          const float* rows_g, int n_assets,
                                          int a_tile, int width, int seed,
                                          int off, int n_blocks, int rows,
                                          int iters, int antithetic,
                                          int kahan, int cap, float* scratch,
                                          float* out, float* vecs,
                                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const K8Plan P = k8_plan(n_assets, a_tile, width, n_blocks, rows, iters,
                           antithetic != 0, static_cast<size_t>(cap));
  if (P.chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t sd = static_cast<uint32_t>(seed);
  const uint32_t of = static_cast<uint32_t>(off);
  const int err =
      antithetic
          ? launch_packed<true>(kahan != 0, scal, lt, rows_g, n_assets,
                                a_tile, width, P, sd, of, n_blocks, rows,
                                iters, scratch, out, vecs, s)
          : launch_packed<false>(kahan != 0, scal, lt, rows_g, n_assets,
                                 a_tile, width, P, sd, of, n_blocks, rows,
                                 iters, scratch, out, vecs, s);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
