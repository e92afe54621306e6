// K39-K44: the netting-set CVA over correlated underlyings, its Greeks and
// the bilateral xVA with its Greeks.
//
// K40 replaces mctpu/kernels/cva_multi.py::_am_cva_multi_kernel (<= 8
// underlyings), K39 ::_cva_multi_kernel (> 8, lane-packed), K42
// ::_am_cva_multi_greeks_kernel (CVA, credit delta and per-underlying delta
// and vega, <= 8), K41 ::_cva_multi_greeks_kernel (the same, > 8,
// lane-packed), K43 ::_am_xva_kernel (CVA, DVA, FCA, FBA and the EPE and
// ENE profiles, <= 8) and K44 ::_am_xva_greeks_kernel (the legs, three
// credit and funding sensitivities and the total xVA's per-underlying
// delta and vega, <= 8).  Beyond 8 underlyings mctpu's engine sends the
// xVA to a Threefry XLA twin; here runtime-m kernels of K43 and K44 serve
// those sets on the asset-major Philox map extended to any m.
//
// Stream: per simulation block b and iteration i the key is reseeded with
// (seed, (off + b) * iters + i) in int32 wrap; the antithetic mirror
// replays it with the signs flipped.  Asset-major (K40, K42, K43, K44 and
// the runtime-m kernels): tile element e of a (rows, 128) tile is a path;
// pair jj draws Philox blocks (e, jj*M + i) for underlying i
// (mct::walk_pairwise_multi), cosine branches for node 2jj, sine branches
// for node 2jj+1.  Packed (K39, K41): K31's map (packed.cuh), path (row, p)
// owning lanes p*a_tile .. p*a_tile + m - 1.
//
// Each node j: x_i += drift_i + vol_i bt_i with bt = L z (asset-major from
// the first product, packed from 0), s_i = expf(x_i); each leg's value w_i
// BS_hastings(s_i, k_i, v_i, tau_j), its intrinsic value at the last node
// (tau = 0); the legs net and ee_j = max(net, 0) adds dp_j ee_j to the
// path's default leg (times lgd at the end).  The leg is priced in two
// forms and each kernel keeps its TPU kernel's rounding: am_leg (mctpu's
// _am_quants and _greek_node; K40-K44) d1 = (x - log k + (r + v^2/2) tau)
// * (1 / (v sqrt(tau))); packed_leg (bs_call_hastings; K39) d1 = (log(s /
// k) + (r + v^2/2) tau) / (v sqrt(tau)).  N(d1) and the density phi(d1)
// share one expf (mct::norm_cdf_hastings_e): the argument is the same
// operation on both sides.  K42 and K41 add the vol tangents dxv_i +=
// sqrt(dt) bt_i - v_i dt, the exercise indicator I = 1{net > 0}, delta_i
// += dp_j I w_i N(d1) s_i and vega_i += dp_j (I w_i N(d1) s_i dxv_i + I w_i
// s_i phi(d1) sqrt(tau)) (mctpu's _am_greek_step and _greek_step), and the
// credit delta ddp_j ee_j.  K43 adds ene_j = ee_j - net (no second clamp)
// and four legs over its node tables; K44 weights the integrands by the
// side-selected tw = (wc' + wf) I + (wd' + wf) (1 - I) and adds the three
// sensitivities over the derivative tables.
//
// Built with -fmad=false (mctpu_torch/_build.py): the exercise indicator
// and the positive part of the net are discontinuities, so each path must
// round as the plain PyTorch version's separate multiplies and adds do.
// K40, K42 and K43 share am_node, the thread count and BlockAccN's
// reduction, so K42's CVA sums equal K40's bit for bit, and so do K43's
// CVA sums and EPE profile where its CVA table is K40's (no own default);
// K40's and K43's split and fold (below) keep that order of additions.
//
// The expected-exposure profiles: mctpu Kahan-adds (1/2 under antithetic)
// the tile's sum of ee_j into an SMEM scalar per node.  Here (K4's design,
// csrc/cva.cu) each node's exposures are reduced by a fixed warp-shuffle
// tree, lane 0 adds the warp's sum into its own compensated slot (global
// scratch, [warps][n_grid][2]; K43 [warps][2 n_grid][2], EPE then ENE),
// and the warps are combined in warp order: no atomics, two launches give
// the same bits.
//
// Bound on the H100: arithmetic.  Per path-node and underlying: half a
// Philox block and a Box-Muller pair, three expf (the spot and the two
// CDFs), the IEEE divides of 1 / sq (or of s / k and by sq, and a logf)
// and of the two CDFs, the m(m+1)/2 multiply-adds of L z.  Simple design:
// one CUDA block per simulation block (layout_for gives 32 at 2^20 paths,
// so most of the 132 SMs idle, as with K4).  Asset-major: one thread per
// path element striding over the tile, the walk state in registers (K44 at
// m = 8: 8 log-spots, 8 tangents, 16 accumulators and 7 legs), L
// and the per-leg rows in shared memory, the node tables read through the
// read-only cache (every thread of a warp on the same node).  K40, K43
// and K44 are split: one warp per 32 elements that a warp of the unsplit
// kernel walked in one pass (32768 warp items at 2^20 paths instead of 512
// warps on 32 SMs), each writing its paths' payload (K40: cva; K43: four
// legs; K44: its 7 + 2M Greek outputs) and its warp's node sums (K40: ee;
// K43: epe and ene; K44: none) to scratch, then a fold, one CUDA block per
// simulation block, that replays the unsplit kernel's per-thread sums,
// BlockAccN and profile Kahan chains in their order from scratch, so that
// their bits, and the K42 / K43 gates against K40, stay as they were
// ("K40, K43 split, then folded" below; one split kernel and one fold over
// the payload).  The scratch (the payload a tile element, signs x rows
// warp sums for each 32) is capped at 256 MB: past that the blocks and
// iterations are split and folded in groups, the fold's carry kept in
// scratch between them.
// Runtime m: K43's and K44's split over more CUDA blocks than simulation
// blocks (slices of rows, then an ordered fold; see xva_slice_kernel and
// xva_greek_slice_kernel), their walk state in registers up to 32
// underlyings (K44's integrands and carries in shared memory).  Packed:
// K31's passes (packed.cuh), the log-spots and a pair of nodes' normals in
// shared memory, one thread per packed path (at a_tile 16 and 32 K39 and
// K41 keep them in the path's thread's registers, K31's and K33's
// designs); K41 adds K33's lane carries and its halving tree over the
// rows.
#include <algorithm>

#include "common.cuh"
#include "packed.cuh"

namespace {

constexpr int MAX_AM = 8;
constexpr float INV_SQRT_2PI = MCT_F32(0.3989422804014327);

// Threads of K40 and K42 at a given M (the same, so their CVA sums reduce
// alike); the wider Greek states get the larger register budget.
template <int M>
__host__ __device__ constexpr int am_threads() {
  return M <= 4 ? 512 : 256;
}

struct Launch {
  int g;  // exposure nodes
  uint32_t seed, off;
  int rows, iters;
};

__device__ __forceinline__ mct::Key iter_key(const Launch& L, int i) {
  return mct::seed_key(L.seed, (L.off + blockIdx.x) *
                                   static_cast<uint32_t>(L.iters) +
                               static_cast<uint32_t>(i));
}

template <int THREADS>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int n) {
  for (int t = threadIdx.x; t < n; t += THREADS) dst[t] = src[t];
}

// The node tables (5, g): dp, d(dp)/dlambda, tau, sqrt(tau), exp(-r tau).
struct Node {
  float dp, ddp, tau, sqtau, disc;
};

__device__ __forceinline__ Node node_at(const float* __restrict__ nodes,
                                        int g, int j) {
  return Node{__ldg(nodes + j), __ldg(nodes + g + j),
              __ldg(nodes + 2 * g + j), __ldg(nodes + 3 * g + j),
              __ldg(nodes + 4 * g + j)};
}

// ------------------------------------------------------------- EE profile

// Zeroes a block's profile slots ([warps][g][2] floats).
template <int THREADS>
__device__ __forceinline__ void profile_zero(float* prof, int n) {
  for (int t = threadIdx.x; t < n; t += THREADS) prof[t] = 0.0f;
}

// The warp's sum of x by a fixed shuffle tree, in lane 0 (every lane of the
// warp calls it).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  }
  return x;
}

// Adds half_w times the warp's sum of ee (every lane of the warp calls it)
// into node j's compensated slot of the warp, in mctpu's Kahan form.
__device__ __forceinline__ void profile_add(float* wprof, int j, float half_w,
                                            float ee, int lane) {
  const float r = warp_sum(ee);
  if (lane == 0) {
    float* slot = wprof + 2 * j;
    const float row = __fmul_rn(half_w, r);
    const float y = __fsub_rn(row, slot[1]);
    const float t = __fadd_rn(slot[0], y);
    slot[1] = __fsub_rn(__fsub_rn(t, slot[0]), y);
    slot[0] = t;
  }
}

// A profile row into row[0 .. g): each node's warp slots (sum +
// compensation) added in warp order.  Call after a __syncthreads.
template <int THREADS>
__device__ __forceinline__ void profile_write_to(const float* prof, int warps,
                                                 int g, float* row) {
  for (int j = threadIdx.x; j < g; j += THREADS) {
    float total = 0.0f;
    for (int w = 0; w < warps; ++w) {
      const float* slot = prof + (w * g + j) * 2;
      total = __fadd_rn(total, __fadd_rn(slot[0], slot[1]));
    }
    row[j] = total;
  }
}

// The block's profile row of ee_out.
template <int THREADS>
__device__ __forceinline__ void profile_write(const float* prof, int warps,
                                              int g, float* ee_out) {
  profile_write_to<THREADS>(prof, warps, g,
                            ee_out + static_cast<size_t>(blockIdx.x) * g);
}

// --------------------------------------------------------- K40, K42 (m <= 8)

// One leg i of an asset-major node (mctpu's _am_quants) from its correlated
// increment b: advances the log-spot x, sets the spot s and returns the
// leg's signed value w BS (w (s - k)^+ at the last node, tau = 0); for the
// Greeks also N(d1) (the in-the-money indicator at the last node) and
// phi(d1) (0 there).  par rows (m each): log s0, drift dt, v sqrt(dt), v
// dt, w, k, log k, v^2 / 2, v.  Shared by the kernels of every size (M <= 8
// in registers, the runtime-m xVA kernels and K41 over shared or scratch
// state), so they round alike.  am_value is its second half: the leg's
// value at the advanced log-spot xi (K41's register kernel advances the
// log-spots itself, then values the legs in a loop).
template <bool GREEKS>
__device__ __forceinline__ float am_value(float xi, const float* par, int m,
                                          int i, float r, const Node& nd,
                                          float& s, float& nd1, float& phi) {
  const float tau_safe = fmaxf(nd.tau, MCT_F32(1e-12));
  const float sq_floor = fmaxf(nd.sqtau, MCT_F32(1e-6));
  const float si = expf(xi);
  const float k = par[5 * m + i];
  float val;
  if (nd.tau <= 0.0f) {
    val = par[4 * m + i] * fmaxf(si - k, 0.0f);
    if (GREEKS) {
      nd1 = si > k ? 1.0f : 0.0f;
      phi = 0.0f;
    }
  } else {
    const float sq = par[8 * m + i] * sq_floor;
    const float d1 = (xi - par[6 * m + i] + (r + par[7 * m + i]) * tau_safe) *
                     (1.0f / sq);
    const float e = expf(MCT_F32(-0.5) * d1 * d1);
    const float n1 = mct::norm_cdf_hastings_e(d1, e);
    const float bs = si * n1 - k * nd.disc * mct::norm_cdf_hastings(d1 - sq);
    val = par[4 * m + i] * bs;
    if (GREEKS) {
      nd1 = n1;
      phi = INV_SQRT_2PI * e;
    }
  }
  s = si;
  return val;
}

template <bool GREEKS>
__device__ __forceinline__ float am_leg(float b, float& x, const float* par,
                                        int m, int i, float r, const Node& nd,
                                        float& s, float& nd1, float& phi) {
  const float xi = x + par[m + i] + par[2 * m + i] * b;
  x = xi;
  return am_value<GREEKS>(xi, par, m, i, r, nd, s, nd1, phi);
}

// One asset-major node (mctpu's _am_quants and _am_net): advances x[M] with
// the signed normals sgn * z, returns ee = max(net, 0) and, for the Greeks,
// the per-leg bt, spots, delta factor N(d1) and density phi(d1)
// (am_leg).
template <int M, bool GREEKS>
__device__ __forceinline__ float am_node(const float (&z)[M], float sgn,
                                         float (&x)[M], const float* lt,
                                         const float* par, float r,
                                         const Node& nd, float (&bt)[M],
                                         float (&s)[M], float (&nd1)[M],
                                         float (&phi)[M], float& net) {
  float value = 0.0f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float b = lt[i * M] * (sgn * z[0]);
#pragma unroll
    for (int j = 1; j <= i; ++j) b = b + lt[i * M + j] * (sgn * z[j]);
    const float val =
        am_leg<GREEKS>(b, x[i], par, M, i, r, nd, s[i], nd1[i], phi[i]);
    value = (i == 0) ? val : value + val;
    bt[i] = b;
  }
  net = value;
  return fmaxf(value, 0.0f);
}

// --------------------------------------------- K40, K43 split, then folded

// K40 and K43 run as a split walk and a fold that replays the unsplit
// kernel's order of additions.  The unsplit kernel ran one CUDA block of
// THREADS = am_threads<M>() threads per simulation block; in iteration i
// thread t walked elements e = p * THREADS + t for passes p, adding each of
// the element's NP payload values x (K40: its cva; K43: its four legs after
// the LGDs) as x and x^2 into 2 NP plain per-thread sums that BlockAccN
// reduced (warp tree, warps in order, Kahan carry) once per iteration, and
// at each node of each walk (the plain sign's, then the mirror's) lane 0
// Kahan-added half_w times its warp's sum of each profile value (K40: ee;
// K43: epe, then ene) into the warp's slot (w, row).  Here a warp item (b,
// i, p, w) is the 32 elements that warp w walked in pass p of iteration i:
// the split kernel walks each on one warp and writes its payload and, per
// sign and node, half_w times the warp's sums (the same shuffle tree); the
// fold kernel, one CUDA block of THREADS threads per simulation block, adds
// them in the unsplit order.  So K40's and K43's sums and profiles equal
// the unsplit kernels' bit for bit, as do K42's CVA sums, and K43's CVA
// sums and EPE profile equal K40's where its CVA table is K40's.
// Warp items a CUDA block: 8 (256 threads) ran 0-10% faster than 4 on an
// H100 (tools/time_redesign.py, see PERF.md); the bits do not depend on it.
// A payload Pay gives its values an element (np(M)), its profile rows a
// node and sign (ROWS), its walk, and the fold's add of an element's values
// to the per-thread sums (Add<M>): K40's and K43's add each value x as x
// and x^2 into slots 2k and 2k + 1 (PairAdd), K44's in
// mct::add_greek_sums' layout (GreekAdd).
constexpr int AM_SPLIT_THREADS = 256;
constexpr int AM_SPLIT_WARPS = AM_SPLIT_THREADS / 32;
// Floats of scratch a launch aims at (256 MB): simulation blocks and
// iterations are split and folded in groups below it (mct::scratch_groups),
// the fold's carry kept between the groups.
constexpr size_t AM_SCRATCH_CAP = size_t{64} << 20;

// One K40 walk of tile element e and sign sgn: its default leg lgd sum_j
// dp_j ee_j; lane 0 writes each node's warp sum of ee, times half_w, to
// wrow[j].
template <int M>
__device__ __forceinline__ float am_cva_walk(const float* lt, const float* par,
                                             const float* nodes, float r,
                                             float lgd, int g, mct::Key key,
                                             uint32_t e, float sgn,
                                             float half_w, float* wrow,
                                             int lane) {
  float x[M];
#pragma unroll
  for (int i = 0; i < M; ++i) x[i] = par[i];
  float acc = 0.0f;
  mct::walk_pairwise_multi<M>(key, e, g, [&](int j, const float(&z)[M]) {
    float bt[M], s[M], nd1[M], phi[M], net;
    const Node nd = node_at(nodes, g, j);
    const float ee =
        am_node<M, false>(z, sgn, x, lt, par, r, nd, bt, s, nd1, phi, net);
    acc = acc + nd.dp * ee;
    const float t = warp_sum(ee);
    if (lane == 0) wrow[j] = __fmul_rn(half_w, t);
  });
  return lgd * acc;
}

// Each of NP values x as x and x^2 into slots 2k and 2k + 1.
template <int NP>
struct PairAdd {
  __device__ static void add(const float (&q)[NP], float (&v)[2 * NP]) {
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      v[2 * k] += q[k];
      v[2 * k + 1] += q[k] * q[k];
    }
  }
};

// K40's split walk of element e: its cva (the antithetic pair's mean), one
// profile row a node (ee).  scal: r, lgd.
struct CvaPay {
  static constexpr int ROWS = 1;
  __host__ __device__ static constexpr int np(int) { return 1; }
  template <int M>
  using Add = PairAdd<1>;

  template <int M, bool ANTI>
  __device__ static void walk(const float* lt, const float* par,
                              const float* nodes, const float* scal, int g,
                              mct::Key key, uint32_t e, float half_w,
                              float* wrow, int lane, float (&q)[1]) {
    const float r = scal[0], lgd = scal[1];
    float cva = am_cva_walk<M>(lt, par, nodes, r, lgd, g, key, e, 1.0f,
                               half_w, wrow, lane);
    if (ANTI) {
      cva = 0.5f * (cva + am_cva_walk<M>(lt, par, nodes, r, lgd, g, key, e,
                                         -1.0f, half_w, wrow + g, lane));
    }
    q[0] = cva;
  }
};

// The plan of a K40 or K43 launch: the unsplit kernel's warps and passes,
// the payload floats an element (np) and profile rows a sign (gp: g or 2g),
// the groups of simulation blocks and iterations, and the scratch in
// floats: per block of a group the fold's carry (its BlockAccN pairs (s, c)
// and its profile slots [warps][gp][2]), then per (block, iteration) of a
// group the split's payload [np][rows * 128] and warp rows
// [passes][warps][signs][gp].
struct AmSplit {
  int warps, passes, signs, np, gp, group_blocks, group_iters;
  size_t carry, per_item, total;
};

// Warp items (b0 + bl, i0 + il, p, w) of a group, AM_SPLIT_WARPS a CUDA
// block: each lane walks its element with both signs, writes its payload
// (the antithetic mean under ANTI) and lane 0 the warp's node rows.  Warps
// past the tile (rows % 4 != 0 leaves the last pass's warps idle in the
// unsplit kernel) write nothing; the fold skips them as the unsplit kernel
// did.
template <int M, bool ANTI, class Pay>
__global__ void __launch_bounds__(AM_SPLIT_THREADS)
    am_split_kernel(const float* __restrict__ scal,
                    const float* __restrict__ lt_g,
                    const float* __restrict__ par_g,
                    const float* __restrict__ nodes, Launch L, int b0, int nb,
                    int i0, int ni, float* __restrict__ split) {
  constexpr int THREADS = am_threads<M>();
  constexpr int WARPS = THREADS / 32;
  constexpr int SIGNS = ANTI ? 2 : 1;
  constexpr int NP = Pay::np(M);
  __shared__ float lt[M * M], par[9 * M];
  stage<AM_SPLIT_THREADS>(lt, lt_g, M * M);
  stage<AM_SPLIT_THREADS>(par, par_g, 9 * M);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int gp = Pay::ROWS * L.g;
  const int n_elems = L.rows * mct::LANES;
  const int passes = (n_elems + THREADS - 1) / THREADS;
  const int per = passes * WARPS;
  const int item = blockIdx.x * AM_SPLIT_WARPS + (threadIdx.x >> 5);
  if (item >= nb * ni * per) return;
  const int bi = item / per, pw = item - bi * per;
  const int p = pw / WARPS, w = pw - p * WARPS;
  const int base = p * THREADS + w * 32;
  if (base >= n_elems) return;  // the whole warp: n_elems % 128 == 0
  const int bl = bi / ni, il = bi - bl * ni;
  const mct::Key key = mct::seed_key(
      L.seed, (L.off + static_cast<uint32_t>(b0 + bl)) *
                      static_cast<uint32_t>(L.iters) +
                  static_cast<uint32_t>(i0 + il));
  const size_t per_item = static_cast<size_t>(NP) * n_elems +
                          static_cast<size_t>(per) * SIGNS * gp;
  float* pay = split + bi * per_item;
  float* wrow = pay + static_cast<size_t>(NP) * n_elems +
                static_cast<size_t>(pw) * SIGNS * gp;
  const float half_w = ANTI ? 0.5f : 1.0f;
  const uint32_t e = static_cast<uint32_t>(base + lane);
  float q[NP];
  Pay::template walk<M, ANTI>(lt, par, nodes, scal, L.g, key, e, half_w, wrow,
                              lane, q);
#pragma unroll
  for (int k = 0; k < NP; ++k) pay[static_cast<size_t>(k) * n_elems + e] = q[k];
}

// One CUDA block of THREADS threads per simulation block b0 + bl of a
// group: thread t adds its elements' payload values over the passes into
// v[2 NP] (Add::add: x and x^2 into slots 2k and 2k + 1 for K40 and K43,
// K44's layout for K44) and BlockAccN reduces them once per iteration; thread
// (w, row) runs slot (w, row)'s Kahan chain over (iteration, pass, sign) in
// profile_add's form.  The carry (BlockAccN's pairs, the slots) starts at
// zero in the first group and is kept in scratch between groups; the last
// group writes the block's row of out (2 NP sums) and, the warps in order,
// its gp-row of prof.
template <int THREADS, bool KAHAN, int NP, class Add>
__global__ void __launch_bounds__(THREADS)
    am_fold_kernel(const float* __restrict__ split, float* __restrict__ carry,
                   Launch L, int gp, int b0, int ni, int signs, int first,
                   int last, float* __restrict__ out,
                   float* __restrict__ prof_out) {
  constexpr int WARPS = THREADS / 32;
  constexpr int N = 2 * NP;
  __shared__ float sh[WARPS * N];
  const int bl = blockIdx.x, b = b0 + bl;
  const int n_elems = L.rows * mct::LANES;
  const int passes = (n_elems + THREADS - 1) / THREADS;
  const size_t per_item = static_cast<size_t>(NP) * n_elems +
                          static_cast<size_t>(passes) * WARPS * signs * gp;
  float* cb = carry + static_cast<size_t>(bl) * (2 * N + WARPS * gp * 2);
  float* prof = cb + 2 * N;
  const float* items = split + static_cast<size_t>(bl) * ni * per_item;
  mct::BlockAccN<THREADS, N, KAHAN> acc;
  if (!first && threadIdx.x < N) {
    acc.s = cb[2 * threadIdx.x];
    acc.c = cb[2 * threadIdx.x + 1];
  }
  // A warp's passes: those with p * THREADS + w * 32 < n_elems.
  const int my_passes =
      (n_elems - (threadIdx.x >> 5) * 32 + THREADS - 1) / THREADS;
  float v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = 0.0f;
  for (int il = 0; il < ni; ++il) {
    const float* pay = items + il * per_item;
    for (int p = 0; p < my_passes; ++p) {
      float q[NP];
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        q[k] =
            pay[static_cast<size_t>(k) * n_elems + p * THREADS + threadIdx.x];
      }
      Add::add(q, v);
    }
    acc.add(v, nullptr, sh);
  }
  for (int t = threadIdx.x; t < WARPS * gp; t += THREADS) {
    const int w = t / gp, j = t - w * gp;
    const int w_passes = (n_elems - w * 32 + THREADS - 1) / THREADS;
    float* slot = prof + 2 * t;
    float s0 = first ? 0.0f : slot[0], s1 = first ? 0.0f : slot[1];
    for (int il = 0; il < ni; ++il) {
      const float* rows = items + il * per_item +
                          static_cast<size_t>(NP) * n_elems +
                          static_cast<size_t>(w) * signs * gp + j;
      for (int p = 0; p < w_passes; ++p) {
        for (int sg = 0; sg < signs; ++sg) {
          const float row =
              rows[(static_cast<size_t>(p) * WARPS * signs + sg) * gp];
          const float y = __fsub_rn(row, s1);
          const float u = __fadd_rn(s0, y);
          s1 = __fsub_rn(__fsub_rn(u, s0), y);
          s0 = u;
        }
      }
    }
    slot[0] = s0;
    slot[1] = s1;
  }
  if (last) {
    __syncthreads();
    profile_write_to<THREADS>(prof, WARPS, gp,
                              prof_out + static_cast<size_t>(b) * gp);
    acc.write_n(out + static_cast<size_t>(b) * N, N);
  } else if (threadIdx.x < N) {
    cb[2 * threadIdx.x] = acc.s;
    cb[2 * threadIdx.x + 1] = acc.c;
  }
}

// One K42 walk of tile element e and sign sgn; q gets [cva, credit delta,
// delta_0.., vega_0..] (before the host's 1 / s0).  scal: r, lgd,
// sqrt(dt).
template <int M>
__device__ __forceinline__ void am_greek_walk(const float* lt,
                                              const float* par,
                                              const float* nodes,
                                              const float* sc, int g,
                                              mct::Key key, uint32_t e,
                                              float sgn,
                                              float (&q)[2 + 2 * M]) {
  const float r = sc[0], sqdt = sc[2];
  float x[M], dxv[M], ad[M], av[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    x[i] = par[i];
    dxv[i] = ad[i] = av[i] = 0.0f;
  }
  float acc = 0.0f, acc_cr = 0.0f;
  mct::walk_pairwise_multi<M>(key, e, g, [&](int j, const float(&z)[M]) {
    float bt[M], s[M], nd1[M], phi[M], net;
    const Node nd = node_at(nodes, g, j);
    const float ee =
        am_node<M, true>(z, sgn, x, lt, par, r, nd, bt, s, nd1, phi, net);
    const float ind = net > 0.0f ? 1.0f : 0.0f;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      dxv[i] = dxv[i] + sqdt * bt[i] - par[3 * M + i];
      const float ws = ind * par[4 * M + i] * s[i];
      const float dval = ws * nd1[i];
      const float vval = dval * dxv[i] + ws * phi[i] * nd.sqtau;
      ad[i] = ad[i] + nd.dp * dval;
      av[i] = av[i] + nd.dp * vval;
    }
    acc = acc + nd.dp * ee;
    acc_cr = acc_cr + nd.ddp * ee;
  });
  const float lgd = sc[1];
  q[0] = lgd * acc;
  q[1] = lgd * acc_cr;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    q[2 + i] = lgd * ad[i];
    q[2 + M + i] = lgd * av[i];
  }
}

template <int M, bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(am_threads<M>())
    cva_multi_greeks_am_kernel(const float* __restrict__ scal,
                               const float* __restrict__ lt_g,
                               const float* __restrict__ par_g,
                               const float* __restrict__ nodes, Launch L,
                               float* __restrict__ out) {
  constexpr int THREADS = am_threads<M>();
  constexpr int N = 4 + 4 * M;
  __shared__ float lt[M * M], par[9 * M], sc[3], sh[(THREADS / 32) * N];
  stage<THREADS>(lt, lt_g, M * M);
  stage<THREADS>(par, par_g, 9 * M);
  stage<THREADS>(sc, scal, 3);
  __syncthreads();
  const int n_elems = L.rows * mct::LANES;
  mct::BlockAccN<THREADS, N, KAHAN> acc;
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = 0.0f;
  for (int i = 0; i < L.iters; ++i) {
    const mct::Key key = iter_key(L, i);
    for (int e = threadIdx.x; e < n_elems; e += THREADS) {
      const uint32_t u = static_cast<uint32_t>(e);
      float q[2 + 2 * M];
      am_greek_walk<M>(lt, par, nodes, sc, L.g, key, u, 1.0f, q);
      if (ANTI) {
        float m[2 + 2 * M];
        am_greek_walk<M>(lt, par, nodes, sc, L.g, key, u, -1.0f, m);
        mct::mirror_mean<M>(q, m);
      }
      mct::add_greek_sums<M>(q, v);
    }
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
}

// K40's, K43's or K44's groups in order, each its split and then its fold;
// out takes 2 Pay::np(M) sums a block, prof Pay::ROWS profile rows.
template <int M, class Pay>
int launch_am(bool anti, bool kahan, const float* scal, const float* lt,
              const float* par, const float* nodes, const Launch& L,
              int n_blocks, const AmSplit& X, float* scratch, float* out,
              float* prof, cudaStream_t s) {
  constexpr int THREADS = am_threads<M>();
  constexpr int NP = Pay::np(M);
  using Add = typename Pay::template Add<M>;
  const auto split = anti ? am_split_kernel<M, true, Pay>
                          : am_split_kernel<M, false, Pay>;
  const auto fold = kahan ? am_fold_kernel<THREADS, true, NP, Add>
                          : am_fold_kernel<THREADS, false, NP, Add>;
  float* carry = scratch;
  float* items = scratch + X.group_blocks * X.carry;
  for (int b0 = 0; b0 < n_blocks; b0 += X.group_blocks) {
    const int nb = std::min(X.group_blocks, n_blocks - b0);
    for (int i0 = 0; i0 < L.iters; i0 += X.group_iters) {
      const int ni = std::min(X.group_iters, L.iters - i0);
      const int warp_items = nb * ni * X.passes * X.warps;
      split<<<(warp_items + AM_SPLIT_WARPS - 1) / AM_SPLIT_WARPS,
              AM_SPLIT_THREADS, 0, s>>>(scal, lt, par, nodes, L, b0, nb, i0,
                                        ni, items);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      fold<<<nb, THREADS, 0, s>>>(items, carry, L, X.gp, b0, ni, X.signs,
                                  i0 == 0, i0 + ni >= L.iters, out, prof);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

template <int M>
void launch_greeks_am(bool anti, bool kahan, const float* scal,
                      const float* lt, const float* par, const float* nodes,
                      const Launch& L, int n_blocks, float* out,
                      cudaStream_t s) {
  using Fn = void (*)(const float*, const float*, const float*, const float*,
                      Launch, float*);
  static const Fn FNS[4] = {cva_multi_greeks_am_kernel<M, false, false>,
                            cva_multi_greeks_am_kernel<M, false, true>,
                            cva_multi_greeks_am_kernel<M, true, false>,
                            cva_multi_greeks_am_kernel<M, true, true>};
  const Fn fn = FNS[(anti ? 2 : 0) | (kahan ? 1 : 0)];
  fn<<<n_blocks, am_threads<M>(), 0, s>>>(scal, lt, par, nodes, L, out);
}

// ------------------------------------------------------------- K39 (m > 8)

// One leg's value in bs_call_hastings' form (the packed TPU kernel's):
// d1 = (log(s / k) + cr tau) / (v sqrt(tau)), cr = r + v^2 / 2; the
// intrinsic value at the last node.
__device__ __forceinline__ float packed_leg(float s, float k, float v,
                                            float cr, const Node& nd,
                                            bool last) {
  if (last) return fmaxf(s - k, 0.0f);
  const float sq = v * nd.sqtau;
  const float d1 = (logf(s / k) + cr * nd.tau) / sq;
  return s * mct::norm_cdf_hastings(d1) -
         k * nd.disc * mct::norm_cdf_hastings(d1 - sq);
}

// One node of packed path q for both signs: log-spots xs (and the mirror's
// xm) at stride np_max in shared memory, z its m normals; the exposures
// through ee and eem.  L z from 0 over the lower triangle; the mirror's is
// the negated sum, exactly; the net sums the path's real legs from 0.  par
// rows: log s0, drift, vol, k, w, v, r + v^2 / 2.
template <bool ANTI>
__device__ __forceinline__ void packed_node(const mct::Packed& P,
                                            const float* __restrict__ lt,
                                            const float* __restrict__ par,
                                            const Node& nd, const float* z,
                                            float* xs, float* xm, float& ee,
                                            float& eem) {
  const int a = P.a;
  const bool last = nd.tau <= 0.0f;
  float net = 0.0f, net_m = 0.0f;
  for (int i = 0; i < a; ++i) {
    const float* lrow = lt + i * a;
    float sum = 0.0f;
    for (int j = 0; j <= i; ++j) sum = sum + __ldg(lrow + j) * z[j];
    const float drift = __ldg(par + a + i), vol = __ldg(par + 2 * a + i);
    const float k = __ldg(par + 3 * a + i), w = __ldg(par + 4 * a + i);
    const float v = __ldg(par + 5 * a + i), cr = __ldg(par + 6 * a + i);
    const float x = xs[i * P.np_max] + drift + vol * sum;
    xs[i * P.np_max] = x;
    net = net + w * packed_leg(expf(x), k, v, cr, nd, last);
    if (ANTI) {
      const float x2 = xm[i * P.np_max] + drift + vol * (-sum);
      xm[i * P.np_max] = x2;
      net_m = net_m + w * packed_leg(expf(x2), k, v, cr, nd, last);
    }
  }
  ee = fmaxf(net, 0.0f);
  eem = fmaxf(net_m, 0.0f);
}

template <bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(mct::PK_THREADS)
    cva_multi_packed_kernel(const float* __restrict__ scal,
                            const float* __restrict__ lt,
                            const float* __restrict__ par,
                            const float* __restrict__ nodes, mct::Packed P,
                            Launch L, float* __restrict__ scratch,
                            float* __restrict__ out,
                            float* __restrict__ ee_out) {
  constexpr int THREADS = mct::PK_THREADS;
  constexpr int WARPS = THREADS / 32;
  extern __shared__ float smem[];
  const int np = P.np_max;
  float* z1s = smem;
  float* z2s = z1s + np * P.ap;
  float* xs = z2s + np * P.ap;
  float* xm = xs + np * P.a;  // the mirror's log-spots (ANTI)
  __shared__ float sh[WARPS * 2];
  float* prof = scratch + static_cast<size_t>(blockIdx.x) * WARPS * L.g * 2;
  profile_zero<THREADS>(prof, WARPS * L.g * 2);
  __syncthreads();
  const float lgd = scal[1];
  const int q = threadIdx.x;
  const int lane = q & 31;
  float* wprof = prof + (q >> 5) * L.g * 2;
  const float half_w = ANTI ? 0.5f : 1.0f;
  mct::BlockAccN<THREADS, 2, KAHAN> acc;
  float v[2] = {0.0f, 0.0f};
  for (int i = 0; i < L.iters; ++i) {
    const mct::Key key = iter_key(L, i);
    for (int c0 = 0; c0 < P.n_chunks; ++c0) {
      // A pass's last rows may lie past rows (set_chunk_even).
      const bool mine = q < np && mct::pass_row(P, c0, q / P.c) < L.rows;
      for (int t = threadIdx.x; t < P.a * np; t += THREADS) {
        const float x0 = __ldg(par + t / np);
        xs[t] = x0;
        if (ANTI) xm[t] = x0;
      }
      float dl = 0.0f, dl_m = 0.0f;  // the default legs, before lgd
      const int pairs = (L.g + 1) / 2;
      for (int jj = 0; jj < pairs; ++jj) {
        mct::draw_pass<THREADS>(P, key, L.rows, c0, jj, z1s, z2s);
        __syncthreads();
        const int dates = min(2, L.g - 2 * jj);
        for (int date = 0; date < dates; ++date) {
          const int j = 2 * jj + date;
          const Node nd = node_at(nodes, L.g, j);
          float ee = 0.0f, eem = 0.0f;
          if (mine) {
            packed_node<ANTI>(P, lt, par, nd, (date ? z2s : z1s) + q * P.ap,
                              xs + q, xm + q, ee, eem);
            dl = dl + nd.dp * ee;
            if (ANTI) dl_m = dl_m + nd.dp * eem;
          }
          // Every lane of the warp: paths past the pass add 0.
          profile_add(wprof, j, half_w, ee, lane);
          if (ANTI) profile_add(wprof, j, half_w, eem, lane);
        }
        __syncthreads();
      }
      if (mine) {
        float cva = lgd * dl;
        if (ANTI) cva = 0.5f * (cva + lgd * dl_m);
        v[0] += cva;
        v[1] += cva * cva;
      }
    }
    acc.add(v, nullptr, sh);
  }
  __syncthreads();
  profile_write<THREADS>(prof, WARPS, L.g, ee_out);
  acc.write(out);
}

// K39 at a_tile AT = 16 or 32 (9-32 underlyings): a path's normals and
// log-spots in its thread's registers, K31's design (multi_walk.cu,
// mw_walk_reg_kernel).  The block stages once L (rows at stride AT, zero
// above the diagonal), the legs' rows and the node table; the thread-to-path
// map, the passes and packed_node's operations in their order are
// cva_multi_packed_kernel's, so the sums and the profile are that kernel's
// bit for bit.  Every lane of a warp runs every node, a lane with no path
// in the pass adding 0 to profile_add's warp sum as there; no barrier sits
// inside the walk.  The legs run in a loop (one copy of packed_leg's code,
// not AT): each node's log-spots pass to it through the thread's own
// column of shared memory.  Two blocks an SM at both tiles: at a_tile 32
// the cap of 128 registers spills a few hundred bytes under antithetic and
// still runs faster than one block an SM at 155-222 registers (PERF.md).
constexpr int CM_REG_MAX = 32;

template <int AT>
struct CmRegOps {
  float4 l[AT * AT / 4];  // L[i][j] at i * AT + j
  float4 step[AT];        // drift, vol of leg i (z, w unused)
  float4 leg[AT];         // k, w, v, r + v^2 / 2 of leg i
  float x0[AT];           // log s0
};

// The net of a node's legs, from 0 in leg order (and the mirror's), from
// the log-spots in the thread's columns xc, xmc: two legs at a time, their
// values formed side by side (independent chains of divides, logf and
// expf) and added in order.
template <int AT, bool ANTI, bool LAST>
__device__ __forceinline__ void reg_net(const CmRegOps<AT>& o, int a,
                                        const float* xc, const float* xmc,
                                        const Node& nd, float& net,
                                        float& net_m) {
  constexpr int T = mct::PK_THREADS;
  int i = 0;
  for (; i + 2 <= a; i += 2) {
    const float4 g0 = mct::lds4(&o.leg[i]), g1 = mct::lds4(&o.leg[i + 1]);
    const float v0 = packed_leg(expf(xc[i * T]), g0.x, g0.z, g0.w, nd, LAST);
    const float v1 =
        packed_leg(expf(xc[(i + 1) * T]), g1.x, g1.z, g1.w, nd, LAST);
    float m0 = 0.0f, m1 = 0.0f;
    if (ANTI) {
      m0 = packed_leg(expf(xmc[i * T]), g0.x, g0.z, g0.w, nd, LAST);
      m1 = packed_leg(expf(xmc[(i + 1) * T]), g1.x, g1.z, g1.w, nd, LAST);
    }
    net = net + g0.y * v0;
    net = net + g1.y * v1;
    if (ANTI) {
      net_m = net_m + g0.y * m0;
      net_m = net_m + g1.y * m1;
    }
  }
  if (i < a) {
    const float4 g = mct::lds4(&o.leg[i]);
    net = net + g.y * packed_leg(expf(xc[i * T]), g.x, g.z, g.w, nd, LAST);
    if (ANTI) {
      net_m = net_m +
              g.y * packed_leg(expf(xmc[i * T]), g.x, g.z, g.w, nd, LAST);
    }
  }
}

// One node of a path for both signs: x (and the mirror's xm) advanced in
// registers (sum = sum + L_ij z_j from j = 0, x + drift + vol sum, the
// mirror's -sum) and written to the thread's columns xc, xmc (stride
// PK_THREADS); then the net over the legs (reg_net) and ee = max(net, 0).
template <int AT, bool ANTI>
__device__ __forceinline__ void reg_node(const CmRegOps<AT>& o, int a,
                                         const float (&z)[AT], float (&x)[AT],
                                         float (&xm)[AT], float* xc,
                                         float* xmc, const Node& nd,
                                         float& ee, float& eem) {
#pragma unroll
  for (int i = 0; i < AT; ++i) {
    if (i < a) {
      float sum = 0.0f;
#pragma unroll
      for (int q = 0; 4 * q <= i; ++q) {
        const float4 l4 = mct::lds4(&o.l[i * (AT / 4) + q]);
        sum = sum + l4.x * z[4 * q];
        if (4 * q + 1 <= i) sum = sum + l4.y * z[4 * q + 1];
        if (4 * q + 2 <= i) sum = sum + l4.z * z[4 * q + 2];
        if (4 * q + 3 <= i) sum = sum + l4.w * z[4 * q + 3];
      }
      const float4 st = mct::lds4(&o.step[i]);
      x[i] = x[i] + st.x + st.y * sum;
      xc[i * mct::PK_THREADS] = x[i];
      if (ANTI) {
        xm[i] = xm[i] + st.x + st.y * (-sum);
        xmc[i * mct::PK_THREADS] = xm[i];
      }
    }
  }
  float net = 0.0f, net_m = 0.0f;
  if (nd.tau <= 0.0f) {
    reg_net<AT, ANTI, true>(o, a, xc, xmc, nd, net, net_m);
  } else {
    reg_net<AT, ANTI, false>(o, a, xc, xmc, nd, net, net_m);
  }
  ee = fmaxf(net, 0.0f);
  eem = fmaxf(net_m, 0.0f);
}

template <int AT, bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(mct::PK_THREADS, 2)
    cva_multi_reg_kernel(const float* __restrict__ scal,
                         const float* __restrict__ lt,
                         const float* __restrict__ par,
                         const float* __restrict__ nodes, mct::Packed P,
                         Launch L, float* __restrict__ scratch,
                         float* __restrict__ out,
                         float* __restrict__ ee_out) {
  constexpr int THREADS = mct::PK_THREADS;
  constexpr int WARPS = THREADS / 32;
  __shared__ CmRegOps<AT> o;
  __shared__ float sh[WARPS * 2];
  extern __shared__ float4 smem4[];
  float4* nodes4 = smem4;  // dp, tau, sqrt(tau), exp(-r tau) of node j
  float* xc = reinterpret_cast<float*>(nodes4 + L.g) + threadIdx.x;
  float* xmc = xc + AT * THREADS;  // the mirror's column (ANTI)
  const int a = P.a;
  float* lf = reinterpret_cast<float*>(o.l);
  for (int t = threadIdx.x; t < AT * AT; t += THREADS) {
    const int i = t / AT, j = t - i * AT;
    lf[t] = (i < a && j <= i) ? lt[i * a + j] : 0.0f;
  }
  for (int t = threadIdx.x; t < AT; t += THREADS) {
    const bool real = t < a;
    o.step[t] = real ? make_float4(par[a + t], par[2 * a + t], 0.0f, 0.0f)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    o.leg[t] = real ? make_float4(par[3 * a + t], par[4 * a + t],
                                  par[5 * a + t], par[6 * a + t])
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    o.x0[t] = real ? par[t] : 0.0f;
  }
  for (int j = threadIdx.x; j < L.g; j += THREADS) {
    const Node nd = node_at(nodes, L.g, j);
    nodes4[j] = make_float4(nd.dp, nd.tau, nd.sqtau, nd.disc);
  }
  float* prof = scratch + static_cast<size_t>(blockIdx.x) * WARPS * L.g * 2;
  profile_zero<THREADS>(prof, WARPS * L.g * 2);
  __syncthreads();
  const float lgd = scal[1];
  const int q = threadIdx.x;
  const int lane = q & 31;
  float* wprof = prof + (q >> 5) * L.g * 2;
  const float half_w = ANTI ? 0.5f : 1.0f;
  const int pairs = (L.g + 1) / 2;
  mct::BlockAccN<THREADS, 2, KAHAN> acc;
  float v[2] = {0.0f, 0.0f};
  for (int it = 0; it < L.iters; ++it) {
    const mct::Key key = iter_key(L, it);
    for (int c0 = 0; c0 < P.n_chunks; ++c0) {
      // A pass's last rows may lie past rows (set_chunk_even).
      const int row = mct::pass_row(P, c0, q / P.c);
      const bool mine = q < P.np_max && row < L.rows;
      const uint32_t e0 =
          static_cast<uint32_t>(row * P.width + (q % P.c) * AT);
      float x[AT], xm[AT];
#pragma unroll
      for (int i = 0; i < AT; ++i) x[i] = xm[i] = mct::lds1(&o.x0[i]);
      float dl = 0.0f, dl_m = 0.0f;  // the default legs, before lgd
      for (int jj = 0; jj < pairs; ++jj) {
        float z[2][AT];
        if (mine) {
#pragma unroll
          for (int m = 0; m < AT; ++m) {
            if (m < a) {
              mct::draw_normal_pair(key, e0 + m, static_cast<uint32_t>(jj),
                                    z[0][m], z[1][m]);
            }
          }
        }
        const int dates = min(2, L.g - 2 * jj);
#pragma unroll
        for (int date = 0; date < 2; ++date) {
          if (date >= dates) break;
          const int j = 2 * jj + date;
          const float4 n4 = nodes4[j];
          const Node nd{n4.x, 0.0f, n4.y, n4.z, n4.w};
          float ee = 0.0f, eem = 0.0f;
          if (mine) {
            reg_node<AT, ANTI>(o, a, z[date], x, xm, xc, xmc, nd, ee, eem);
            dl = dl + nd.dp * ee;
            if (ANTI) dl_m = dl_m + nd.dp * eem;
          }
          // Every lane of the warp: paths past the pass add 0.
          profile_add(wprof, j, half_w, ee, lane);
          if (ANTI) profile_add(wprof, j, half_w, eem, lane);
        }
      }
      if (mine) {
        float cva = lgd * dl;
        if (ANTI) cva = 0.5f * (cva + lgd * dl_m);
        v[0] += cva;
        v[1] += cva * cva;
      }
    }
    acc.add(v, nullptr, sh);
  }
  __syncthreads();
  profile_write<THREADS>(prof, WARPS, L.g, ee_out);
  acc.write(out);
}

// K39's register instance at a_tile AT: its dynamic shared memory (the node
// table and the thread's log-spot columns) and launch.
template <int AT>
int launch_cva_multi_reg(bool anti, bool kahan, const float* scal,
                         const float* lt, const float* par,
                         const float* nodes, const mct::Packed& P,
                         const Launch& L, int n_blocks, float* scratch,
                         float* out, float* ee, cudaStream_t s) {
  using Fn = void (*)(const float*, const float*, const float*, const float*,
                      mct::Packed, Launch, float*, float*, float*);
  static const Fn FNS[4] = {cva_multi_reg_kernel<AT, false, false>,
                            cva_multi_reg_kernel<AT, false, true>,
                            cva_multi_reg_kernel<AT, true, false>,
                            cva_multi_reg_kernel<AT, true, true>};
  const Fn fn = FNS[(anti ? 2 : 0) | (kahan ? 1 : 0)];
  const size_t smem =
      static_cast<size_t>(L.g) * sizeof(float4) +
      (anti ? 2 : 1) * static_cast<size_t>(AT) * mct::PK_THREADS *
          sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<n_blocks, mct::PK_THREADS, smem, s>>>(scal, lt, par, nodes, P, L,
                                             scratch, out, ee);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- K41 (m > 8)

// Past a_tile 32 (the 100-underlying sets) K41's block keeps in shared
// memory, per pass: both nodes' normals (2 np ap), then per underlying and
// path of each sign the log-spot x, the vol tangent dxv and the node's two
// integrands before the indicator (dval0 = w s N(d1), vval0 = dval0 dxv +
// w s phi(d1) sqrt(tau)), then of each sign the lane carries ad and av
// (lgd applied at the end), then K33's partial rows and the block's lane
// rows (greek_shape).  After a pass's walk its (dval, vval) leaves
// ([2][chunk_rows][width]) take the place of the normals, x, dxv and the
// integrands, which span at least as many floats (2 ap + 4 a >= 2
// a_tile); ad and av are read from past them.  The CVA and credit legs
// stay in the path's thread.
constexpr int K41_LANE_FLOATS = 6;

// One node of K41's walk for packed path q and both signs (state pointers
// st at q, stride np_max: x, dxv, dval0, vval0, ad, av of each sign):
// bt = L z from 0 (the mirror's the negated sum), x += drift + vol bt,
// dxv += sqrt(dt) bt - v dt, each leg in am_leg's form (mctpu's
// _greek_node); the path's net from 0 over its real legs, ee = max(net, 0),
// and the indicator 1{net > 0} on its lanes: ad += dp dval0 and av += dp
// vval0 where it is 1.  That equals mctpu's ws = 1{net > 0} w s, dval = ws
// N(d1), vval = dval dxv + ws phi sqrt(tau) bit for bit: where the
// indicator is 0 its terms are zeros, which leave a sum unchanged.  par
// rows as am_node's.
template <bool ANTI>
__device__ __forceinline__ void packed_greek_node(
    const mct::Packed& P, const float* __restrict__ lt,
    const float* __restrict__ par, float r, float sqdt, const Node& nd,
    const float* z, float* const* st, float (&ee)[2]) {
  const int a = P.a, np = P.np_max;
  float net[2] = {0.0f, 0.0f};
  for (int i = 0; i < a; ++i) {
    const float* lrow = lt + i * a;
    float sum = 0.0f;
    for (int j = 0; j <= i; ++j) sum = sum + __ldg(lrow + j) * z[j];
    const float vdt = __ldg(par + 3 * a + i), w = __ldg(par + 4 * a + i);
    const int o = i * np;
#pragma unroll
    for (int sgn = 0; sgn < (ANTI ? 2 : 1); ++sgn) {
      float* const* S = st + 6 * sgn;
      const float b = sgn ? -sum : sum;
      float x = S[0][o], s, nd1, phi;
      const float val = am_leg<true>(b, x, par, a, i, r, nd, s, nd1, phi);
      S[0][o] = x;
      const float dxv = S[1][o] + sqdt * b - vdt;
      S[1][o] = dxv;
      const float ws = w * s;
      const float dval = ws * nd1;
      S[2][o] = dval;
      S[3][o] = dval * dxv + ws * phi * nd.sqtau;
      net[sgn] = net[sgn] + val;
    }
  }
#pragma unroll
  for (int sgn = 0; sgn < (ANTI ? 2 : 1); ++sgn) {
    ee[sgn] = fmaxf(net[sgn], 0.0f);
    if (!(net[sgn] > 0.0f)) continue;
    float* const* S = st + 6 * sgn;
    for (int i = 0; i < a; ++i) {
      const int o = i * np;
      S[4][o] = S[4][o] + nd.dp * S[2][o];
      S[5][o] = S[5][o] + nd.dp * S[3][o];
    }
  }
}

template <bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(mct::PK_THREADS)
    cva_multi_greeks_packed_kernel(const float* __restrict__ scal,
                                   const float* __restrict__ lt,
                                   const float* __restrict__ par,
                                   const float* __restrict__ nodes,
                                   mct::Packed P, Launch L,
                                   float* __restrict__ out,
                                   float* __restrict__ vecs) {
  constexpr int THREADS = mct::PK_THREADS;
  constexpr int NS = ANTI ? 2 : 1;  // signs
  extern __shared__ float smem[];
  const int np = P.np_max, a = P.a, W = P.width, nr = P.chunk_rows;
  float* z1s = smem;
  float* z2s = z1s + np * P.ap;
  float* walk = z2s + np * P.ap;          // x, dxv, dval0, vval0 a sign
  float* carry = walk + 4 * NS * a * np;  // ad, av a sign
  float* part = carry + 2 * NS * a * np;  // [n_chunks][4][W]
  float* vec = part + 4 * P.n_chunks * W;  // [4][W]
  float* leaf = smem;  // [2][nr][W], per pass, over the normals and walk
  float* st[6 * NS];   // per sign: x, dxv, dval0, vval0, ad, av
  for (int sgn = 0; sgn < NS; ++sgn) {
    for (int u = 0; u < 4; ++u) st[6 * sgn + u] = walk + (4 * sgn + u) * a * np;
    st[6 * sgn + 4] = carry + 2 * sgn * a * np;
    st[6 * sgn + 5] = carry + (2 * sgn + 1) * a * np;
  }
  __shared__ float sh[(THREADS / 32) * 4];
  const float r = scal[0], lgd = scal[1], sqdt = scal[2];
  for (int u = threadIdx.x; u < 4 * W; u += THREADS) vec[u] = 0.0f;
  const int q = threadIdx.x;
  mct::BlockAccN<THREADS, 4, KAHAN> acc;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < L.iters; ++i) {
    const mct::Key key = iter_key(L, i);
    for (int c0 = 0; c0 < P.n_chunks; ++c0) {
      for (int u = threadIdx.x; u < a * np; u += THREADS) {
        const float x0 = __ldg(par + u / np);
#pragma unroll
        for (int sgn = 0; sgn < NS; ++sgn) {
          st[6 * sgn][u] = x0;
          st[6 * sgn + 1][u] = 0.0f;
          st[6 * sgn + 4][u] = 0.0f;
          st[6 * sgn + 5][u] = 0.0f;
        }
      }
      float cva[2] = {0.0f, 0.0f}, cr[2] = {0.0f, 0.0f};  // before lgd
      const int pairs = (L.g + 1) / 2;
      for (int jj = 0; jj < pairs; ++jj) {
        mct::draw_pass<THREADS>(P, key, L.rows, c0, jj, z1s, z2s);
        __syncthreads();
        if (q < np) {
          float* sq[6 * NS];  // this path's state
          for (int u = 0; u < 6 * NS; ++u) sq[u] = st[u] + q;
          const int dates = min(2, L.g - 2 * jj);
          for (int date = 0; date < dates; ++date) {
            const Node nd = node_at(nodes, L.g, 2 * jj + date);
            float ee[2];
            packed_greek_node<ANTI>(P, lt, par, r, sqdt, nd,
                                    (date ? z2s : z1s) + q * P.ap, sq, ee);
#pragma unroll
            for (int sgn = 0; sgn < NS; ++sgn) {
              cva[sgn] = cva[sgn] + nd.dp * ee[sgn];
              cr[sgn] = cr[sgn] + nd.ddp * ee[sgn];
            }
          }
        }
        __syncthreads();
      }
      // The (cva, credit) sums and the (dval, vval) leaves of each path's
      // lanes (mctpu's lgd-scaled tiles, the mirror's averaged in); padded
      // lanes get exact zeros.
      if (q < np) {
        float c = lgd * cva[0], d = lgd * cr[0];
        if (ANTI) {
          c = 0.5f * (c + lgd * cva[1]);
          d = 0.5f * (d + lgd * cr[1]);
        }
        v[0] += c;
        v[1] += c * c;
        v[2] += d;
        v[3] += d * d;
        const int rl = q / P.c;
        const int lane0 = (q - rl * P.c) * P.a_tile;
        float* ld = leaf + rl * W + lane0;
        float* lv = leaf + (nr + rl) * W + lane0;
        for (int m = 0; m < P.a_tile; ++m) {
          float dval = 0.0f, vval = 0.0f;
          if (m < a) {
            const int o = m * np + q;
            dval = lgd * st[4][o];
            vval = lgd * st[5][o];
            if constexpr (ANTI) {
              dval = 0.5f * (dval + lgd * st[10][o]);
              vval = 0.5f * (vval + lgd * st[11][o]);
            }
          }
          ld[m] = dval;
          lv[m] = vval;
        }
      }
      __syncthreads();
      mct::pass_tree(P, c0, leaf, part);
      __syncthreads();
    }
    mct::fold_passes(P, part, vec);
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
  for (int u = threadIdx.x; u < 4 * W; u += THREADS) {
    vecs[static_cast<size_t>(blockIdx.x) * 4 * W + u] = vec[u];
  }
}

// K41 at a_tile AT = 16 or 32 (9-32 underlyings): a path in its thread's
// registers, K39's register walk (cva_multi_reg_kernel) with K33's lane
// slots (mw_greeks_reg_kernel).  The block stages once L (rows at stride
// AT, zero above the diagonal), the legs' rows and the node table, read
// as broadcasts at their use.  A pass's walks are (sign, path) items, one
// a thread (in turns where there are more than threads): the item draws
// its path's normals (element row * width + p * AT + m, pair jj:
// draw_pass's counters) and keeps that sign's x and dxv in registers, so
// that under antithetic a thread holds one sign's state, not both, and
// the pass's np paths keep 2 np threads busy (the parent's passes hold
// half its threads' paths there).  The signs are independent until the
// path's sums: each item writes its (cva, credit) legs and adds its ad
// and av into its sign's lane slots ([2 NS][a][np]); after a barrier the
// path's thread forms the sums and the (dval, vval) leaves over its ad and
// av, where bar_leaf_tree reads them.  The item's thread keeps a column of
// shared memory ([2][a] at stride NS np, the pass's item count: the plain
// instance's columns stand np apart as its lane slots do, one stride in
// registers): a node's advanced log-spot and dxv, which the leg loop
// overwrites with dval0 and vval0 until the net's indicator is known.
// The passes (greek_shape), the path-to-thread map of the sums and
// packed_greek_node's operations in their order are
// cva_multi_greeks_packed_kernel's, so out and vecs are that kernel's bit
// for bit; no barrier sits inside the walk.
template <int AT>
struct CmGreekOps {
  float4 l[AT * AT / 4];  // L[i][j] at i * AT + j, zero above the diagonal
  float4 step[AT];        // drift dt, v sqrt(dt), v dt, w of leg i
  float4 leg[AT];         // k, log k, v^2 / 2, v of leg i
  float x0[AT];           // log s0
};

// The net of a node's legs, two at a time (one copy of am_value's code,
// not AT): each leg's value at the advanced log-spot in the thread's
// column (am_value, am_leg's second half, on the leg's rows at stride 1),
// its dval0 = w s N(d1) and vval0 = dval0 dxv + w s phi(d1) sqrt(tau)
// written over the log-spot and dxv there (rows i and a + i, stride nt),
// and the net from 0 in leg order.
template <int AT>
__device__ __forceinline__ float reg_greek_net(const CmGreekOps<AT>& o,
                                               int a, int nt, float r,
                                               const Node& nd, float* col) {
  float net = 0.0f;
  for (int i = 0; i < a; i += 2) {
    const int n = min(2, a - i);
    float val[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u < n) {
        const float4 st = mct::lds4(&o.step[i + u]);
        const float4 g = mct::lds4(&o.leg[i + u]);
        const float pr[9] = {0.0f, st.x, st.y, st.z, st.w,
                             g.x,  g.y,  g.z,  g.w};
        float* cx = col + (i + u) * nt;
        float* cv = cx + a * nt;
        float s, nd1, phi;
        val[u] = am_value<true>(*cx, pr, 1, 0, r, nd, s, nd1, phi);
        const float ws = st.w * s;
        const float dval = ws * nd1;
        const float vval = dval * *cv + ws * phi * nd.sqtau;
        *cx = dval;
        *cv = vval;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u < n) net = net + val[u];
    }
  }
  return net;
}

// One node of an item (packed_greek_node's operations for its sign): bt =
// L z from 0 (the mirror's the negated sum), x += drift + vol bt and dxv
// += sqrt(dt) bt - v dt in registers, both written to the thread's
// column; the net (reg_greek_net); ee = max(net, 0) and, where net > 0,
// ad += dp dval0 and av += dp vval0 in the sign's lane slots (rows i and
// a + i at stride np), in leg order.
template <int AT>
__device__ __forceinline__ float reg_greek_node(
    const CmGreekOps<AT>& o, int a, int np, int nt, float r, float sqdt,
    const Node& nd, const float (&z)[AT], bool mirror, float (&x)[AT],
    float (&dx)[AT], float* col, float* slot) {
#pragma unroll
  for (int i = 0; i < AT; ++i) {
    if (i < a) {
      float sum = 0.0f;
#pragma unroll
      for (int q = 0; 4 * q <= i; ++q) {
        const float4 l4 = mct::lds4(&o.l[i * (AT / 4) + q]);
        sum = sum + l4.x * z[4 * q];
        if (4 * q + 1 <= i) sum = sum + l4.y * z[4 * q + 1];
        if (4 * q + 2 <= i) sum = sum + l4.z * z[4 * q + 2];
        if (4 * q + 3 <= i) sum = sum + l4.w * z[4 * q + 3];
      }
      const float4 st = mct::lds4(&o.step[i]);
      const float b = mirror ? -sum : sum;
      x[i] = x[i] + st.x + st.y * b;
      dx[i] = dx[i] + sqdt * b - st.z;
      col[i * nt] = x[i];
      col[(a + i) * nt] = dx[i];
    }
  }
  const float net = reg_greek_net<AT>(o, a, nt, r, nd, col);
  if (net > 0.0f) {
    for (int i = 0; i < a; ++i) {
      slot[i * np] = slot[i * np] + nd.dp * col[i * nt];
      slot[(a + i) * np] = slot[(a + i) * np] + nd.dp * col[(a + i) * nt];
    }
  }
  return fmaxf(net, 0.0f);
}

template <int AT, bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(mct::PK_THREADS, 2)
    cva_multi_greeks_reg_kernel(const float* __restrict__ scal,
                                const float* __restrict__ lt,
                                const float* __restrict__ par,
                                const float* __restrict__ nodes,
                                mct::Packed P, Launch L,
                                float* __restrict__ out,
                                float* __restrict__ vecs) {
  constexpr int THREADS = mct::PK_THREADS;
  constexpr int NS = ANTI ? 2 : 1;  // signs
  __shared__ CmGreekOps<AT> o;
  __shared__ float sh[(THREADS / 32) * 4];
  extern __shared__ float4 smem4[];
  const int np = P.np_max, a = P.a, W = P.width;
  const int items = NS * np;  // (sign, path) walks a pass, <= NS THREADS
  const int an = a * np;
  float4* nodes4 = smem4;  // dp, tau, sqrt(tau), exp(-r tau) of node j
  float* ddp = reinterpret_cast<float*>(nodes4 + L.g);  // d(dp)/dlambda
  float* legs = ddp + L.g;               // [NS][2][np]: cva, credit
  float* slots = legs + 2 * NS * np;     // [2 NS][a][np]: ad, av a sign
  float* cols = slots + 2 * NS * an;     // [2][a][items]
  float* part = cols + 2 * a * items;    // [n_chunks][4][W]
  float* vec = part + 4 * P.n_chunks * W;  // [4][W]
  float* lf = reinterpret_cast<float*>(o.l);
  for (int t = threadIdx.x; t < AT * AT; t += THREADS) {
    const int i = t / AT, j = t - i * AT;
    lf[t] = (i < a && j <= i) ? lt[i * a + j] : 0.0f;
  }
  for (int t = threadIdx.x; t < AT; t += THREADS) {
    const bool real = t < a;
    o.step[t] = real ? make_float4(par[a + t], par[2 * a + t],
                                   par[3 * a + t], par[4 * a + t])
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    o.leg[t] = real ? make_float4(par[5 * a + t], par[6 * a + t],
                                  par[7 * a + t], par[8 * a + t])
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    o.x0[t] = real ? par[t] : 0.0f;
  }
  for (int j = threadIdx.x; j < L.g; j += THREADS) {
    const Node nd = node_at(nodes, L.g, j);
    nodes4[j] = make_float4(nd.dp, nd.tau, nd.sqtau, nd.disc);
    ddp[j] = nd.ddp;
  }
  for (int u = threadIdx.x; u < 4 * W; u += THREADS) vec[u] = 0.0f;
  __syncthreads();
  const float r = scal[0], lgd = scal[1], sqdt = scal[2];
  const int pairs = (L.g + 1) / 2;
  float* col = cols + threadIdx.x;  // this thread's column
  mct::BlockAccN<THREADS, 4, KAHAN> acc;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int it = 0; it < L.iters; ++it) {
    const mct::Key key = iter_key(L, it);
    for (int c0 = 0; c0 < P.n_chunks; ++c0) {
#pragma unroll 1
      for (int k = 0; k < NS; ++k) {
        const int item = threadIdx.x + k * THREADS;
        if (item >= items) break;
        const int sgn = ANTI && item >= np ? 1 : 0;
        const int q = item - sgn * np;
        const int row = mct::pass_row(P, c0, q / P.c);
        const uint32_t e0 =
            static_cast<uint32_t>(row * W + (q % P.c) * AT);
        float* slot = slots + 2 * sgn * an + q;  // the sign's ad, av rows
        float x[AT], dx[AT];
#pragma unroll
        for (int i = 0; i < AT; ++i) {
          x[i] = mct::lds1(&o.x0[i]);
          dx[i] = 0.0f;
          if (i < a) slot[i * np] = slot[(a + i) * np] = 0.0f;
        }
        float cva = 0.0f, cr = 0.0f;  // before lgd
        for (int jj = 0; jj < pairs; ++jj) {
          float z[2][AT];
#pragma unroll
          for (int m = 0; m < AT; ++m) {
            if (m < a) {
              mct::draw_normal_pair(key, e0 + m, static_cast<uint32_t>(jj),
                                    z[0][m], z[1][m]);
            } else {
              z[0][m] = z[1][m] = 0.0f;
            }
          }
          const int dates = min(2, L.g - 2 * jj);
#pragma unroll
          for (int date = 0; date < 2; ++date) {
            if (date >= dates) break;
            const int j = 2 * jj + date;
            const float4 n4 = nodes4[j];
            const Node nd{n4.x, ddp[j], n4.y, n4.z, n4.w};
            const float ee = reg_greek_node<AT>(o, a, np, items, r, sqdt,
                                                nd, z[date], sgn != 0, x, dx,
                                                col, slot);
            cva = cva + nd.dp * ee;
            cr = cr + nd.ddp * ee;
          }
        }
        legs[2 * sgn * np + q] = cva;
        legs[(2 * sgn + 1) * np + q] = cr;
      }
      __syncthreads();
      // Path q's (cva, credit) sums and (dval, vval) leaves in its
      // thread, in cva_multi_greeks_packed_kernel's operations, the
      // leaves over the path's ad and av.
      const int q = threadIdx.x;
      if (q < np) {
        float c = lgd * legs[q], d = lgd * legs[np + q];
        if (ANTI) {
          c = 0.5f * (c + lgd * legs[2 * np + q]);
          d = 0.5f * (d + lgd * legs[3 * np + q]);
        }
        v[0] += c;
        v[1] += c * c;
        v[2] += d;
        v[3] += d * d;
        for (int m = 0; m < a; ++m) {
          float* sm = slots + m * np + q;
          float dval = lgd * sm[0];
          float vval = lgd * sm[an];
          if (ANTI) {
            dval = 0.5f * (dval + lgd * sm[2 * an]);
            vval = 0.5f * (vval + lgd * sm[3 * an]);
          }
          sm[0] = dval;
          sm[an] = vval;
        }
      }
      __syncthreads();
      mct::bar_leaf_tree(P, c0, slots, slots + an, part);
      __syncthreads();
    }
    mct::fold_passes(P, part, vec);
    acc.add(v, nullptr, sh);
  }
  acc.write(out);
  for (int u = threadIdx.x; u < 4 * W; u += THREADS) {
    vecs[static_cast<size_t>(blockIdx.x) * 4 * W + u] = vec[u];
  }
}

// K41's register instance at a_tile AT: its dynamic shared memory (the
// node table, the items' legs, the lane slots of each sign, the walking
// threads' columns, part and vec) and launch on greek_shape's passes.
template <int AT>
int launch_cva_multi_greeks_reg(bool anti, bool kahan, const float* scal,
                                const float* lt, const float* par,
                                const float* nodes, const mct::Packed& P,
                                const Launch& L, int n_blocks, float* out,
                                float* vecs, cudaStream_t s) {
  using Fn = void (*)(const float*, const float*, const float*, const float*,
                      mct::Packed, Launch, float*, float*);
  static const Fn FNS[4] = {cva_multi_greeks_reg_kernel<AT, false, false>,
                            cva_multi_greeks_reg_kernel<AT, false, true>,
                            cva_multi_greeks_reg_kernel<AT, true, false>,
                            cva_multi_greeks_reg_kernel<AT, true, true>};
  const Fn fn = FNS[(anti ? 2 : 0) | (kahan ? 1 : 0)];
  const size_t items = (anti ? 2 : 1) * static_cast<size_t>(P.np_max);
  const size_t smem =
      static_cast<size_t>(L.g) * (sizeof(float4) + sizeof(float)) +
      (2 * items * (1 + 2 * static_cast<size_t>(P.a)) +
       (4 * static_cast<size_t>(P.n_chunks) + 4) * P.width) *
          sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<n_blocks, mct::PK_THREADS, smem, s>>>(scal, lt, par, nodes, P, L, out,
                                             vecs);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------- K43, K44 (m <= 8)

// The maturity rows of an xVA table: tau, sqrt(tau), exp(-r tau) at rows
// first, first + 1, first + 2 of a (rows, g) table.
__device__ __forceinline__ Node tail_node(const float* __restrict__ nodes,
                                          int g, int j, int first) {
  return Node{0.0f, 0.0f, __ldg(nodes + first * g + j),
              __ldg(nodes + (first + 1) * g + j),
              __ldg(nodes + (first + 2) * g + j)};
}

__device__ __forceinline__ float row_at(const float* __restrict__ nodes,
                                        int g, int row, int j) {
  return __ldg(nodes + row * g + j);
}

// The four xVA legs' node adds (mctpu's _am_xva_step): epe and ene =
// epe - net (no second clamp) times the node weights of K43's table rows
// w_cva, w_dva, w_fnd (K44's, with the LGDs folded in).
__device__ __forceinline__ void xva_legs_add(const float* __restrict__ nodes,
                                             int g, int j, float epe,
                                             float ene, float (&leg)[4]) {
  const float wf = row_at(nodes, g, 2, j);
  leg[0] = leg[0] + row_at(nodes, g, 0, j) * epe;
  leg[1] = leg[1] + row_at(nodes, g, 1, j) * ene;
  leg[2] = leg[2] + wf * epe;
  leg[3] = leg[3] + wf * ene;
}

// One K43 walk of tile element e and sign sgn: the legs (before the LGDs)
// into leg; lane 0 writes each node's warp sums of epe and ene, times
// half_w, to wrow[j] and wrow[g + j].  nodes (6, g): w_cva, w_dva, w_fnd,
// tau, sqrt(tau), disc.
template <int M>
__device__ __forceinline__ void am_xva_walk(const float* lt, const float* par,
                                            const float* nodes, float r,
                                            int g, mct::Key key, uint32_t e,
                                            float sgn, float half_w,
                                            float* wrow, int lane,
                                            float (&leg)[4]) {
  float x[M];
#pragma unroll
  for (int i = 0; i < M; ++i) x[i] = par[i];
  leg[0] = leg[1] = leg[2] = leg[3] = 0.0f;
  mct::walk_pairwise_multi<M>(key, e, g, [&](int j, const float(&z)[M]) {
    float bt[M], s[M], nd1[M], phi[M], net;
    const float epe = am_node<M, false>(z, sgn, x, lt, par, r,
                                        tail_node(nodes, g, j, 3), bt, s, nd1,
                                        phi, net);
    const float ene = epe - net;
    xva_legs_add(nodes, g, j, epe, ene, leg);
    const float te = warp_sum(epe), tn = warp_sum(ene);
    if (lane == 0) {
      wrow[j] = __fmul_rn(half_w, te);
      wrow[g + j] = __fmul_rn(half_w, tn);
    }
  });
}

// The legs of one element's walk (or its antithetic pair's mean) with the
// LGDs applied at the walk's end.
__device__ __forceinline__ void xva_legs(const float (&a)[4],
                                         const float* mirror, float lgd,
                                         float olgd, float (&leg)[4]) {
  leg[0] = lgd * a[0];
  leg[1] = olgd * a[1];
  leg[2] = a[2];
  leg[3] = a[3];
  if (mirror != nullptr) {
    const float m[4] = {lgd * mirror[0], olgd * mirror[1], mirror[2],
                        mirror[3]};
#pragma unroll
    for (int k = 0; k < 4; ++k) leg[k] = 0.5f * (leg[k] + m[k]);
  }
}

// xva_legs added to the per-thread (x, x^2) sums.
__device__ __forceinline__ void xva_leg_sums(const float (&a)[4],
                                             const float* mirror, float lgd,
                                             float olgd, float (&v)[8]) {
  float leg[4];
  xva_legs(a, mirror, lgd, olgd, leg);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] += leg[k];
    v[2 * k + 1] += leg[k] * leg[k];
  }
}

// K43: K40's split walk, threads, element loop, profile slots and fold
// (launch_am) with four legs an element and two profile rows a node (EPE
// then ENE), so at own_intensity = 0 and funding_spread = 0 (w_cva = dp)
// its CVA sums and EPE profile are K40's bit for bit.  scal: r, lgd,
// own_lgd, sqrt(dt).
struct XvaPay {
  static constexpr int ROWS = 2;
  __host__ __device__ static constexpr int np(int) { return 4; }
  template <int M>
  using Add = PairAdd<4>;

  template <int M, bool ANTI>
  __device__ static void walk(const float* lt, const float* par,
                              const float* nodes, const float* scal, int g,
                              mct::Key key, uint32_t e, float half_w,
                              float* wrow, int lane, float (&q)[4]) {
    const float r = scal[0], lgd = scal[1], olgd = scal[2];
    float a[4], m[4];
    am_xva_walk<M>(lt, par, nodes, r, g, key, e, 1.0f, half_w, wrow, lane, a);
    if (ANTI) {
      am_xva_walk<M>(lt, par, nodes, r, g, key, e, -1.0f, half_w,
                     wrow + 2 * g, lane, m);
    }
    xva_legs(a, ANTI ? m : nullptr, lgd, olgd, q);
  }
};

// The xVA Greek node's adds (mctpu's _am_xva_greek_step) after the legs'
// values: the total-xVA weight tw = (wc' + wf) 1{net > 0} + (wd' + wf)
// (1 - 1{net > 0}) on each underlying's pathwise integrands, the legs, and
// the three sensitivities dwc' epe, dwd' ene, dwf (epe - ene).  nodes (9,
// g): wc' = lgd w_cva, wd' = own_lgd w_dva, wf, dwc', dwd', dwf, tau,
// sqrt(tau), disc.  q: [legs 4, sens 3].
__device__ __forceinline__ float xva_greek_weight(
    const float* __restrict__ nodes, int g, int j, float epe, float net,
    float (&q)[7]) {
  const float ene = epe - net;
  const float ind = net > 0.0f ? 1.0f : 0.0f;
  const float wc = row_at(nodes, g, 0, j), wd = row_at(nodes, g, 1, j);
  const float wf = row_at(nodes, g, 2, j);
  const float tw = (wc + wf) * ind + (wd + wf) * (1.0f - ind);
  q[0] = q[0] + wc * epe;
  q[1] = q[1] + wd * ene;
  q[2] = q[2] + wf * epe;
  q[3] = q[3] + wf * ene;
  q[4] = q[4] + row_at(nodes, g, 3, j) * epe;
  q[5] = q[5] + row_at(nodes, g, 4, j) * ene;
  q[6] = q[6] + row_at(nodes, g, 5, j) * (epe - ene);
  return tw;
}

// One K44 walk of tile element e and sign sgn: q = [cva, dva, fca, fba,
// dCVA/dlambda_C, dDVA/dlambda_B, dFVA/dspread, delta_0.., vega_0..]
// (before the host's 1 / s0).  sc: r, lgd, own_lgd, sqrt(dt).
template <int M>
__device__ __forceinline__ void am_xva_greek_walk(const float* lt,
                                                  const float* par,
                                                  const float* nodes,
                                                  const float* sc, int g,
                                                  mct::Key key, uint32_t e,
                                                  float sgn,
                                                  float (&q)[7 + 2 * M]) {
  const float r = sc[0], sqdt = sc[3];
  float x[M], dxv[M], ad[M], av[M], sc7[7];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    x[i] = par[i];
    dxv[i] = ad[i] = av[i] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 7; ++k) sc7[k] = 0.0f;
  mct::walk_pairwise_multi<M>(key, e, g, [&](int j, const float(&z)[M]) {
    float bt[M], s[M], nd1[M], phi[M], net;
    const Node nd = tail_node(nodes, g, j, 6);
    const float epe =
        am_node<M, true>(z, sgn, x, lt, par, r, nd, bt, s, nd1, phi, net);
    const float tw = xva_greek_weight(nodes, g, j, epe, net, sc7);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      dxv[i] = dxv[i] + sqdt * bt[i] - par[3 * M + i];
      const float ws = par[4 * M + i] * s[i];
      const float dval = ws * nd1[i];
      const float vval = dval * dxv[i] + ws * phi[i] * nd.sqtau;
      ad[i] = ad[i] + tw * dval;
      av[i] = av[i] + tw * vval;
    }
  });
#pragma unroll
  for (int k = 0; k < 7; ++k) q[k] = sc7[k];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    q[7 + i] = ad[i];
    q[7 + M + i] = av[i];
  }
}

// K44: K40's split walk, threads, element loop and fold (launch_am) with
// the 7 + 2M Greek outputs an element and no profile rows; the fold adds
// them in mct::add_greek_sums' layout (the seven scalars in pairs, then d..,
// d^2.., v.., v^2..), so each sum's chain of additions and the output rows
// are the unsplit kernel's (K42's walk and BlockAccN order, which an
// unsplit K44 kernel kept) bit for bit.  scal: r, lgd, own_lgd, sqrt(dt).
template <int M>
struct GreekAdd {
  __device__ static void add(const float (&q)[7 + 2 * M],
                             float (&v)[14 + 4 * M]) {
    mct::add_greek_sums<M, 7>(q, v);
  }
};

struct XvaGreekPay {
  static constexpr int ROWS = 0;
  __host__ __device__ static constexpr int np(int m) { return 7 + 2 * m; }
  template <int M>
  using Add = GreekAdd<M>;

  template <int M, bool ANTI>
  __device__ static void walk(const float* lt, const float* par,
                              const float* nodes, const float* scal, int g,
                              mct::Key key, uint32_t e, float, float*, int,
                              float (&q)[7 + 2 * M]) {
    am_xva_greek_walk<M>(lt, par, nodes, scal, g, key, e, 1.0f, q);
    if (ANTI) {
      float m[7 + 2 * M];
      am_xva_greek_walk<M>(lt, par, nodes, scal, g, key, e, -1.0f, m);
      mct::mirror_mean<M, 7>(q, m);
    }
  }
};

// ------------------------------------- K43, K44 at any m (runtime m)

// Beyond 8 underlyings mctpu serves xVA with its asset-major XLA twin (a
// Threefry stream); here the asset-major Philox map extends to any m (pair
// jj draws counters jj m + i, as walk_pairwise_multi for any A) and one
// thread walks one path element.  Both kernels are split into slices of a
// simulation block's rows and folded (below).  Up to 32 underlyings a
// thread's log-spots and normals (and K44's vol tangents) sit in registers;
// past them, in global scratch: per thread WIDE_THREADS-strided slots
// (coalesced over a warp), L and the per-leg rows read there through the
// read-only cache (every thread of a warp on the same entry).  The node
// math is am_leg's and the order of every path's sums K43's and K44's, so
// the runtime-m kernels match the M <= 8 ones but for the order of the
// block reduction.
constexpr int WIDE_THREADS = 256;

// One runtime-m node over slot pointers at stride T: x and z (and, for the
// Greeks, dxv, the integrands dval and vval before the total-xVA weight);
// returns epe and sets net.
template <bool GREEKS>
__device__ __forceinline__ float wide_node(int m, const float* __restrict__ lt,
                                           const float* __restrict__ par,
                                           float r, float sqdt,
                                           const Node& nd, float sgn,
                                           const float* z, float* x,
                                           float* dxv, float* dv, float* vv,
                                           int T, float& net) {
  float value = 0.0f;
  for (int i = 0; i < m; ++i) {
    const float* lrow = lt + i * m;
    float b = __ldg(lrow) * (sgn * z[0]);
    for (int j = 1; j <= i; ++j) b = b + __ldg(lrow + j) * (sgn * z[j * T]);
    float xi = x[i * T], s, nd1, phi;
    const float val = am_leg<GREEKS>(b, xi, par, m, i, r, nd, s, nd1, phi);
    x[i * T] = xi;
    if (GREEKS) {
      const float d = dxv[i * T] + sqdt * b - __ldg(par + 3 * m + i);
      dxv[i * T] = d;
      const float ws = __ldg(par + 4 * m + i) * s;
      const float dval = ws * nd1;
      dv[i * T] = dval;
      vv[i * T] = dval * d + ws * phi * nd.sqtau;
    }
    value = (i == 0) ? val : value + val;
  }
  net = value;
  return fmaxf(value, 0.0f);
}

// Drives a runtime-m walk over g nodes: pair jj draws counters jj m + i
// into z1, z2 (stride T), node 2jj takes z1 and 2jj + 1 z2; an odd g takes
// the cosine branches of pair g / 2 last (mct::walk_pairwise_multi at any
// m).
template <typename NodeFn>
__device__ __forceinline__ void wide_walk(mct::Key key, uint32_t e, int m,
                                          int g, float* z1, float* z2, int T,
                                          NodeFn&& node) {
  auto draw = [&](int jj) {
    for (int i = 0; i < m; ++i) {
      float a, b;
      mct::draw_normal_pair(key, e, static_cast<uint32_t>(jj * m + i), a, b);
      z1[i * T] = a;
      z2[i * T] = b;
    }
  };
  const int half = g / 2;
  for (int jj = 0; jj < half; ++jj) {
    draw(jj);
    node(2 * jj, z1);
    node(2 * jj + 1, z2);
  }
  if (g & 1) {
    draw(half);
    node(g - 1, z1);
  }
}

// K43 past 8 underlyings, split: simulation block b's rows are cut into
// slices of XVA_SLICE_ROWS rows, one CUDA block per (b, slice), so a
// 2^20-path launch of 32 simulation blocks of 256 rows runs on 1024 CUDA
// blocks.  A slice walks its elements with the runtime-m map (element e =
// row * 128 + lane, counters jj m + i under b's and the iteration's key),
// keeps its warps' compensated profile slots in shared memory, and writes
// per iteration its 8 leg sums reduced over the block (the warp-shuffle
// tree, then the warps in order) and at the end its profile row (the warps'
// slots in order).  xva_fold_kernel then adds the slices in order: the
// iteration's slice sums, Kahan-carried over the iterations under KAHAN
// (BlockAccN's form), and the profile rows.  Every path's draws and node
// values are the unsplit walk's; only the order of the sums moves, and it
// depends on the plan alone, so two launches and any block offset give the
// same bits.  Up to XVA_REG_MAX underlyings a thread keeps x and both
// nodes' normals in registers (tile MT 16 or 32, L and the per-leg rows
// staged in shared memory at stride MT); beyond, in global scratch through
// wide_node and wide_walk, with the grid capped at the blocks the card
// holds at once and each CUDA block taking (b, slice) items in turn.
constexpr int XVA_SLICE_ROWS = 8;
constexpr int XVA_REG_MAX = 32;
// Dynamic shared memory for the profile slots; past it they go to scratch.
constexpr int XVA_PROF_SMEM_MAX = 200 * 1024;

__host__ __device__ inline int xva_slices(int rows) {
  return (rows + XVA_SLICE_ROWS - 1) / XVA_SLICE_ROWS;
}

// L and the per-leg rows of a register tile, at stride MT.
template <int MT>
struct XvaOps {
  float l[MT * MT];
  float par[9 * MT];
};

// One runtime-m node over a register tile (wide_node's operations in its
// order); zs holds the signed normals sgn * z.  For the Greeks also the
// vol tangents dxv and each leg's integrands dval, vval before the
// total-xVA weight, to dv[i T], vv[i T].  The staged operands are read at
// their use (mct::lds1), not held across the walk.
template <int MT, bool GREEKS>
__device__ __forceinline__ float reg_node(int m, const XvaOps<MT>& o, float r,
                                          float sqdt, const Node& nd,
                                          const float (&zs)[MT],
                                          float (&x)[MT], float (&dxv)[MT],
                                          float* dv, float* vv, int T,
                                          float& net) {
  float value = 0.0f;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i < m) {
      float b = mct::lds1(&o.l[i * MT]) * zs[0];
#pragma unroll
      for (int j = 1; j <= i; ++j) {
        b = b + mct::lds1(&o.l[i * MT + j]) * zs[j];
      }
      float pr[9];  // leg i's rows, read by am_leg at stride 1
#pragma unroll
      for (int k = 0; k < 9; ++k) {  // am_leg reads rows 1, 2 and 4-8
        pr[k] = (k == 0 || (k == 3 && !GREEKS))
                    ? 0.0f
                    : mct::lds1(&o.par[k * MT + i]);
      }
      float s, nd1, phi;
      const float val = am_leg<GREEKS>(b, x[i], pr, 1, 0, r, nd, s, nd1, phi);
      if (GREEKS) {
        const float d = dxv[i] + sqdt * b - pr[3];
        dxv[i] = d;
        const float ws = pr[4] * s;
        const float dval = ws * nd1;
        dv[i * T] = dval;
        vv[i * T] = dval * d + ws * phi * nd.sqtau;
      }
      value = (i == 0) ? val : value + val;
    }
  }
  net = value;
  return fmaxf(value, 0.0f);
}

// One K43 walk of element e and sign sgn over a register tile: the legs
// (before the LGDs) into leg, each node's epe and ene to the warp's slots.
template <int MT>
__device__ __forceinline__ void reg_xva_walk(const XvaOps<MT>& o,
                                             const float* __restrict__ nodes,
                                             int m, int g, float r,
                                             mct::Key key, uint32_t e,
                                             float sgn, float half_w,
                                             float* wprof, int lane,
                                             float (&leg)[4]) {
  float x[MT], lg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < MT; ++i) x[i] = o.par[i];
  const int pairs = (g + 1) / 2;
  for (int jj = 0; jj < pairs; ++jj) {
    float z1[MT], z2[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < m) {
        mct::draw_normal_pair(key, e, static_cast<uint32_t>(jj * m + i),
                              z1[i], z2[i]);
      }
    }
    const int dates = min(2, g - 2 * jj);
#pragma unroll 1
    for (int d = 0; d < dates; ++d) {
      float zs[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) zs[i] = sgn * (d ? z2[i] : z1[i]);
      const int j = 2 * jj + d;
      float net;
      const float epe = reg_node<MT, false>(m, o, r, 0.0f,
                                            tail_node(nodes, g, j, 3), zs, x,
                                            x, nullptr, nullptr, 0, net);
      xva_legs_add(nodes, g, j, epe, epe - net, lg);
      profile_add(wprof, j, half_w, epe, lane);
      profile_add(wprof, g + j, half_w, epe - net, lane);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) leg[k] = lg[k];
}

// A split launch: its slices a simulation block, (block, slice) items and
// CUDA blocks, whether the profile slots fit in shared memory, and its
// scratch in floats: the slices' iteration sums [B][iters][S][8] and
// profile rows [B][S][2g], then per CUDA block of the grid its profile
// slots [WARPS][2g][2] when they are not in shared memory and, past the
// register tiles, its threads' state [3][m][THREADS].
struct XvaSplit {
  int slices, items, grid;
  bool prof_smem;
  size_t total;
};

int xva_mt(int m) { return m <= 16 ? 16 : (m <= XVA_REG_MAX ? 32 : 0); }

template <int MT, bool ANTI>
__global__ void __launch_bounds__(WIDE_THREADS, MT == 16 ? 2 : 1)
    xva_slice_kernel(const float* __restrict__ scal,
                     const float* __restrict__ lt,
                     const float* __restrict__ par,
                     const float* __restrict__ nodes, int m, Launch L,
                     int n_blocks, int slices, int prof_smem,
                     float* __restrict__ scratch) {
  constexpr int THREADS = WIDE_THREADS;
  constexpr int WARPS = THREADS / 32;
  extern __shared__ float smem[];  // the profile slots, when prof_smem
  __shared__ XvaOps<MT == 0 ? 1 : MT> o;
  __shared__ float sh[WARPS * 8];
  const int g2 = 2 * L.g, items = n_blocks * slices;
  const size_t n_slot = static_cast<size_t>(WARPS) * g2 * 2;
  float* sums = scratch;
  float* sprof = sums + static_cast<size_t>(items) * L.iters * 8;
  float* slots_g = sprof + static_cast<size_t>(items) * g2;
  float* prof = prof_smem ? smem : slots_g + blockIdx.x * n_slot;
  float* state = slots_g + (prof_smem ? 0 : gridDim.x * n_slot) +
                 static_cast<size_t>(blockIdx.x) * 3 * m * THREADS +
                 threadIdx.x;
  if constexpr (MT > 0) {
    for (int t = threadIdx.x; t < MT * MT; t += THREADS) {
      const int i = t / MT, j = t - i * MT;
      o.l[t] = (i < m && j <= i) ? lt[i * m + j] : 0.0f;
    }
    for (int t = threadIdx.x; t < 9 * MT; t += THREADS) {
      const int k = t / MT, i = t - k * MT;
      o.par[t] = i < m ? par[k * m + i] : 0.0f;
    }
  }
  const float r = scal[0], lgd = scal[1], olgd = scal[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* wprof = prof + warp * g2 * 2;
  const float half_w = ANTI ? 0.5f : 1.0f;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / slices, sl = item - b * slices;
    const int e0 = sl * XVA_SLICE_ROWS * mct::LANES;
    const int e1 = min(L.rows, (sl + 1) * XVA_SLICE_ROWS) * mct::LANES;
    profile_zero<THREADS>(prof, static_cast<int>(n_slot));
    __syncthreads();
    float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < L.iters; ++i) {
      const mct::Key key = mct::seed_key(
          L.seed, (L.off + static_cast<uint32_t>(b)) *
                          static_cast<uint32_t>(L.iters) +
                      static_cast<uint32_t>(i));
      for (int base = e0; base < e1; base += THREADS) {
        if (base + warp * 32 >= e1) continue;  // whole warps
        const uint32_t e = static_cast<uint32_t>(base + threadIdx.x);
        float legs[2][4];
#pragma unroll 1
        for (int sg = 0; sg < (ANTI ? 2 : 1); ++sg) {
          const float sgn = sg ? -1.0f : 1.0f;
          if constexpr (MT > 0) {
            reg_xva_walk<MT>(o, nodes, m, L.g, r, key, e, sgn, half_w, wprof,
                             lane, legs[sg]);
          } else {
            float(&leg)[4] = legs[sg];
            for (int k = 0; k < 4; ++k) leg[k] = 0.0f;
            float* x = state;
            float* z1 = x + m * THREADS;
            float* z2 = z1 + m * THREADS;
            for (int u = 0; u < m; ++u) x[u * THREADS] = __ldg(par + u);
            wide_walk(key, e, m, L.g, z1, z2, THREADS,
                      [&](int j, const float* z) {
                        float net;
                        const float epe = wide_node<false>(
                            m, lt, par, r, 0.0f, tail_node(nodes, L.g, j, 3),
                            sgn, z, x, nullptr, nullptr, nullptr, THREADS,
                            net);
                        xva_legs_add(nodes, L.g, j, epe, epe - net, leg);
                        profile_add(wprof, j, half_w, epe, lane);
                        profile_add(wprof, L.g + j, half_w, epe - net, lane);
                      });
          }
        }
        xva_leg_sums(legs[0], ANTI ? legs[1] : nullptr, lgd, olgd, v);
      }
      mct::block_row<THREADS, 8>(
          v, sh, sums + ((static_cast<size_t>(b) * L.iters + i) * slices +
                         sl) * 8);
    }
    // block_row's barrier orders the last profile adds before these reads.
    profile_write_to<THREADS>(prof, WARPS, g2,
                              sprof + static_cast<size_t>(item) * g2);
    __syncthreads();
  }
}

// The slices of each simulation block added in order (mct::slice_fold): the
// 8 leg sums into out (B, 8), the profile rows into prof_out (B, 2g).
template <bool KAHAN>
__global__ void xva_fold_kernel(const float* __restrict__ scratch,
                                int n_blocks, int iters, int slices, int g2,
                                float* __restrict__ out,
                                float* __restrict__ prof_out) {
  mct::slice_fold<8, KAHAN>(scratch, n_blocks, iters, slices, g2,
                            blockIdx.x * blockDim.x + threadIdx.x, out,
                            prof_out);
}

// K44 past 8 underlyings, split as K43's: one CUDA block of WIDE_THREADS
// per (simulation block, slice of XVA_SLICE_ROWS rows), 1024 CUDA blocks
// at 2^20 paths.  A thread walks one element a pass, each sign in turn on
// the same draws: up to XVA_REG_MAX underlyings its log-spots, vol tangents
// and both nodes' normals in registers (reg_node's tile, MT 16 or 32) and
// each node's integrands dval, vval and the carries ad, av (of the mirror
// too under ANTI) in its own columns of shared memory (stride WIDE_THREADS,
// no bank conflicts); past them all of it in global scratch (wide_node,
// wide_walk), the grid capped at the blocks the card holds at once and at
// XVA_GREEK_STATE_CAP floats of state, each CUDA block taking (b, slice)
// items in turn.  Per iteration a slice writes its 14 scalar sums (each
// thread's plain sums over its passes, then block_row's tree) and its 4m
// per-underlying sums (d.., d^2.., v.., v^2..: each pass's values reduced
// over the block by the warp-shuffle tree and the warps in order, added
// pass by pass) to scratch [B][iters][S][14 + 4m]; xva_greek_fold_kernel
// adds the slices in order, Kahan-carried over the iterations under KAHAN
// (mct::slice_fold_n).  The simulation blocks and iterations go in groups
// under a cap in floats (mct::scratch_groups), the fold's carry kept in
// scratch between them.  Every path's values are the M <= 8 kernel's and
// the plain version's; the order of the sums depends on the plan alone.
constexpr int XVA_GREEK_N_SCAL = 14;
constexpr size_t XVA_GREEK_STATE_CAP = size_t{64} << 20;  // floats: 256 MB

// The items of a group: simulation blocks b0 .. b0 + nb, iterations i0 ..
// i0 + ni, slices a block.
struct SliceItems {
  int b0, nb, i0, ni, slices;
};

// A node's total-xVA weight on each underlying's integrands (slots at
// stride T): ad += tw dval, av += tw vval (mctpu's _am_xva_greek_step).
__device__ __forceinline__ void greek_weight_adds(int m, float tw,
                                                  const float* dv,
                                                  const float* vv, float* ad,
                                                  float* av, int T) {
  for (int u = 0; u < m; ++u) {
    ad[u * T] = ad[u * T] + tw * dv[u * T];
    av[u * T] = av[u * T] + tw * vv[u * T];
  }
}

// One K44 walk of element e and sign sgn over a register tile: q7 the legs
// and the three sensitivities, ad and av (slots at stride T) the
// per-underlying delta and vega integrands; dv, vv a node's.  nodes (9, g).
template <int MT>
__device__ __forceinline__ void reg_xva_greek_walk(
    const XvaOps<MT>& o, const float* __restrict__ nodes, int m, int g,
    float r, float sqdt, mct::Key key, uint32_t e, float sgn, float* dv,
    float* vv, float* ad, float* av, int T, float (&q7)[7]) {
  float x[MT], dxv[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    x[i] = o.par[i];
    dxv[i] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 7; ++k) q7[k] = 0.0f;
  for (int u = 0; u < m; ++u) ad[u * T] = av[u * T] = 0.0f;
  const int pairs = (g + 1) / 2;
  for (int jj = 0; jj < pairs; ++jj) {
    float z1[MT], z2[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < m) {
        mct::draw_normal_pair(key, e, static_cast<uint32_t>(jj * m + i),
                              z1[i], z2[i]);
      }
    }
    const int dates = min(2, g - 2 * jj);
#pragma unroll 1
    for (int d = 0; d < dates; ++d) {
      float zs[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) zs[i] = sgn * (d ? z2[i] : z1[i]);
      const int j = 2 * jj + d;
      const Node nd = tail_node(nodes, g, j, 6);
      float net;
      const float epe = reg_node<MT, true>(m, o, r, sqdt, nd, zs, x, dxv, dv,
                                           vv, T, net);
      const float tw = xva_greek_weight(nodes, g, j, epe, net, q7);
      greek_weight_adds(m, tw, dv, vv, ad, av, T);
    }
  }
}

// The same walk with its whole state in global slots (stride T): x, dxv,
// z1, z2 at st, 2 st, .. m T apart.
__device__ __forceinline__ void wide_xva_greek_walk(
    const float* __restrict__ lt, const float* __restrict__ par,
    const float* __restrict__ nodes, int m, int g, float r, float sqdt,
    mct::Key key, uint32_t e, float sgn, float* st, float* dv, float* vv,
    float* ad, float* av, int T, float (&q7)[7]) {
  float* x = st;
  float* dxv = x + m * T;
  float* z1 = dxv + m * T;
  float* z2 = z1 + m * T;
#pragma unroll
  for (int k = 0; k < 7; ++k) q7[k] = 0.0f;
  for (int u = 0; u < m; ++u) {
    x[u * T] = __ldg(par + u);
    dxv[u * T] = ad[u * T] = av[u * T] = 0.0f;
  }
  wide_walk(key, e, m, g, z1, z2, T, [&](int j, const float* z) {
    float net;
    const Node nd = tail_node(nodes, g, j, 6);
    const float epe = wide_node<true>(m, lt, par, r, sqdt, nd, sgn, z, x,
                                      dxv, dv, vv, T, net);
    const float tw = xva_greek_weight(nodes, g, j, epe, net, q7);
    greek_weight_adds(m, tw, dv, vv, ad, av, T);
  });
}

// Adds this pass's 4m per-underlying values (d, d^2, v, v^2 of the
// element's delta and vega, the antithetic pair's mean under ANTI: ad, av
// of sign 0 at a0, of the mirror at a1), reduced over the block by the
// warp-shuffle tree and then the warps in order, into acc[4m] (shared).
// Every thread calls it; an idle warp (past a short slice) adds zeros.
// sh: WARPS * 4m floats.
template <int THREADS, bool ANTI>
__device__ __forceinline__ void pass_vec_sums(int m, bool active,
                                              const float* a0,
                                              const float* a1, float* sh,
                                              float* acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n4 = 4 * m;
  for (int u = 0; u < m; ++u) {
    float d = 0.0f, w = 0.0f;
    if (active) {
      d = a0[u * THREADS];
      w = a0[(m + u) * THREADS];
      if (ANTI) {
        d = 0.5f * (d + a1[u * THREADS]);
        w = 0.5f * (w + a1[(m + u) * THREADS]);
      }
    }
    const float vals[4] = {d, d * d, w, w * w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float t = warp_sum(vals[c]);
      if (lane == 0) sh[warp * n4 + c * m + u] = t;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n4; k += THREADS) {
    float t = sh[k];
    for (int w = 1; w < THREADS / 32; ++w) t = __fadd_rn(t, sh[w * n4 + k]);
    acc[k] = __fadd_rn(acc[k], t);
  }
  __syncthreads();
}

template <int MT, bool ANTI>
__global__ void __launch_bounds__(WIDE_THREADS, MT == 16 ? 2 : 1)
    xva_greek_slice_kernel(const float* __restrict__ scal,
                           const float* __restrict__ lt,
                           const float* __restrict__ par,
                           const float* __restrict__ nodes, int m, Launch L,
                           SliceItems I, float* __restrict__ sums,
                           float* __restrict__ state) {
  constexpr int T = WIDE_THREADS;
  constexpr int WARPS = T / 32;
  constexpr int NS = XVA_GREEK_N_SCAL;
  extern __shared__ float smem[];
  __shared__ XvaOps<MT == 0 ? 1 : MT> o;
  __shared__ float sh[WARPS * NS];
  const int n4 = 4 * m, n = NS + n4;
  float* sh4 = smem;               // [WARPS][4m]
  float* acc = sh4 + WARPS * n4;   // the (slice, iteration)'s 4m sums
  // A thread's slots at stride T: dv, vv, then ad, av of each sign; past
  // the register tiles x, dxv, z1, z2 before them, in global scratch.
  float* slots = MT > 0 ? acc + n4 + threadIdx.x
                        : state + static_cast<size_t>(blockIdx.x) *
                                      (ANTI ? 10 : 8) * m * T +
                              threadIdx.x;
  float* st = slots;
  if (MT == 0) slots += 4 * m * T;
  float* dv = slots;
  float* vv = dv + m * T;
  float* a0 = vv + m * T;  // ad, av of sign 0
  float* a1 = a0 + 2 * m * T;  // of the mirror (ANTI)
  if constexpr (MT > 0) {
    for (int t = threadIdx.x; t < MT * MT; t += T) {
      const int i = t / MT, j = t - i * MT;
      o.l[t] = (i < m && j <= i) ? lt[i * m + j] : 0.0f;
    }
    for (int t = threadIdx.x; t < 9 * MT; t += T) {
      const int k = t / MT, i = t - k * MT;
      o.par[t] = i < m ? par[k * m + i] : 0.0f;
    }
  }
  for (int k = threadIdx.x; k < n4; k += T) acc[k] = 0.0f;
  __syncthreads();
  const float r = scal[0], sqdt = scal[3];
  const int warp = threadIdx.x >> 5;
  const int items = I.nb * I.slices;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int bl = item / I.slices, sl = item - bl * I.slices;
    const int e0 = sl * XVA_SLICE_ROWS * mct::LANES;
    const int e1 = min(L.rows, (sl + 1) * XVA_SLICE_ROWS) * mct::LANES;
    for (int il = 0; il < I.ni; ++il) {
      const mct::Key key = mct::seed_key(
          L.seed, (L.off + static_cast<uint32_t>(I.b0 + bl)) *
                          static_cast<uint32_t>(L.iters) +
                      static_cast<uint32_t>(I.i0 + il));
      float v[NS];
#pragma unroll
      for (int k = 0; k < NS; ++k) v[k] = 0.0f;
      for (int base = e0; base < e1; base += T) {
        const bool active = base + warp * 32 < e1;  // whole warps
        if (active) {
          const uint32_t e = static_cast<uint32_t>(base + threadIdx.x);
          float q[2][7];
#pragma unroll 1
          for (int sg = 0; sg < (ANTI ? 2 : 1); ++sg) {
            const float sgn = sg ? -1.0f : 1.0f;
            float* ad = sg ? a1 : a0;
            if constexpr (MT > 0) {
              reg_xva_greek_walk<MT>(o, nodes, m, L.g, r, sqdt, key, e, sgn,
                                     dv, vv, ad, ad + m * T, T, q[sg]);
            } else {
              wide_xva_greek_walk(lt, par, nodes, m, L.g, r, sqdt, key, e,
                                  sgn, st, dv, vv, ad, ad + m * T, T, q[sg]);
            }
          }
          // mct::mirror_mean and add_greek_sums' scalars.
#pragma unroll
          for (int k = 0; k < 7; ++k) {
            const float y = ANTI ? 0.5f * (q[0][k] + q[1][k]) : q[0][k];
            v[2 * k] += y;
            v[2 * k + 1] += y * y;
          }
        }
        pass_vec_sums<T, ANTI>(m, active, a0, a1, sh4, acc);
      }
      float* dst =
          sums + ((static_cast<size_t>(bl) * I.ni + il) * I.slices + sl) * n;
      mct::block_row<T, NS>(v, sh, dst);
      for (int k = threadIdx.x; k < n4; k += T) {
        dst[NS + k] = acc[k];
        acc[k] = 0.0f;
      }
    }
  }
}

// The slices of each simulation block of a group added in order
// (mct::slice_fold_n), carried between groups of iterations: n = 14 + 4m
// sums into out (offset to the group's first block).
template <bool KAHAN>
__global__ void xva_greek_fold_kernel(const float* __restrict__ sums,
                                      float* __restrict__ carry, int nb,
                                      int ni, int slices, int n, int first,
                                      int last, float* __restrict__ out) {
  mct::slice_fold_n<KAHAN>(sums, nb, ni, slices, n, 0,
                           blockIdx.x * blockDim.x + threadIdx.x, out,
                           nullptr, mct::FoldCarry{carry, first, last});
}

int warps_of(int m) {
  switch (m) {
    case 1: return am_threads<1>() / 32;
    case 2: return am_threads<2>() / 32;
    case 3: return am_threads<3>() / 32;
    case 4: return am_threads<4>() / 32;
    case 5: return am_threads<5>() / 32;
    case 6: return am_threads<6>() / 32;
    case 7: return am_threads<7>() / 32;
    case MAX_AM: return am_threads<MAX_AM>() / 32;
    default: return WIDE_THREADS / 32;  // K39's PK_THREADS, the same
  }
}

Launch make_launch(int g, int seed, int off, int rows, int iters) {
  return Launch{g, static_cast<uint32_t>(seed), static_cast<uint32_t>(off),
                rows, iters};
}

// The split plan of K40 (Pay = CvaPay), K43 (XvaPay) or K44 (XvaGreekPay)
// at m underlyings and g nodes under a cap in floats (0: AM_SCRATCH_CAP).
template <class Pay>
AmSplit am_split(int m, int g, int n_blocks, int rows, int iters, bool anti,
                 size_t cap) {
  AmSplit X{};
  X.warps = warps_of(m);
  const int threads = X.warps * 32, n_elems = rows * mct::LANES;
  X.passes = (n_elems + threads - 1) / threads;
  X.signs = anti ? 2 : 1;
  X.np = Pay::np(m);
  X.gp = Pay::ROWS * g;
  X.carry = 4 * static_cast<size_t>(X.np) +
            static_cast<size_t>(X.warps) * X.gp * 2;
  X.per_item = static_cast<size_t>(X.np) * n_elems +
               static_cast<size_t>(X.passes) * X.warps * X.signs * X.gp;
  const mct::ScratchGroups G = mct::scratch_groups(
      n_blocks, iters, X.carry, X.per_item, cap == 0 ? AM_SCRATCH_CAP : cap);
  X.group_blocks = G.blocks;
  X.group_iters = G.iters;
  X.total = G.total;
  return X;
}

using SliceFn = void (*)(const float*, const float*, const float*,
                         const float*, int, Launch, int, int, int, float*);

SliceFn slice_fn(int m, bool anti) {
  switch (xva_mt(m)) {
    case 16:
      return anti ? xva_slice_kernel<16, true> : xva_slice_kernel<16, false>;
    case XVA_REG_MAX:
      return anti ? xva_slice_kernel<XVA_REG_MAX, true>
                  : xva_slice_kernel<XVA_REG_MAX, false>;
    default:
      return anti ? xva_slice_kernel<0, true> : xva_slice_kernel<0, false>;
  }
}

// Bytes of a CUDA block's profile slots ([WARPS][2g][2] floats).
size_t xva_slot_bytes(int g) {
  return static_cast<size_t>(WIDE_THREADS / 32) * 2 * g * 2 * sizeof(float);
}

// The split launch of a runtime-m K43: its slices, grid and scratch.  Past
// the register tiles the grid is the blocks the card holds at once (by the
// occupancy of the antithetic instance), capped at the items; the sums do
// not depend on it.
XvaSplit xva_split(int m, int g, int n_blocks, int rows, int iters) {
  XvaSplit X{};
  X.slices = xva_slices(rows);
  X.items = n_blocks * X.slices;
  X.prof_smem = xva_slot_bytes(g) <= XVA_PROF_SMEM_MAX;
  X.grid = X.items;
  if (xva_mt(m) == 0) {
    const SliceFn fn = slice_fn(m, true);
    const size_t smem = X.prof_smem ? xva_slot_bytes(g) : 0;
    int dev = 0, sms = 1, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, WIDE_THREADS,
                                                  smem);
    X.grid = std::min(X.items, std::max(1, per_sm) * sms);
  }
  const size_t slot = xva_slot_bytes(g) / sizeof(float);
  X.total = static_cast<size_t>(X.items) * (iters * 8 + 2 * g) +
            (X.prof_smem ? 0 : static_cast<size_t>(X.grid) * slot) +
            (xva_mt(m) == 0
                 ? static_cast<size_t>(X.grid) * 3 * m * WIDE_THREADS
                 : 0);
  return X;
}

using GreekSliceFn = void (*)(const float*, const float*, const float*,
                              const float*, int, Launch, SliceItems, float*,
                              float*);

GreekSliceFn greek_slice_fn(int m, bool anti) {
  switch (xva_mt(m)) {
    case 16:
      return anti ? xva_greek_slice_kernel<16, true>
                  : xva_greek_slice_kernel<16, false>;
    case XVA_REG_MAX:
      return anti ? xva_greek_slice_kernel<XVA_REG_MAX, true>
                  : xva_greek_slice_kernel<XVA_REG_MAX, false>;
    default:
      return anti ? xva_greek_slice_kernel<0, true>
                  : xva_greek_slice_kernel<0, false>;
  }
}

// The split launch of a runtime-m K44: slices a block, the groups of
// simulation blocks and iterations under the cap (0: AM_SCRATCH_CAP), the
// grid of a group's launch, its dynamic shared memory and the scratch in
// floats: the fold's carry [group blocks][2n], the group's sums
// [blocks][iters][S][n] (n = 14 + 4m), then past the register tiles the
// threads' state [grid][8 or 10 m][WIDE_THREADS].  Past the tiles the grid
// is the blocks the card holds at once, capped at a group's items and at
// XVA_GREEK_STATE_CAP floats of state; the sums do not depend on it.
struct XvaGreekSplit {
  int slices, n, grid;
  mct::ScratchGroups groups;
  size_t smem, state, total;
};

XvaGreekSplit xva_greek_split(int m, int n_blocks, int rows, int iters,
                              bool anti, size_t cap) {
  XvaGreekSplit X{};
  constexpr int T = WIDE_THREADS;
  const bool reg = xva_mt(m) > 0;
  X.slices = xva_slices(rows);
  X.n = XVA_GREEK_N_SCAL + 4 * m;
  X.groups = mct::scratch_groups(n_blocks, iters, 2 * static_cast<size_t>(X.n),
                                 static_cast<size_t>(X.slices) * X.n,
                                 cap == 0 ? AM_SCRATCH_CAP : cap);
  X.smem = sizeof(float) *
           (static_cast<size_t>(T / 32 + 1) * 4 * m +
            (reg ? static_cast<size_t>(anti ? 6 : 4) * m * T : 0));
  const int items = X.groups.blocks * X.slices;
  X.grid = items;
  if (!reg) {
    const size_t per_block = static_cast<size_t>(anti ? 10 : 8) * m * T;
    const GreekSliceFn fn = greek_slice_fn(m, anti);
    int dev = 0, sms = 1, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (X.smem > 48 * 1024) {
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(X.smem));
    }
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, T, X.smem);
    const size_t most = std::max<size_t>(1, XVA_GREEK_STATE_CAP / per_block);
    X.grid = static_cast<int>(std::min<size_t>(
        std::min<size_t>(items, static_cast<size_t>(std::max(1, per_sm)) *
                                    sms),
        most));
    X.state = static_cast<size_t>(X.grid) * per_block;
  }
  X.total = X.groups.total + X.state;
  return X;
}

// A runtime-m K44 launch: each group's slices, then its fold, into out (B,
// 14 + 4m).
int launch_xva_greek_slices(int m, bool anti, bool kahan, const float* scal,
                            const float* lt, const float* par,
                            const float* nodes, const Launch& L,
                            int n_blocks, size_t cap, float* scratch,
                            float* out, cudaStream_t s) {
  const XvaGreekSplit X =
      xva_greek_split(m, n_blocks, L.rows, L.iters, anti, cap);
  const GreekSliceFn fn = greek_slice_fn(m, anti);
  if (X.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(X.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto fold =
      kahan ? xva_greek_fold_kernel<true> : xva_greek_fold_kernel<false>;
  const mct::ScratchGroups& G = X.groups;
  float* carry = scratch;
  float* sums = carry + static_cast<size_t>(G.blocks) * 2 * X.n;
  float* state = scratch + G.total;
  for (int b0 = 0; b0 < n_blocks; b0 += G.blocks) {
    const int nb = std::min(G.blocks, n_blocks - b0);
    for (int i0 = 0; i0 < L.iters; i0 += G.iters) {
      const int ni = std::min(G.iters, L.iters - i0);
      const SliceItems I{b0, nb, i0, ni, X.slices};
      fn<<<std::min(X.grid, nb * X.slices), WIDE_THREADS, X.smem, s>>>(
          scal, lt, par, nodes, m, L, I, sums, state);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      const int work = nb * X.n;
      fold<<<(work + 255) / 256, 256, 0, s>>>(
          sums, carry, nb, ni, X.slices, X.n, i0 == 0, i0 + ni >= L.iters,
          out + static_cast<size_t>(b0) * X.n);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

}  // namespace

// Dispatches the asset-major kernels on n_under = 1..8.
#define MCT_DISPATCH_M(CALL)                                 \
  switch (n_under) {                                         \
    case 1: CALL(1); break;                                  \
    case 2: CALL(2); break;                                  \
    case 3: CALL(3); break;                                  \
    case 4: CALL(4); break;                                  \
    case 5: CALL(5); break;                                  \
    case 6: CALL(6); break;                                  \
    case 7: CALL(7); break;                                  \
    case MAX_AM: CALL(MAX_AM); break;                        \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// Floats of one block's EE-profile scratch for n_under underlyings (K39).
extern "C" int mctpu_cva_multi_scratch_floats(int n_under, int n_grid) {
  return warps_of(n_under) * n_grid * 2;
}

// Floats of K40's scratch for a launch (AmSplit::total) under a cap in
// floats (0: AM_SCRATCH_CAP); past the cap only where one (block,
// iteration) and a block's carry exceed it.
extern "C" int mctpu_cva_multi_am_scratch_floats(int n_under, int n_grid,
                                                 int n_blocks, int rows,
                                                 int iters, int antithetic,
                                                 int cap) {
  return static_cast<int>(am_split<CvaPay>(n_under, n_grid, n_blocks, rows,
                                           iters, antithetic != 0,
                                           static_cast<size_t>(cap))
                              .total);
}

extern "C" int mctpu_cva_multi_am(const float* scal, const float* lt,
                                  const float* par, const float* nodes,
                                  int n_under, int n_grid, int seed, int off,
                                  int n_blocks, int rows, int iters,
                                  int antithetic, int kahan, int cap,
                                  float* scratch, float* out, float* ee,
                                  void* stream) {
  const Launch L = make_launch(n_grid, seed, off, rows, iters);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AmSplit X = am_split<CvaPay>(n_under, n_grid, n_blocks, rows, iters,
                                     antithetic != 0,
                                     static_cast<size_t>(cap));
  int status = 0;
#define MCT_CALL(M)                                                    \
  status = launch_am<M, CvaPay>(antithetic != 0, kahan != 0, scal, lt, \
                                par, nodes, L, n_blocks, X, scratch, out, \
                                ee, s)
  MCT_DISPATCH_M(MCT_CALL)
#undef MCT_CALL
  return status;
}

extern "C" int mctpu_cva_multi_greeks_am(const float* scal, const float* lt,
                                         const float* par, const float* nodes,
                                         int n_under, int n_grid, int seed,
                                         int off, int n_blocks, int rows,
                                         int iters, int antithetic, int kahan,
                                         float* out, void* stream) {
  const Launch L = make_launch(n_grid, seed, off, rows, iters);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MCT_CALL(M)                                                        \
  launch_greeks_am<M>(antithetic != 0, kahan != 0, scal, lt, par, nodes, L, \
                      n_blocks, out, s)
  MCT_DISPATCH_M(MCT_CALL)
#undef MCT_CALL
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mctpu_cva_multi_packed(const float* scal, const float* lt,
                                      const float* par, const float* nodes,
                                      int n_under, int n_grid, int a_tile,
                                      int width, int seed, int off,
                                      int n_blocks, int rows, int iters,
                                      int antithetic, int kahan,
                                      float* scratch, float* out, float* ee,
                                      void* stream) {
  if (a_tile < n_under || width % a_tile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem = 0;
  const mct::Packed P = mct::packed_shape(n_under, a_tile, width, rows,
                                          antithetic != 0, smem);
  if (P.chunk_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  using Fn = void (*)(const float*, const float*, const float*, const float*,
                      mct::Packed, Launch, float*, float*, float*);
  static const Fn FNS[4] = {cva_multi_packed_kernel<false, false>,
                            cva_multi_packed_kernel<false, true>,
                            cva_multi_packed_kernel<true, false>,
                            cva_multi_packed_kernel<true, true>};
  const Launch L = make_launch(n_grid, seed, off, rows, iters);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_tile == 16) {
    return launch_cva_multi_reg<16>(antithetic != 0, kahan != 0, scal, lt,
                                    par, nodes, P, L, n_blocks, scratch, out,
                                    ee, s);
  }
  if (a_tile == CM_REG_MAX) {
    return launch_cva_multi_reg<CM_REG_MAX>(antithetic != 0, kahan != 0,
                                            scal, lt, par, nodes, P, L,
                                            n_blocks, scratch, out, ee, s);
  }
  const Fn fn = FNS[(antithetic ? 2 : 0) | (kahan ? 1 : 0)];
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<n_blocks, mct::PK_THREADS, smem, s>>>(scal, lt, par, nodes, P, L,
                                             scratch, out, ee);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mctpu_cva_multi_greeks_packed(
    const float* scal, const float* lt, const float* par, const float* nodes,
    int n_under, int n_grid, int a_tile, int width, int seed, int off,
    int n_blocks, int rows, int iters, int antithetic, int kahan, float* out,
    float* vecs, void* stream) {
  if (a_tile < n_under || width % a_tile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem = 0;
  const mct::Packed P =
      mct::greek_shape(n_under, a_tile, width, rows,
                       (antithetic ? 2 : 1) * K41_LANE_FLOATS, smem);
  if (P.chunk_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Launch L = make_launch(n_grid, seed, off, rows, iters);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_tile == 16) {
    return launch_cva_multi_greeks_reg<16>(antithetic != 0, kahan != 0, scal,
                                           lt, par, nodes, P, L, n_blocks,
                                           out, vecs, s);
  }
  if (a_tile == CM_REG_MAX) {
    return launch_cva_multi_greeks_reg<CM_REG_MAX>(
        antithetic != 0, kahan != 0, scal, lt, par, nodes, P, L, n_blocks,
        out, vecs, s);
  }
  using Fn = void (*)(const float*, const float*, const float*, const float*,
                      mct::Packed, Launch, float*, float*);
  static const Fn FNS[4] = {cva_multi_greeks_packed_kernel<false, false>,
                            cva_multi_greeks_packed_kernel<false, true>,
                            cva_multi_greeks_packed_kernel<true, false>,
                            cva_multi_greeks_packed_kernel<true, true>};
  const Fn fn = FNS[(antithetic ? 2 : 0) | (kahan ? 1 : 0)];
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<n_blocks, mct::PK_THREADS, smem, s>>>(scal, lt, par, nodes, P, L, out,
                                             vecs);
  return static_cast<int>(cudaGetLastError());
}

// Floats of an xVA launch's scratch: K43's and K44's split plans
// (AmSplit::total) under a cap in floats (0: AM_SCRATCH_CAP), past the cap
// only where one (block, iteration) and a block's carry exceed it; for the
// runtime-m kernels (wide) their slices' rows, profile slots and state,
// K44's groups under the cap and its state.
extern "C" int mctpu_xva_scratch_floats(int n_under, int n_grid, int greeks,
                                        int wide, int n_blocks, int rows,
                                        int iters, int antithetic, int cap) {
  if (greeks) {
    if (wide) {
      return static_cast<int>(xva_greek_split(n_under, n_blocks, rows, iters,
                                              antithetic != 0,
                                              static_cast<size_t>(cap))
                                  .total);
    }
    return static_cast<int>(am_split<XvaGreekPay>(n_under, n_grid, n_blocks,
                                                  rows, iters,
                                                  antithetic != 0,
                                                  static_cast<size_t>(cap))
                                .total);
  }
  if (wide) {
    return static_cast<int>(
        xva_split(n_under, n_grid, n_blocks, rows, iters).total);
  }
  return static_cast<int>(am_split<XvaPay>(n_under, n_grid, n_blocks, rows,
                                           iters, antithetic != 0,
                                           static_cast<size_t>(cap))
                              .total);
}

// K43 (n_under = 1..8) or its runtime-m kernel (wide, any n_under).
extern "C" int mctpu_xva(const float* scal, const float* lt, const float* par,
                         const float* nodes, int n_under, int n_grid, int wide,
                         int seed, int off, int n_blocks, int rows, int iters,
                         int antithetic, int kahan, int cap, float* scratch,
                         float* out, float* prof, void* stream) {
  const Launch L = make_launch(n_grid, seed, off, rows, iters);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    const XvaSplit X = xva_split(n_under, n_grid, n_blocks, rows, iters);
    const SliceFn fn = slice_fn(n_under, antithetic != 0);
    const size_t smem = X.prof_smem ? xva_slot_bytes(n_grid) : 0;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    fn<<<X.grid, WIDE_THREADS, smem, s>>>(scal, lt, par, nodes, n_under, L,
                                          n_blocks, X.slices,
                                          X.prof_smem ? 1 : 0, scratch);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int work = n_blocks * (8 + 2 * n_grid);
    (kahan ? xva_fold_kernel<true> : xva_fold_kernel<false>)<<<
        (work + 255) / 256, 256, 0, s>>>(scratch, n_blocks, iters, X.slices,
                                         2 * n_grid, out, prof);
    return static_cast<int>(cudaGetLastError());
  }
  const AmSplit X = am_split<XvaPay>(n_under, n_grid, n_blocks, rows, iters,
                                     antithetic != 0,
                                     static_cast<size_t>(cap));
  int status = 0;
#define MCT_CALL(M)                                                    \
  status = launch_am<M, XvaPay>(antithetic != 0, kahan != 0, scal, lt, \
                                par, nodes, L, n_blocks, X, scratch, out, \
                                prof, s)
  MCT_DISPATCH_M(MCT_CALL)
#undef MCT_CALL
  return status;
}

// K44 (n_under = 1..8) or its runtime-m kernel (wide, any n_under): out is
// (n_blocks, 14 + 4 n_under); scratch of mctpu_xva_scratch_floats(.., cap)
// floats.
extern "C" int mctpu_xva_greeks(const float* scal, const float* lt,
                                const float* par, const float* nodes,
                                int n_under, int n_grid, int wide, int seed,
                                int off, int n_blocks, int rows, int iters,
                                int antithetic, int kahan, int cap,
                                float* scratch, float* out, void* stream) {
  const Launch L = make_launch(n_grid, seed, off, rows, iters);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    return launch_xva_greek_slices(n_under, antithetic != 0, kahan != 0,
                                   scal, lt, par, nodes, L, n_blocks,
                                   static_cast<size_t>(cap), scratch, out, s);
  }
  const AmSplit X = am_split<XvaGreekPay>(n_under, n_grid, n_blocks, rows,
                                          iters, antithetic != 0,
                                          static_cast<size_t>(cap));
  int status = 0;
#define MCT_CALL(M)                                                   \
  status = launch_am<M, XvaGreekPay>(antithetic != 0, kahan != 0, scal, \
                                     lt, par, nodes, L, n_blocks, X,    \
                                     scratch, out, nullptr, s)
  MCT_DISPATCH_M(MCT_CALL)
#undef MCT_CALL
  return status;
}
