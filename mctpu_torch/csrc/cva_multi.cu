// K39, K40 and K42: the netting-set CVA over correlated underlyings and its
// asset-major Greeks.
//
// K40 replaces mctpu/kernels/cva_multi.py::_am_cva_multi_kernel (<= 8
// underlyings), K39 ::_cva_multi_kernel (> 8, lane-packed) and K42
// ::_am_cva_multi_greeks_kernel (CVA, credit delta and per-underlying delta
// and vega, <= 8).
//
// Stream: per simulation block b and iteration i the key is reseeded with
// (seed, (off + b) * iters + i) in int32 wrap; the antithetic mirror
// replays it with the signs flipped.  Asset-major (K40, K42): tile element
// e of a (rows, 128) tile is a path; pair jj draws Philox blocks (e, jj*M +
// i) for underlying i (mct::walk_pairwise_multi), cosine branches for node
// 2jj, sine branches for node 2jj+1.  Packed (K39): K31's map (packed.cuh),
// path (row, p) owning lanes p*a_tile .. p*a_tile + m - 1.
//
// Each node j: x_i += drift_i + vol_i bt_i with bt = L z (asset-major from
// the first product, packed from 0), s_i = expf(x_i); each leg's value w_i
// BS_hastings(s_i, k_i, v_i, tau_j), its intrinsic value at the last node
// (tau = 0); the legs net and ee_j = max(net, 0) adds dp_j ee_j to the
// path's default leg (times lgd at the end).  The two regimes price the leg
// in their TPU kernels' two forms and keep each one's rounding: asset-major
// (mctpu's _am_quants) d1 = (x - log k + (r + v^2/2) tau) * (1 / (v
// sqrt(tau))); packed (bs_call_hastings) d1 = (log(s / k) + (r + v^2/2)
// tau) / (v sqrt(tau)).  N(d1) and the density phi(d1) share one expf
// (mct::norm_cdf_hastings_e): the argument is the same operation on both
// sides.  K42 adds the vol tangents dxv_i += sqrt(dt) bt_i - v_i dt, the
// exercise indicator I = 1{net > 0}, delta_i += dp_j I w_i N(d1) s_i and
// vega_i += dp_j (I w_i N(d1) s_i dxv_i + I w_i s_i phi(d1) sqrt(tau))
// (mctpu's _am_greek_step), and the credit delta ddp_j ee_j.
//
// Built with -fmad=false (mctpu_torch/_build.py): the exercise indicator
// and the positive part of the net are discontinuities, so each path must
// round as the plain PyTorch version's separate multiplies and adds do.
// K40 and K42 share am_node, the thread count and BlockAccN's reduction, so
// K42's CVA sums equal K40's bit for bit.
//
// The expected-exposure profile: mctpu Kahan-adds (1/2 under antithetic)
// the tile's sum of ee_j into an SMEM scalar per node.  Here (K4's design,
// csrc/cva.cu) each node's exposures are reduced by a fixed warp-shuffle
// tree, lane 0 adds the warp's sum into its own compensated slot (global
// scratch, [warps][n_grid][2]), and the warps are combined in warp order:
// no atomics, two launches give the same bits.
//
// Bound on the H100: arithmetic.  Per path-node and underlying: half a
// Philox block and a Box-Muller pair, three expf (the spot and the two
// CDFs), the IEEE divides of 1 / sq (or of s / k and by sq, and a logf)
// and of the two CDFs, the m(m+1)/2 multiply-adds of L z.  Simple design:
// one CUDA block per simulation block (layout_for gives 32 at 2^20 paths,
// so most of the 132 SMs idle, as with K4).  Asset-major: one thread per
// path element striding over the tile, the walk state in registers (K42 at
// m = 8: 8 log-spots, 8 tangents, 16 accumulators and 36 sums), L and the
// per-leg rows in shared memory, the node tables read through the
// read-only cache (every thread of a warp on the same node).  Packed: K31's
// passes (packed.cuh), the log-spots and a pair of nodes' normals in shared
// memory, one thread per packed path.
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

// Adds half_w times the warp's sum of ee (every lane of the warp calls it)
// into node j's compensated slot of the warp, in mctpu's Kahan form.
__device__ __forceinline__ void profile_add(float* wprof, int j, float half_w,
                                            float ee, int lane) {
  float r = ee;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    r = __fadd_rn(r, __shfl_down_sync(0xffffffffu, r, o));
  }
  if (lane == 0) {
    float* slot = wprof + 2 * j;
    const float row = __fmul_rn(half_w, r);
    const float y = __fsub_rn(row, slot[1]);
    const float t = __fadd_rn(slot[0], y);
    slot[1] = __fsub_rn(__fsub_rn(t, slot[0]), y);
    slot[0] = t;
  }
}

// The block's profile row: each node's warp slots (sum + compensation)
// added in warp order.  Call after a __syncthreads.
template <int THREADS>
__device__ __forceinline__ void profile_write(const float* prof, int warps,
                                              int g, float* ee_out) {
  for (int j = threadIdx.x; j < g; j += THREADS) {
    float total = 0.0f;
    for (int w = 0; w < warps; ++w) {
      const float* slot = prof + (w * g + j) * 2;
      total = __fadd_rn(total, __fadd_rn(slot[0], slot[1]));
    }
    ee_out[static_cast<size_t>(blockIdx.x) * g + j] = total;
  }
}

// --------------------------------------------------------- K40, K42 (m <= 8)

// One asset-major node (mctpu's _am_quants and _am_net): advances x[M] with
// the signed normals sgn * z, returns ee = max(net, 0) and, for the Greeks,
// the per-leg bt, spots, delta factor N(d1) (the in-the-money indicator at
// the last node) and density phi(d1) (0 there).  par rows (M each): log s0,
// drift dt, v sqrt(dt), v dt, w, k, log k, v^2 / 2, v.
template <int M, bool GREEKS>
__device__ __forceinline__ float am_node(const float (&z)[M], float sgn,
                                         float (&x)[M], const float* lt,
                                         const float* par, float r,
                                         const Node& nd, float (&bt)[M],
                                         float (&s)[M], float (&nd1)[M],
                                         float (&phi)[M], float& net) {
  const bool last = nd.tau <= 0.0f;
  const float tau_safe = fmaxf(nd.tau, MCT_F32(1e-12));
  const float sq_floor = fmaxf(nd.sqtau, MCT_F32(1e-6));
  float value = 0.0f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float b = lt[i * M] * (sgn * z[0]);
#pragma unroll
    for (int j = 1; j <= i; ++j) b = b + lt[i * M + j] * (sgn * z[j]);
    const float xi = x[i] + par[M + i] + par[2 * M + i] * b;
    const float si = expf(xi);
    const float k = par[5 * M + i];
    float val;
    if (last) {
      val = par[4 * M + i] * fmaxf(si - k, 0.0f);
      if (GREEKS) {
        nd1[i] = si > k ? 1.0f : 0.0f;
        phi[i] = 0.0f;
      }
    } else {
      const float sq = par[8 * M + i] * sq_floor;
      const float d1 = (xi - par[6 * M + i] + (r + par[7 * M + i]) * tau_safe) *
                       (1.0f / sq);
      const float e = expf(MCT_F32(-0.5) * d1 * d1);
      const float n1 = mct::norm_cdf_hastings_e(d1, e);
      const float bs = si * n1 - k * nd.disc * mct::norm_cdf_hastings(d1 - sq);
      val = par[4 * M + i] * bs;
      if (GREEKS) {
        nd1[i] = n1;
        phi[i] = INV_SQRT_2PI * e;
      }
    }
    value = (i == 0) ? val : value + val;
    x[i] = xi;
    bt[i] = b;
    s[i] = si;
  }
  net = value;
  return fmaxf(value, 0.0f);
}

// One K40 walk of tile element e and sign sgn: its default leg lgd sum_j
// dp_j ee_j; each node's exposures go to the warp's profile slots.
template <int M>
__device__ __forceinline__ float am_cva_walk(const float* lt, const float* par,
                                             const float* nodes, float r,
                                             float lgd, int g, mct::Key key,
                                             uint32_t e, float sgn,
                                             float half_w, float* wprof,
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
    profile_add(wprof, j, half_w, ee, lane);
  });
  return lgd * acc;
}

template <int M, bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(am_threads<M>())
    cva_multi_am_kernel(const float* __restrict__ scal,
                        const float* __restrict__ lt_g,
                        const float* __restrict__ par_g,
                        const float* __restrict__ nodes, Launch L,
                        float* __restrict__ scratch, float* __restrict__ out,
                        float* __restrict__ ee_out) {
  constexpr int THREADS = am_threads<M>();
  constexpr int WARPS = THREADS / 32;
  __shared__ float lt[M * M], par[9 * M], sh[WARPS * 2];
  stage<THREADS>(lt, lt_g, M * M);
  stage<THREADS>(par, par_g, 9 * M);
  float* prof = scratch + static_cast<size_t>(blockIdx.x) * WARPS * L.g * 2;
  profile_zero<THREADS>(prof, WARPS * L.g * 2);
  __syncthreads();
  const float r = scal[0], lgd = scal[1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* wprof = prof + warp * L.g * 2;
  const float half_w = ANTI ? 0.5f : 1.0f;
  const int n_elems = L.rows * mct::LANES;
  mct::BlockAccN<THREADS, 2, KAHAN> acc;
  float v[2] = {0.0f, 0.0f};
  for (int i = 0; i < L.iters; ++i) {
    const mct::Key key = iter_key(L, i);
    for (int base = 0; base < n_elems; base += THREADS) {
      // n_elems is a multiple of 128: a warp is wholly inside or outside,
      // so every lane of an active warp reaches the profile's shuffles.
      if (base + warp * 32 >= n_elems) continue;
      const uint32_t e = static_cast<uint32_t>(base + threadIdx.x);
      float cva = am_cva_walk<M>(lt, par, nodes, r, lgd, L.g, key, e, 1.0f,
                                 half_w, wprof, lane);
      if (ANTI) {
        cva = 0.5f * (cva + am_cva_walk<M>(lt, par, nodes, r, lgd, L.g, key,
                                           e, -1.0f, half_w, wprof, lane));
      }
      v[0] += cva;
      v[1] += cva * cva;
    }
    acc.add(v, nullptr, sh);
  }
  __syncthreads();
  profile_write<THREADS>(prof, WARPS, L.g, ee_out);
  acc.write(out);
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

template <int M>
void launch_am(bool anti, bool kahan, const float* scal, const float* lt,
               const float* par, const float* nodes, const Launch& L,
               int n_blocks, float* scratch, float* out, float* ee,
               cudaStream_t s) {
  using Fn = void (*)(const float*, const float*, const float*, const float*,
                      Launch, float*, float*, float*);
  static const Fn FNS[4] = {
      cva_multi_am_kernel<M, false, false>, cva_multi_am_kernel<M, false, true>,
      cva_multi_am_kernel<M, true, false>, cva_multi_am_kernel<M, true, true>};
  const Fn fn = FNS[(anti ? 2 : 0) | (kahan ? 1 : 0)];
  fn<<<n_blocks, am_threads<M>(), 0, s>>>(scal, lt, par, nodes, L, scratch,
                                          out, ee);
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
    default: return mct::PK_THREADS / 32;
  }
}

Launch make_launch(int g, int seed, int off, int rows, int iters) {
  return Launch{g, static_cast<uint32_t>(seed), static_cast<uint32_t>(off),
                rows, iters};
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

// Floats of one block's EE-profile scratch for n_under underlyings.
extern "C" int mctpu_cva_multi_scratch_floats(int n_under, int n_grid) {
  return warps_of(n_under) * n_grid * 2;
}

extern "C" int mctpu_cva_multi_am(const float* scal, const float* lt,
                                  const float* par, const float* nodes,
                                  int n_under, int n_grid, int seed, int off,
                                  int n_blocks, int rows, int iters,
                                  int antithetic, int kahan, float* scratch,
                                  float* out, float* ee, void* stream) {
  const Launch L = make_launch(n_grid, seed, off, rows, iters);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MCT_CALL(M)                                                       \
  launch_am<M>(antithetic != 0, kahan != 0, scal, lt, par, nodes, L,      \
               n_blocks, scratch, out, ee, s)
  MCT_DISPATCH_M(MCT_CALL)
#undef MCT_CALL
  return static_cast<int>(cudaGetLastError());
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
  const Fn fn = FNS[(antithetic ? 2 : 0) | (kahan ? 1 : 0)];
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<n_blocks, mct::PK_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      scal, lt, par, nodes, P, make_launch(n_grid, seed, off, rows, iters),
      scratch, out, ee);
  return static_cast<int>(cudaGetLastError());
}
