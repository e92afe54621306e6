// K52, K53, K54 and K55: randomized QMC on digitally shifted Sobol nets.
//
// K52 replaces mctpu/qmc_engine.py::_vanilla_rqmc_kernel, K53
// _vanilla_greek_rqmc_kernel, K54 _basket_rqmc_kernel and K55
// _asian_rqmc_kernel.  Replicate b streams its net in chunks of ppc points,
// point j of chunk i having the u32 index n = i * ppc + j; per point and
// dim d: the 30-bit Sobol integer x = XOR_{bit b of gray(n)} v[d][b] XOR
// (shift >> 2), the shift word 0 of Philox-4x32-10 under the key words
// (k0, k1) at counter (off + b, d, 0x51D5, 0) (mctpu's _rep_shifts), the
// uniform bitcast((x >> 7) | 0x3F800000) - 1, the Giles normal quantile
// (mctpu/math.py, norm_ppf_f32), then the payoff:
// K52 the call or put on dim 0; K53 the payoff and K6's seven Greek
// integrands (greeks.cuh); K54 K3's packed basket of the a dims
// (basket.cuh); K55 the Brownian bridge of the m dims in draw order
// (W[out] = ca W[left] + cb W[right] + sds z, no ca term for the t = 0
// anchor), log s_j = (log s0 + drift_j) + v W_j, the adjacent-pair tree
// sum of s_j (arithmetic) or log s_j (geometric) times 1/m, max(avg - k, 0).
//
// Design.  The TPU runs one grid program per replicate (16 by default),
// which on 132 SMs would be K4's under-fill.  Here one CUDA block takes one
// (chunk, replicate) (K55: a split and a fold of the same order, below)
// and writes that chunk's float32 tile sums (sum p,
// sum p^2; K53's 16) to a scratch row; a second, tiny kernel then runs
// mctpu's Neumaier adds over the chunks in order, one thread per
// (replicate, sum), and writes the unfolded (s, c) pairs.  The tile sums
// differ from the plain version's only in the float32 order of one chunk's
// reduction (a fixed shuffle tree, so two launches give the same bits);
// the carry is the plain version's, add for add.
//
// The Sobol integers: the construction is linear over XOR in the index, so
// for a 32-aligned base A, x(A + l) = x(A) ^ x(l).  A warp takes 32
// consecutive points (lane l the point A + l; lanes outside the chunk run
// but add nothing); x(l) comes from a (dim, 32) table, and x(A) is formed
// once per group and dim by the 30-step form and XORed with the dim's shift
// (drawn where it is needed, so the host sends none), the warp's lanes
// sharing the work over (group, dim) pairs and exchanging it by
// shuffles.  A point-dim then costs a shuffle, a table load and an XOR
// beside the quantile's 28 float32 operations and logf (the tail branch's
// sqrtf and 17 more only in a warp that holds a tail point, but for K54
// past 336 assets).  K54 forms a round of points' normals into shared
// memory, four quantiles a lane at a time, and their baskets by K3's
// register-tiled product at 17-336 assets; else a lane holds its point's z
// in a local array of 64 or 2048 = MAX_DIM floats (see its section below).
// K55 splits each chunk's batches
// over many CUDA blocks, each point's payoff to scratch, and folds them in
// the one-block-a-chunk order (see its section below); a point's W is a
// warp's column in shared memory, or past 64 dates a local array.
//
// Bound on the H100: float32 operations and the SFU (logf and expf per
// point-dim); K54 at a = 100 by the 5050-term correlation product per
// point, as K3 (register tiles of 4 points x 4 assets off shared memory, 16
// fmaf per two shared loads).  This source builds with -fmad=false
// (mctpu_torch/_build.py): the quantile's Horner steps, the payoff kink and
// K53's in-the-money indicator round as the plain version's separate
// operations do.
#include <cuda_runtime.h>

#include <cstdint>

#include "basket.cuh"
#include "common.cuh"
#include "greeks.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BITS = 30;
constexpr int CARRY_THREADS = 128;
constexpr uint32_t SHIFT_TAG = 0x51D5u;

// The Giles polynomials in w = -log(1 - x^2), times x (mctpu/math.py,
// _giles_from_w): the central one in w - 2.5 where w < 5, else the tail one
// in sqrt(w) - 3.  LAZY forms the tail only when a lane of the warp needs
// it (about 10% of the warps; every lane of the warp calls this together);
// either way the result is the select of the two, bit for bit.
__device__ __forceinline__ float giles_central(float w) {
  const float wc = w - 2.5f;
  float p = MCT_F32(2.81022636e-08);
  p = MCT_F32(3.43273939e-07) + p * wc;
  p = MCT_F32(-3.5233877e-06) + p * wc;
  p = MCT_F32(-4.39150654e-06) + p * wc;
  p = MCT_F32(0.00021858087) + p * wc;
  p = MCT_F32(-0.00125372503) + p * wc;
  p = MCT_F32(-0.00417768164) + p * wc;
  p = MCT_F32(0.246640727) + p * wc;
  p = MCT_F32(1.50140941) + p * wc;
  return p;
}

__device__ __forceinline__ float giles_tail(float w) {
  const float wt = sqrtf(w) - 3.0f;
  float q = MCT_F32(-0.000200214257);
  q = MCT_F32(0.000100950558) + q * wt;
  q = MCT_F32(0.00134934322) + q * wt;
  q = MCT_F32(-0.00367342844) + q * wt;
  q = MCT_F32(0.00573950773) + q * wt;
  q = MCT_F32(-0.0076224613) + q * wt;
  q = MCT_F32(0.00943887047) + q * wt;
  q = MCT_F32(1.00167406) + q * wt;
  q = MCT_F32(2.83297682) + q * wt;
  return q;
}

template <bool LAZY>
__device__ __forceinline__ float giles_from_w(float w, float x) {
  float p = giles_central(w);
  const bool tail = !(w < 5.0f);
  if (!LAZY || __any_sync(0xffffffffu, tail)) {
    const float q = giles_tail(w);
    if (tail) p = q;
  }
  return p * x;
}

// The inverse normal CDF of u (mctpu/math.py, norm_ppf_f32): u clipped to
// [1e-7, 1 - 1e-7], w = -log(4 u (1 - u)).  Called by the whole warp.
template <bool LAZY>
__device__ __forceinline__ float norm_ppf(float u) {
  const float eps = MCT_F32(1e-7);
  u = fminf(fmaxf(u, eps), 1.0f - eps);
  const float x = 2.0f * u - 1.0f;
  const float w = -logf(4.0f * u * (1.0f - u));
  return giles_from_w<LAZY>(w, x) * MCT_F32(1.4142135623730951);
}

// N lazy quantiles at once, each norm_ppf<true>'s bit for bit: one vote for
// all their tails, so that their N dependent chains interleave.  Called by
// the whole warp.
template <int N>
__device__ __forceinline__ void norm_ppf_n(const float (&u)[N],
                                           float (&z)[N]) {
  const float eps = MCT_F32(1e-7);
  float x[N], w[N], p[N];
  bool any_tail = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float ui = fminf(fmaxf(u[i], eps), 1.0f - eps);
    x[i] = 2.0f * ui - 1.0f;
    w[i] = -logf(4.0f * ui * (1.0f - ui));
    p[i] = giles_central(w[i]);
    any_tail = any_tail || !(w[i] < 5.0f);
  }
  if (__any_sync(0xffffffffu, any_tail)) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float q = giles_tail(w[i]);
      if (!(w[i] < 5.0f)) p[i] = q;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    z[i] = (p[i] * x[i]) * MCT_F32(1.4142135623730951);
  }
}

__device__ __forceinline__ float u_from_bits30(uint32_t x) {
  return __uint_as_float((x >> 7) | 0x3F800000u) - 1.0f;
}

// The unshifted 30-bit Sobol integer of point n in the dim whose direction
// numbers are v[0 .. 30).
__device__ __forceinline__ uint32_t sobol30(uint32_t n,
                                            const uint32_t* __restrict__ v) {
  const uint32_t g = n ^ (n >> 1);
  uint32_t acc = 0u;
#pragma unroll
  for (int b = 0; b < BITS; ++b) acc ^= __ldg(v + b) & (0u - ((g >> b) & 1u));
  return acc;
}

// One replicate's net: v (m, 30) direction numbers, low (m, 32) the
// integers of the points 0 .. 31, the shifts' key words and the
// replicate's global id.
struct Net {
  const uint32_t* v;
  const uint32_t* low;
  uint32_t k0, k1, rep;
  int m;
};

// The 32-point groups of the chunk whose first point has index base: the
// first group's base a0 (32-aligned), their count, and the batches of gpb =
// 32 / min(m, 32) groups that a warp takes at a time.
struct NetChunk {
  uint32_t a0;
  int ngroups, nbatch, gpb, dc;
};

__device__ __forceinline__ NetChunk net_chunk(int m, uint32_t base,
                                              int ppc) {
  NetChunk C;
  C.dc = m < 32 ? m : 32;
  C.gpb = 32 / C.dc;
  C.a0 = base & ~31u;
  C.ngroups = static_cast<int>(
      ((base & 31u) + static_cast<uint32_t>(ppc) + 31u) >> 5);
  C.nbatch = (C.ngroups + C.gpb - 1) / C.gpb;
  return C;
}

// Drives pt over batch kb of the chunk whose first point has index base:
// per point pt.begin(), pt.dim(d, z) for d = 0 .. m-1 in order, then
// pt.end(inside the chunk, the point's index less a0); z =
// norm_ppf<Pt::kLazyTail>.  In the batch lane (g, d) forms x(A_g) of dim
// d, shifted (the dims in slices of 32 when m > 32, one group a batch).
// Every lane of the warp runs every step, so the shuffles see the whole
// warp.
template <class Pt>
__device__ __forceinline__ void net_batch(const Net& net, const NetChunk& C,
                                          uint32_t base, int ppc, int kb,
                                          Pt& pt) {
  const int lane = threadIdx.x & 31;
  const int m = net.m, dc = C.dc, gpb = C.gpb;
  const int my_g = lane / dc;
  const int my_d = lane - my_g * dc;
  uint32_t h = 0u;
  for (int g = 0; g < gpb; ++g) {
    const int k = kb * gpb + g;
    if (k >= C.ngroups) break;
    const uint32_t pos = 32u * static_cast<uint32_t>(k) +
                         static_cast<uint32_t>(lane);
    const uint32_t n = C.a0 + pos;
    pt.begin();
    for (int d0 = 0; d0 < m; d0 += 32) {
      if (g == 0) {  // m <= 32: one slice, formed for the whole batch
        const int kk = kb * gpb + my_g;
        const int dd = d0 + my_d;
        h = 0u;
        if (my_g < gpb && kk < C.ngroups && dd < m) {
          const uint32_t shift =
              mct::philox4x32_10(net.k0, net.k1, net.rep,
                                 static_cast<uint32_t>(dd), SHIFT_TAG, 0u)
                  .x;
          h = sobol30(C.a0 + 32u * static_cast<uint32_t>(kk),
                      net.v + dd * BITS) ^
              (shift >> 2);
        }
      }
      const int dn = min(32, m - d0);
      for (int j = 0; j < dn; ++j) {
        const int d = d0 + j;
        const uint32_t x = __shfl_sync(0xffffffffu, h, g * dc + j) ^
                           __ldg(net.low + d * 32 + lane);
        pt.dim(d, norm_ppf<Pt::kLazyTail>(u_from_bits30(x)));
      }
    }
    pt.end(n - base < static_cast<uint32_t>(ppc), pos);
  }
}

// Drives pt over the ppc points of the chunk whose first point has index
// base, the block's warps taking batches kb = warp, warp + WARPS, ...
template <class Pt>
__device__ __forceinline__ void run_net(const Net& net, uint32_t base,
                                        int ppc, Pt& pt) {
  const NetChunk C = net_chunk(net.m, base, ppc);
  for (int kb = threadIdx.x >> 5; kb < C.nbatch; kb += WARPS) {
    net_batch(net, C, base, ppc, kb, pt);
  }
}

// Quantiles net_group forms at once (norm_ppf_n): two ran K54 at 100
// assets 15% faster than one (11-15% past 100, 4-6% at 32-65), four 9-11%
// faster than two past 128 and as fast below (tools/time_redesign.py
// against copies, PERF.md).
constexpr int GROUP_QN = 4;

// Calls f(d, z) for dims dlo .. dhi - 1 in turn of lane l's point A + l of
// the 32-aligned group at A, z = norm_ppf<true>'s value: in each slice of 32
// dims lane j forms x(A) of dim d0 + j, shifted, as net_batch does for one
// group.  Called by the whole warp.
template <class F>
__device__ __forceinline__ void net_group(const Net& net, uint32_t A,
                                          int dlo, int dhi, F&& f) {
  const int lane = threadIdx.x & 31;
  for (int d0 = dlo; d0 < dhi; d0 += 32) {
    const int dn = min(32, dhi - d0);
    uint32_t h = 0u;
    if (lane < dn) {
      const uint32_t dd = static_cast<uint32_t>(d0 + lane);
      const uint32_t shift =
          mct::philox4x32_10(net.k0, net.k1, net.rep, dd, SHIFT_TAG, 0u).x;
      h = sobol30(A, net.v + dd * BITS) ^ (shift >> 2);
    }
    int j = 0;
    for (; j + GROUP_QN <= dn; j += GROUP_QN) {
      float u[GROUP_QN], z[GROUP_QN];
#pragma unroll
      for (int i = 0; i < GROUP_QN; ++i) {
        u[i] = u_from_bits30(__shfl_sync(0xffffffffu, h, j + i) ^
                             __ldg(net.low + (d0 + j + i) * 32 + lane));
      }
      norm_ppf_n(u, z);
#pragma unroll
      for (int i = 0; i < GROUP_QN; ++i) f(d0 + j + i, z[i]);
    }
    for (; j < dn; ++j) {
      const uint32_t x = __shfl_sync(0xffffffffu, h, j) ^
                         __ldg(net.low + (d0 + j) * 32 + lane);
      f(d0 + j, norm_ppf<true>(u_from_bits30(x)));
    }
  }
}

// ------------------------------------------------------------ K52 vanilla

template <bool PUT>
struct VanPt {
  static constexpr bool kLazyTail = true;
  float s0, k, mu, sig;
  float p = 0.0f, v[2] = {0.0f, 0.0f};

  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void dim(int, float z) {
    const float st = s0 * expf(mu + sig * z);
    p = PUT ? fmaxf(k - st, 0.0f) : fmaxf(st - k, 0.0f);
  }
  __device__ __forceinline__ void end(bool inside, uint32_t) {
    if (inside) {
      v[0] += p;
      v[1] += p * p;
    }
  }
};

// ------------------------------------------------------------- K53 Greeks

template <bool PUT>
struct GreekPt {
  static constexpr bool kLazyTail = true;
  mct::VanPar P;
  float q[8];
  float v[16];

  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void dim(int, float z) {
    mct::van_quants<PUT>(P, z, q);
  }
  __device__ __forceinline__ void end(bool inside, uint32_t) {
    if (inside) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[2 * j] += q[j];
        v[2 * j + 1] += q[j] * q[j];
      }
    }
  }
};

// -------------------------------------------------------------- K54 basket

// K54 runs one of two designs by a.  In TILED_MIN_A <= a <= TILED_MAX_A
// (rqmc_basket_tiled_kernel) a chunk's points go in rounds of TILED_UNITS
// / 32 groups: the block's warps write the round's normals into a shared
// [a][TILED_UNITS] column (group g of the round at units 32 g .., each warp
// a group's share of the dims, net_group), mct::tiled_baskets (basket.cuh,
// K3's register-tiled product) forms their basket values, and each point's
// value returns through shared memory to the lane that run_net gives it
// (past 16 assets a batch is one group: lane l of warp k % WARPS for point
// 32 k + l of group k), which adds max(basket - k, 0) and its square when
// the point lies in the chunk.  The rounds take the groups in ascending
// order, so each thread adds its points in run_net's order, and the basket
// values are packed_baskets' bit for bit: the tiles, and so the quads, are
// the local-array design's.  Elsewhere (BasketPt, rqmc_basket_kernel) a
// lane holds its point's z in a local array and forms packed_baskets
// itself.  The range is measured (tools/time_redesign.py, PERF.md): at 3-13
// assets, where a round's barriers serve a few product terms a point, the
// local array is 1.2-3x faster, at 16 they tie, from 17 the tiled design
// wins (7% at 17, 2.3x at 64, 2.4x at 100, 6-8x at 256-336).  Past 336 its
// shared memory does not fit and the 2048-float local array stays.  Past 64
// assets the correlation product outweighs the quantiles, and the lazy
// tail's vote and branch cost its loop registers (ptxas: 63 -> 48 and a
// spill; 100 assets 13% slower, tools/time_rqmc.py), so the 2048 instance
// forms both polynomials.
constexpr int TILED_MIN_A = 17;   // one 32-point group a batch
constexpr int TILED_MAX_A = 336;  // the tiled design's shared memory fits

template <int MAXA>
struct BasketPt {
  static constexpr bool kLazyTail = MAXA <= 64;
  const float* lt;
  const float* rows;
  float k;
  int a;
  float z[MAXA];
  float v[2] = {0.0f, 0.0f};

  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void dim(int d, float zz) { z[d] = zz; }
  __device__ __forceinline__ void end(bool inside, uint32_t) {
    float basket, unused;
    mct::packed_baskets<false>(z, lt, rows, a, basket, unused);
    const float p = fmaxf(basket - k, 0.0f);
    if (inside) {
      v[0] += p;
      v[1] += p * p;
    }
  }
};

// --------------------------------------------------------------- K55 Asian

// K55 runs as a split net and a fold.  The split kernel takes one CUDA
// block of 8 warps per (replicate, chunk, slice of 8 batches), a warp a
// batch, and writes each point's payoff to scratch at the point's index
// less a0, so the grid is no longer one block a chunk; the fold, one block
// of THREADS per (replicate, chunk), adds the payoffs in the order that
// run_net's warps took them in that design (thread (w, l) its batches w, w
// + WARPS, .. and in each its groups in turn), then reduces them with
// write_tile's tree into the same tile row.  So the tiles, and the quads
// after chunk_carry_kernel, are that design's bit for bit.
//
// The bridge table is staged per block in shared memory: step q as the
// int4 (left, right, out, 0) and the float4 (ca, cb, sds, drift_q).  A
// point's W is a warp's [m][32] column in shared memory where that fits
// (asian_w_shared<MAXM>), lane l's W_i at [i][l]: every lane of the warp
// takes the same bridge step at once, so each access is one row, free of
// bank conflicts.  Else it is a local array of MAXM floats.

// Where W lives, by MAXM instance: m <= 64 in shared memory (52.8 KB a
// block of 8 warps at 50 dates, four blocks an SM); past 64 in a local
// array.  A column of 252 dates takes 32 KB a warp, so at most 6 warps an
// SM fit; with the local array, reaching L2, the refilled grid keeps 32
// warps an SM and ran 1.45x faster at 252 dates (tools/time_redesign.py
// against a copy with the shared column, PERF.md).
template <int MAXM>
__host__ __device__ constexpr bool asian_w_shared() {
  return MAXM <= 64;
}

template <int MAXM, bool GEO, bool SHW>
struct AsianPt {
  static constexpr bool kLazyTail = true;
  const int4* idx;   // the staged bridge steps
  const float4* cf;
  float log_s0, k, vol, inv_m;
  int m;
  float* col;        // SHW: this lane's column, W_i at col[32 i]
  float* dst;        // the item's payoffs, by point index less a0
  float wl[SHW ? 1 : MAXM];

  __device__ __forceinline__ float& w(int i) {
    if constexpr (SHW) {
      return col[32 * i];
    } else {
      return wl[i];
    }
  }
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void dim(int q, float z) {
    const int4 ix = idx[q];
    const float4 c = cf[q];
    const float sz = c.z * z;
    if (q == 0) {
      w(ix.z) = sz;
      return;
    }
    float wb = c.y * w(ix.y);
    if (ix.x >= 0) wb = c.x * w(ix.x) + wb;
    w(ix.z) = wb + sz;
  }
  // Date j's log-spot (geometric) or spot.
  __device__ __forceinline__ float date(int j) {
    const float ls = (log_s0 + cf[j].w) + vol * w(j);
    return GEO ? ls : expf(ls);
  }
  // The adjacent-pair tree of the dates (an odd level's last element
  // carried up), its first three levels formed as the dates are: element i
  // < m / 8 of the third level is dates 8i .. 8i + 7 in a perfect tree, and
  // the m % 8 dates past them make its one more element, their own tree
  // (they start on a multiple of 8, so each level's parity is theirs).
  __device__ __forceinline__ void end(bool, uint32_t pos) {
    const int q = m >> 3, r = m & 7;
    for (int i = 0; i < q; ++i) {
      const int j = 8 * i;
      const float a = date(j) + date(j + 1);
      const float b = date(j + 2) + date(j + 3);
      const float c = date(j + 4) + date(j + 5);
      const float d = date(j + 6) + date(j + 7);
      w(i) = (a + b) + (c + d);
    }
    if (r != 0) {
      float t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) t[u] = u < r ? date(8 * q + u) : 0.0f;
      int n = r;
#pragma unroll
      for (int level = 0; level < 3; ++level) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (2 * i + 1 < n) {
            t[i] = t[2 * i] + t[2 * i + 1];
          } else if (2 * i < n) {
            t[i] = t[2 * i];
          }
        }
        n = (n + 1) >> 1;
      }
      w(q) = t[0];
    }
    int n = q + (r != 0);
    while (n > 1) {
      const int h = n >> 1;
      for (int i = 0; i < h; ++i) w(i) = w(2 * i) + w(2 * i + 1);
      if (n & 1) w(h) = w(n - 1);
      n = h + (n & 1);
    }
    float avg = w(0) * inv_m;
    if (GEO) avg = expf(avg);
    dst[pos] = fmaxf(avg - k, 0.0f);
  }
};

// ----------------------------------------------------------------- kernels

__device__ __forceinline__ Net block_net(const uint32_t* v,
                                         const uint32_t* low, uint32_t k0,
                                         uint32_t k1, uint32_t off, int m) {
  return Net{v, low, k0, k1, off + blockIdx.y, m};
}

// The chunk's N tile sums, reduced over the block in a fixed order, to row
// (replicate blockIdx.y, chunk blockIdx.x) of tiles (R, iters, N).
template <int N>
__device__ __forceinline__ void write_tile(float (&v)[N], float* sh,
                                           int iters, float* tiles) {
  mct::BlockAccN<THREADS, N, false> acc;
  acc.add(v, nullptr, sh);
  acc.write_n(tiles + (static_cast<size_t>(blockIdx.y) * iters + blockIdx.x) *
                          N,
              N);
}

template <bool PUT>
__global__ void __launch_bounds__(THREADS)
    rqmc_vanilla_kernel(const float* __restrict__ par, const uint32_t* v,
                        const uint32_t* low, uint32_t k0, uint32_t k1,
                        uint32_t off, int ppc,
                        int iters, float* __restrict__ tiles) {
  __shared__ float sh[WARPS * 2];
  VanPt<PUT> pt;
  pt.s0 = par[0];
  pt.k = par[1];
  pt.mu = par[2];
  pt.sig = par[3];
  run_net(block_net(v, low, k0, k1, off, 1),
          static_cast<uint32_t>(blockIdx.x) * static_cast<uint32_t>(ppc), ppc,
          pt);
  write_tile(pt.v, sh, iters, tiles);
}

template <bool PUT>
__global__ void __launch_bounds__(THREADS)
    rqmc_greeks_kernel(const float* __restrict__ par, const uint32_t* v,
                       const uint32_t* low, uint32_t k0, uint32_t k1,
                        uint32_t off, int ppc,
                       int iters, float* __restrict__ tiles) {
  __shared__ float sh[WARPS * 16];
  GreekPt<PUT> pt;
  pt.P = mct::van_par(par);
#pragma unroll
  for (int j = 0; j < 16; ++j) pt.v[j] = 0.0f;
  run_net(block_net(v, low, k0, k1, off, 1),
          static_cast<uint32_t>(blockIdx.x) * static_cast<uint32_t>(ppc), ppc,
          pt);
  write_tile(pt.v, sh, iters, tiles);
}

template <int MAXA>
__global__ void __launch_bounds__(THREADS)
    rqmc_basket_kernel(const float* __restrict__ par,
                       const float* __restrict__ lt,
                       const float* __restrict__ rows, const uint32_t* v,
                       const uint32_t* low, uint32_t k0, uint32_t k1,
                       uint32_t off, int a,
                       int ppc, int iters, float* __restrict__ tiles) {
  __shared__ float sh[WARPS * 2];
  BasketPt<MAXA> pt;
  pt.lt = lt;
  pt.rows = rows;
  pt.k = par[0];
  pt.a = a;
  run_net(block_net(v, low, k0, k1, off, a),
          static_cast<uint32_t>(blockIdx.x) * static_cast<uint32_t>(ppc), ppc,
          pt);
  write_tile(pt.v, sh, iters, tiles);
}

// Dynamic shared memory of the tiled K54: tiled_baskets' and the round's
// basket values.
inline size_t basket_tiled_smem_bytes(int a) {
  return mct::tiled_smem_bytes(a, false) + mct::TILED_UNITS * sizeof(float);
}

__global__ void __launch_bounds__(THREADS, 2)
    rqmc_basket_tiled_kernel(const float* __restrict__ par,
                             const float* __restrict__ lt,
                             const float* __restrict__ rows,
                             const uint32_t* v, const uint32_t* low,
                             uint32_t k0, uint32_t k1, uint32_t off, int a,
                             int ppc, int iters, float* __restrict__ tiles) {
  static_assert(THREADS == mct::TILED_THREADS, "tiled_baskets' threads");
  constexpr int RG = mct::TILED_UNITS / 32;  // groups a round
  __shared__ float sh[WARPS * 2];
  extern __shared__ float4 basket_sh[];
  float* zs = reinterpret_cast<float*>(basket_sh);
  float* bs = zs + mct::tiled_smem_bytes(a, false) / sizeof(float);
  const Net net = block_net(v, low, k0, k1, off, a);
  const uint32_t base =
      static_cast<uint32_t>(blockIdx.x) * static_cast<uint32_t>(ppc);
  const NetChunk C = net_chunk(a, base, ppc);
  const float k = par[0];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[2] = {0.0f, 0.0f};
  for (int g0 = 0; g0 < C.ngroups; g0 += RG) {
    const int nr = min(RG, C.ngroups - g0);  // the round's groups
    const int parts = WARPS / nr;            // warps a group
    if (warp < nr * parts) {  // the whole warp
      const int g = warp % nr, part = warp / nr;
      float* col = zs + 32 * g + lane;
      net_group(net, C.a0 + 32u * static_cast<uint32_t>(g0 + g),
                a * part / parts, a * (part + 1) / parts,
                [&](int d, float z) { col[d * mct::TILED_UNITS] = z; });
    }
    float basket, unused;
    mct::tiled_baskets<false>(lt, rows, a, 32 * nr, zs, basket, unused);
    if (threadIdx.x < 32 * nr) bs[threadIdx.x] = basket;
    __syncthreads();
    // bs is written again only after the next round's first barrier in
    // tiled_baskets, which each thread reaches after these reads.
    for (int g = 0; g < nr; ++g) {
      const int kk = g0 + g;
      if (kk % WARPS == warp) {  // batch kk's warp in run_net (gpb 1)
        const uint32_t pos = 32u * static_cast<uint32_t>(kk) +
                             static_cast<uint32_t>(lane);
        const float p = fmaxf(bs[32 * g + lane] - k, 0.0f);
        if (C.a0 + pos - base < static_cast<uint32_t>(ppc)) {
          acc[0] += p;
          acc[1] += p * p;
        }
      }
    }
  }
  write_tile(acc, sh, iters, tiles);
}

// A group of K55's items: replicates b0 .. b0 + nb, chunks i0 .. i0 + ni.
struct NetItems {
  int b0, nb, i0, ni;
};

// Floats of scratch a (replicate, chunk) item takes: its groups' points.
inline int asian_item_floats(int ppc) {
  return 32 * ((ppc % 32 == 0 ? ppc : ppc + 62) / 32);
}

inline mct::ScratchGroups asian_groups(int n_blocks, int ppc, int iters,
                                       size_t cap) {
  return mct::scratch_groups(n_blocks, iters, 0,
                             static_cast<size_t>(asian_item_floats(ppc)),
                             cap > 0 ? cap : mct::WALK_SCRATCH_CAP);
}

// Grid (nb * ni items, slices): warp w of block (item, slice) takes batch
// slice * WARPS + w of the item's chunk.  Dynamic shared memory: the bridge
// (32 m bytes), then where W is shared the warps' columns (128 m bytes a
// warp).
template <int MAXM, bool GEO>
__global__ void __launch_bounds__(THREADS)
    rqmc_asian_split_kernel(const float* __restrict__ par,
                            const float* __restrict__ drift,
                            const float* __restrict__ bridge,
                            const uint32_t* v, const uint32_t* low,
                            uint32_t k0, uint32_t k1, uint32_t off, int m,
                            int ppc, NetItems I, int item_floats,
                            float* __restrict__ split) {
  constexpr bool SHW = asian_w_shared<MAXM>();
  extern __shared__ float4 asian_sh[];
  int4* idx = reinterpret_cast<int4*>(asian_sh);
  float4* cf = asian_sh + m;
  for (int q = threadIdx.x; q < m; q += THREADS) {
    idx[q] = make_int4(static_cast<int>(bridge[q]),
                       static_cast<int>(bridge[m + q]),
                       static_cast<int>(bridge[2 * m + q]), 0);
    cf[q] = make_float4(bridge[3 * m + q], bridge[4 * m + q],
                        bridge[5 * m + q], drift[q]);
  }
  __syncthreads();
  const int item = blockIdx.x;
  const int bl = item / I.ni, il = item - bl * I.ni;
  const uint32_t base =
      static_cast<uint32_t>(I.i0 + il) * static_cast<uint32_t>(ppc);
  const NetChunk C = net_chunk(m, base, ppc);
  const int warp = threadIdx.x >> 5;
  const int kb = blockIdx.y * WARPS + warp;
  if (kb >= C.nbatch) return;  // the whole warp
  AsianPt<MAXM, GEO, SHW> pt;
  pt.idx = idx;
  pt.cf = cf;
  pt.log_s0 = par[0];
  pt.k = par[1];
  pt.vol = par[2];
  pt.inv_m = par[4];
  pt.m = m;
  if constexpr (SHW) {
    pt.col = reinterpret_cast<float*>(cf + m) + warp * m * 32 +
             (threadIdx.x & 31);
  }
  pt.dst = split + static_cast<size_t>(item) * item_floats;
  const Net net{v, low, k0, k1, off + static_cast<uint32_t>(I.b0 + bl), m};
  net_batch(net, C, base, ppc, kb, pt);
}

// Grid (ni, nb): block (il, bl) folds item bl * ni + il into tile row
// (b0 + bl, i0 + il), in run_net's order, then write_tile's tree.
__global__ void __launch_bounds__(THREADS)
    rqmc_asian_fold_kernel(const float* __restrict__ split, int m, int ppc,
                           NetItems I, int iters, int item_floats,
                           float* __restrict__ tiles) {
  __shared__ float sh[WARPS * 2];
  const int il = blockIdx.x, bl = blockIdx.y;
  const float* src =
      split + static_cast<size_t>(bl * I.ni + il) * item_floats;
  const uint32_t base =
      static_cast<uint32_t>(I.i0 + il) * static_cast<uint32_t>(ppc);
  const NetChunk C = net_chunk(m, base, ppc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // The thread's groups, s = 0 .. cnt - 1: group (warp + WARPS (s / gpb))
  // gpb + s % gpb, rising with s; the loads issued FOLD_BATCH ahead.
  int cnt = 0;
  for (int kb = warp; kb < C.nbatch; kb += WARPS) {
    cnt += min(C.gpb, C.ngroups - kb * C.gpb);
  }
  float v[2] = {0.0f, 0.0f};
  for (int s0 = 0; s0 < cnt; s0 += mct::FOLD_BATCH) {
    float x[mct::FOLD_BATCH];
    bool in[mct::FOLD_BATCH];
#pragma unroll
    for (int u = 0; u < mct::FOLD_BATCH; ++u) {
      const int s = s0 + u;
      x[u] = 0.0f;
      in[u] = false;
      if (s < cnt) {
        const int k = (warp + WARPS * (s / C.gpb)) * C.gpb + s % C.gpb;
        const uint32_t pos = 32u * static_cast<uint32_t>(k) +
                             static_cast<uint32_t>(lane);
        x[u] = src[pos];
        in[u] = C.a0 + pos - base < static_cast<uint32_t>(ppc);
      }
    }
#pragma unroll
    for (int u = 0; u < mct::FOLD_BATCH; ++u) {
      if (in[u]) {
        v[0] += x[u];
        v[1] += x[u] * x[u];
      }
    }
  }
  mct::BlockAccN<THREADS, 2, false> acc;
  acc.add(v, nullptr, sh);
  acc.write_n(tiles + (static_cast<size_t>(I.b0 + bl) * iters + I.i0 + il) *
                          2,
              2);
}

// Every group of items in order, its split and then its fold, into tiles
// (n_blocks, iters, 2).  Returns a CUDA error.
template <int MAXM, bool GEO>
int asian_split_launch(const float* par, const float* drift,
                       const float* bridge, const uint32_t* v,
                       const uint32_t* low, uint32_t k0, uint32_t k1,
                       uint32_t off, int m, int n_blocks, int ppc, int iters,
                       size_t cap, float* scratch, float* tiles,
                       cudaStream_t s) {
  constexpr bool SHW = asian_w_shared<MAXM>();
  const int item_floats = asian_item_floats(ppc);
  const int gpb = 32 / (m < 32 ? m : 32);
  const int nbatch = (item_floats / 32 + gpb - 1) / gpb;
  const int slices = (nbatch + WARPS - 1) / WARPS;
  if (slices > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 32 * static_cast<size_t>(m) +
                      (SHW ? static_cast<size_t>(WARPS) * m * 128 : 0);
  const auto kernel = rqmc_asian_split_kernel<MAXM, GEO>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const mct::ScratchGroups G = asian_groups(n_blocks, ppc, iters, cap);
  for (int b0 = 0; b0 < n_blocks; b0 += G.blocks) {
    const int nb = n_blocks - b0 < G.blocks ? n_blocks - b0 : G.blocks;
    for (int i0 = 0; i0 < iters; i0 += G.iters) {
      const int ni = iters - i0 < G.iters ? iters - i0 : G.iters;
      const NetItems I{b0, nb, i0, ni};
      kernel<<<dim3(static_cast<unsigned>(nb * ni),
                    static_cast<unsigned>(slices)),
               THREADS, smem, s>>>(par, drift, bridge, v, low, k0, k1, off,
                                   m, ppc, I, item_floats, scratch);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      rqmc_asian_fold_kernel<<<dim3(static_cast<unsigned>(ni),
                                    static_cast<unsigned>(nb)),
                               THREADS, 0, s>>>(scratch, m, ppc, I, iters,
                                                item_floats, tiles);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

// The second pass: thread (b, s) Neumaier-adds tiles[b, :, s] over the
// chunks in order and writes out[b, 2 s .. 2 s + 1] = (sum, compensation).
__global__ void __launch_bounds__(CARRY_THREADS)
    chunk_carry_kernel(const float* __restrict__ tiles, int n_blocks,
                       int iters, int n_sums, float* __restrict__ out) {
  const int t = blockIdx.x * CARRY_THREADS + threadIdx.x;
  if (t >= n_blocks * n_sums) return;
  const int b = t / n_sums;
  const int s = t - b * n_sums;
  const float* src = tiles + static_cast<size_t>(b) * iters * n_sums + s;
  float sum = 0.0f, comp = 0.0f;
  constexpr int UNROLL = 8;
  int i = 0;
  for (; i + UNROLL <= iters; i += UNROLL) {
    float x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      x[u] = __ldg(src + static_cast<size_t>(i + u) * n_sums);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) mct::kahan_add(sum, comp, x[u]);
  }
  for (; i < iters; ++i) {
    mct::kahan_add(sum, comp, __ldg(src + static_cast<size_t>(i) * n_sums));
  }
  out[static_cast<size_t>(b) * 2 * n_sums + 2 * s] = sum;
  out[static_cast<size_t>(b) * 2 * n_sums + 2 * s + 1] = comp;
}

// The carry over the chunks of tiles (n_blocks, iters, n_sums) into out;
// returns the CUDA error.
int launch_carry(int n_blocks, int iters, int n_sums, const float* tiles,
                 float* out, cudaStream_t stream) {
  const int threads = n_blocks * n_sums;
  chunk_carry_kernel<<<(threads + CARRY_THREADS - 1) / CARRY_THREADS,
                       CARRY_THREADS, 0, stream>>>(tiles, n_blocks, iters,
                                                   n_sums, out);
  return static_cast<int>(cudaGetLastError());
}

bool bad_grid(int n_blocks, int iters) {
  return n_blocks < 1 || n_blocks > 65535 || iters < 1;
}

// Launches the chunk kernel through launch(grid), then the carry; returns
// the first CUDA error.
template <class Launch>
int two_pass(int n_blocks, int iters, int n_sums, const float* tiles,
             float* out, cudaStream_t stream, Launch&& launch) {
  if (bad_grid(n_blocks, iters)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  launch(dim3(static_cast<unsigned>(iters), static_cast<unsigned>(n_blocks)));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_carry(n_blocks, iters, n_sums, tiles, out, stream);
}

}  // namespace

extern "C" {

int mctpu_rqmc_vanilla(const float* par, const uint32_t* v,
                       const uint32_t* low, int k0, int k1, int off, int m,
                       int n_blocks, int ppc, int iters, int put,
                       float* tiles, float* out, cudaStream_t stream) {
  if (m != 1) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t K0 = k0, K1 = k1, OFF = off;
  return two_pass(n_blocks, iters, 2, tiles, out, stream, [&](dim3 grid) {
    if (put) {
      rqmc_vanilla_kernel<true><<<grid, THREADS, 0, stream>>>(
          par, v, low, K0, K1, OFF, ppc, iters, tiles);
    } else {
      rqmc_vanilla_kernel<false><<<grid, THREADS, 0, stream>>>(
          par, v, low, K0, K1, OFF, ppc, iters, tiles);
    }
  });
}

int mctpu_rqmc_greeks(const float* par, const uint32_t* v,
                      const uint32_t* low, int k0, int k1, int off, int m,
                      int n_blocks, int ppc, int iters, int put, float* tiles,
                      float* out, cudaStream_t stream) {
  if (m != 1) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t K0 = k0, K1 = k1, OFF = off;
  return two_pass(n_blocks, iters, 16, tiles, out, stream, [&](dim3 grid) {
    if (put) {
      rqmc_greeks_kernel<true><<<grid, THREADS, 0, stream>>>(
          par, v, low, K0, K1, OFF, ppc, iters, tiles);
    } else {
      rqmc_greeks_kernel<false><<<grid, THREADS, 0, stream>>>(
          par, v, low, K0, K1, OFF, ppc, iters, tiles);
    }
  });
}

int mctpu_rqmc_basket(const float* par, const float* lt, const float* rows,
                      const uint32_t* v, const uint32_t* low, int k0, int k1,
                      int off, int a, int n_blocks, int ppc,
                      int iters, float* tiles, float* out,
                      cudaStream_t stream) {
  if (a < 1 || a > 2048) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t K0 = k0, K1 = k1, OFF = off;
  const bool tiled = a >= TILED_MIN_A && a <= TILED_MAX_A;
  const size_t smem = tiled ? basket_tiled_smem_bytes(a) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rqmc_basket_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(rqmc_basket_tiled_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return two_pass(n_blocks, iters, 2, tiles, out, stream, [&](dim3 grid) {
    if (tiled) {
      rqmc_basket_tiled_kernel<<<grid, THREADS, smem, stream>>>(
          par, lt, rows, v, low, K0, K1, OFF, a, ppc, iters, tiles);
    } else if (a < TILED_MIN_A) {
      rqmc_basket_kernel<64><<<grid, THREADS, 0, stream>>>(
          par, lt, rows, v, low, K0, K1, OFF, a, ppc, iters, tiles);
    } else {
      rqmc_basket_kernel<2048><<<grid, THREADS, 0, stream>>>(
          par, lt, rows, v, low, K0, K1, OFF, a, ppc, iters, tiles);
    }
  });
}

// Floats of scratch a K55 launch takes (cap: at most this many, 0 for 256
// MB; past it the replicates and chunks go in groups).
int mctpu_rqmc_asian_scratch_floats(int n_blocks, int ppc, int iters,
                                    int cap) {
  return static_cast<int>(
      asian_groups(n_blocks, ppc, iters, static_cast<size_t>(cap)).total);
}

// K55: the split net and its fold into tiles, scratch of
// mctpu_rqmc_asian_scratch_floats(.., cap) floats, then the carry.
int mctpu_rqmc_asian(const float* par, const float* drift,
                     const float* bridge, const uint32_t* v,
                     const uint32_t* low, int k0, int k1, int off, int m,
                     int n_blocks, int ppc, int iters, int geometric, int cap,
                     float* scratch, float* tiles, float* out,
                     cudaStream_t stream) {
  if (m < 1 || m > 2048 || bad_grid(n_blocks, iters)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t K0 = k0, K1 = k1, OFF = off;
  int err;
#define MCT_ASIAN(MAXM, GEO)                                                \
  err = asian_split_launch<MAXM, GEO>(par, drift, bridge, v, low, K0, K1,   \
                                      OFF, m, n_blocks, ppc, iters,         \
                                      static_cast<size_t>(cap), scratch,    \
                                      tiles, stream)
  if (m <= 64) {
    if (geometric) MCT_ASIAN(64, true); else MCT_ASIAN(64, false);
  } else if (m <= 256) {
    if (geometric) MCT_ASIAN(256, true); else MCT_ASIAN(256, false);
  } else {
    if (geometric) MCT_ASIAN(2048, true); else MCT_ASIAN(2048, false);
  }
#undef MCT_ASIAN
  if (err != 0) return err;
  return launch_carry(n_blocks, iters, 2, tiles, out, stream);
}

}  // extern "C"
