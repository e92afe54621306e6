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
// (chunk, replicate) and writes that chunk's float32 tile sums (sum p,
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
// past 64 assets).  K55 holds a
// point's W in a local array of one of three sizes (m <= 64, 256, 2048 =
// MAX_DIM), K54 its z.
//
// Bound on the H100: float32 operations and the SFU (logf and expf per
// point-dim); K54 at a = 100 by the 5050-term correlation product per
// point, as K3.  This source builds with -fmad=false (mctpu_torch/_build.py):
// the quantile's Horner steps, the payoff kink and K53's in-the-money
// indicator round as the plain version's separate operations do.
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
template <bool LAZY>
__device__ __forceinline__ float giles_from_w(float w, float x) {
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
  const bool tail = !(w < 5.0f);
  if (!LAZY || __any_sync(0xffffffffu, tail)) {
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

// Drives pt over the ppc points of the chunk whose first point has index
// base: per point pt.begin(), pt.dim(d, z) for d = 0 .. m-1 in order, then
// pt.end(inside the chunk); z = norm_ppf<Pt::kLazyTail>.  Warps take
// batches of gpb = 32 / min(m, 32) aligned 32-point groups; in a batch lane
// (g, d) forms x(A_g) of dim d, shifted (the dims in slices of 32 when
// m > 32, one group a batch).
// Every lane of a warp runs every step, so the shuffles see the whole warp.
template <class Pt>
__device__ __forceinline__ void run_net(const Net& net, uint32_t base,
                                        int ppc, Pt& pt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m = net.m;
  const int dc = m < 32 ? m : 32;
  const int gpb = 32 / dc;
  const uint32_t a0 = base & ~31u;
  const int ngroups = static_cast<int>(
      ((base & 31u) + static_cast<uint32_t>(ppc) + 31u) >> 5);
  const int nbatch = (ngroups + gpb - 1) / gpb;
  const int my_g = lane / dc;
  const int my_d = lane - my_g * dc;
  for (int kb = warp; kb < nbatch; kb += WARPS) {
    uint32_t h = 0u;
    for (int g = 0; g < gpb; ++g) {
      const int k = kb * gpb + g;
      if (k >= ngroups) break;
      const uint32_t n = a0 + 32u * static_cast<uint32_t>(k) +
                         static_cast<uint32_t>(lane);
      pt.begin();
      for (int d0 = 0; d0 < m; d0 += 32) {
        if (g == 0) {  // m <= 32: one slice, formed for the whole batch
          const int kk = kb * gpb + my_g;
          const int dd = d0 + my_d;
          h = 0u;
          if (my_g < gpb && kk < ngroups && dd < m) {
            const uint32_t shift =
                mct::philox4x32_10(net.k0, net.k1, net.rep,
                                   static_cast<uint32_t>(dd), SHIFT_TAG, 0u)
                    .x;
            h = sobol30(a0 + 32u * static_cast<uint32_t>(kk),
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
      pt.end(n - base < static_cast<uint32_t>(ppc));
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
  __device__ __forceinline__ void end(bool inside) {
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
  __device__ __forceinline__ void end(bool inside) {
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

// Past 64 assets the correlation product outweighs the quantiles, and the
// lazy tail's vote and branch cost its loop registers (ptxas: 63 -> 48 and
// a spill; 100 assets 13% slower, tools/time_rqmc.py), so those instances
// form both polynomials.
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
  __device__ __forceinline__ void end(bool inside) {
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

// br: the (6, m) bridge rows left, right, out, ca, cb, sds.
template <int MAXM, bool GEO>
struct AsianPt {
  static constexpr bool kLazyTail = true;
  const float* br;
  const float* drift;
  float log_s0, k, vol, inv_m;
  int m;
  float w[MAXM];
  float v[2] = {0.0f, 0.0f};

  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void dim(int q, float z) {
    const int o = static_cast<int>(__ldg(br + 2 * m + q));
    const float sz = __ldg(br + 5 * m + q) * z;
    if (q == 0) {
      w[o] = sz;
      return;
    }
    const int l = static_cast<int>(__ldg(br + q));
    float wb = __ldg(br + 4 * m + q) * w[static_cast<int>(__ldg(br + m + q))];
    if (l >= 0) wb = __ldg(br + 3 * m + q) * w[l] + wb;
    w[o] = wb + sz;
  }
  __device__ __forceinline__ void end(bool inside) {
    for (int j = 0; j < m; ++j) {
      const float ls = (log_s0 + __ldg(drift + j)) + vol * w[j];
      w[j] = GEO ? ls : expf(ls);
    }
    int n = m;
    while (n > 1) {
      const int half = n >> 1;
      for (int i = 0; i < half; ++i) w[i] = w[2 * i] + w[2 * i + 1];
      if (n & 1) w[half] = w[n - 1];
      n = half + (n & 1);
    }
    float avg = w[0] * inv_m;
    if (GEO) avg = expf(avg);
    const float p = fmaxf(avg - k, 0.0f);
    if (inside) {
      v[0] += p;
      v[1] += p * p;
    }
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

template <int MAXM, bool GEO>
__global__ void __launch_bounds__(THREADS)
    rqmc_asian_kernel(const float* __restrict__ par,
                      const float* __restrict__ drift,
                      const float* __restrict__ bridge, const uint32_t* v,
                      const uint32_t* low, uint32_t k0, uint32_t k1,
                      uint32_t off, int m, int ppc, int iters, float* __restrict__ tiles) {
  __shared__ float sh[WARPS * 2];
  AsianPt<MAXM, GEO> pt;
  pt.br = bridge;
  pt.drift = drift;
  pt.log_s0 = par[0];
  pt.k = par[1];
  pt.vol = par[2];
  pt.inv_m = par[4];
  pt.m = m;
  run_net(block_net(v, low, k0, k1, off, m),
          static_cast<uint32_t>(blockIdx.x) * static_cast<uint32_t>(ppc), ppc,
          pt);
  write_tile(pt.v, sh, iters, tiles);
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

// Launches the chunk kernel through launch(grid), then the carry; returns
// the first CUDA error.
template <class Launch>
int two_pass(int n_blocks, int iters, int n_sums, const float* tiles,
             float* out, cudaStream_t stream, Launch&& launch) {
  if (n_blocks < 1 || n_blocks > 65535 || iters < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  launch(dim3(static_cast<unsigned>(iters), static_cast<unsigned>(n_blocks)));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = n_blocks * n_sums;
  chunk_carry_kernel<<<(threads + CARRY_THREADS - 1) / CARRY_THREADS,
                       CARRY_THREADS, 0, stream>>>(tiles, n_blocks, iters,
                                                   n_sums, out);
  return static_cast<int>(cudaGetLastError());
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
  return two_pass(n_blocks, iters, 2, tiles, out, stream, [&](dim3 grid) {
    if (a <= 64) {
      rqmc_basket_kernel<64><<<grid, THREADS, 0, stream>>>(
          par, lt, rows, v, low, K0, K1, OFF, a, ppc, iters, tiles);
    } else if (a <= 256) {
      rqmc_basket_kernel<256><<<grid, THREADS, 0, stream>>>(
          par, lt, rows, v, low, K0, K1, OFF, a, ppc, iters, tiles);
    } else {
      rqmc_basket_kernel<2048><<<grid, THREADS, 0, stream>>>(
          par, lt, rows, v, low, K0, K1, OFF, a, ppc, iters, tiles);
    }
  });
}

int mctpu_rqmc_asian(const float* par, const float* drift,
                     const float* bridge, const uint32_t* v,
                     const uint32_t* low, int k0, int k1, int off, int m,
                     int n_blocks, int ppc, int iters, int geometric,
                     float* tiles, float* out, cudaStream_t stream) {
  if (m < 1 || m > 2048) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t K0 = k0, K1 = k1, OFF = off;
  return two_pass(n_blocks, iters, 2, tiles, out, stream, [&](dim3 grid) {
#define MCT_ASIAN(MAXM, GEO)                                               \
  rqmc_asian_kernel<MAXM, GEO><<<grid, THREADS, 0, stream>>>(              \
      par, drift, bridge, v, low, K0, K1, OFF, m, ppc, iters, tiles)
    if (m <= 64) {
      if (geometric) MCT_ASIAN(64, true); else MCT_ASIAN(64, false);
    } else if (m <= 256) {
      if (geometric) MCT_ASIAN(256, true); else MCT_ASIAN(256, false);
    } else {
      if (geometric) MCT_ASIAN(2048, true); else MCT_ASIAN(2048, false);
    }
#undef MCT_ASIAN
  });
}

}  // extern "C"
