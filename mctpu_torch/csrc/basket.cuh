// The per-path cores of the terminal basket kernels, shared by basket.cu
// (K2, K3: the payoff) and varred.cu (K47, K48: the payoff and the basket
// value, the control variate), and the register-tiled product of K3's and
// K48's items (tiled_item) and of K54's rounds (tiled_baskets, rqmc.cu).
// Each source compiles them with its own flags: varred.cu and rqmc.cu take
// no FMA contraction (mctpu_torch/_build.py), so their L z and basket sums
// round as the plain version's multiplies and adds; basket.cu contracts
// drift + vol (bt + d) into one multiply-add in both of its K3 designs
// alike.
#pragma once

#include "common.cuh"

namespace mct {

// Asset-major (K2, K47): sum_i ws0_i exp(drift_i + vol_i (sgn * (L z)_i +
// d_i)) from one path's A normals z; par rows: drift, vol, d, w*s0
// (mctpu_torch/kernels/basket.py, asset_major_ops).
template <int A>
__device__ __forceinline__ float am_basket(const float* z, const float* lt,
                                           const float* par, float sgn) {
  float basket = 0.0f;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    float bt = lt[i * A] * z[0];
#pragma unroll
    for (int j = 1; j <= i; ++j) bt = bt + lt[i * A + j] * z[j];
    const float arg = par[i] + par[A + i] * (sgn * bt + par[2 * A + i]);
    const float term = par[3 * A + i] * expf(arg);
    basket = (i == 0) ? term : basket + term;
  }
  return basket;
}

// Lane-packed (K3, K48): the basket value of one packed path from its a
// normals z (shared memory), and under ANTI its mirror's (basket_m); bt is
// formed once and serves both signs.  par rows: drift, vol, d, s0, w
// (mctpu_torch/kernels/basket.py, pack_assets).
template <bool ANTI>
__device__ __forceinline__ void packed_baskets(const float* z,
                                               const float* __restrict__ lt,
                                               const float* __restrict__ par,
                                               int a, float& basket,
                                               float& basket_m) {
  basket = 0.0f;
  basket_m = 0.0f;
  for (int j = 0; j < a; ++j) {
    const float* lrow = lt + j * a;
    float bt = 0.0f;
    for (int l = 0; l <= j; ++l) bt = fmaf(__ldg(lrow + l), z[l], bt);
    const float drift = __ldg(par + j), vol = __ldg(par + a + j);
    const float d = __ldg(par + 2 * a + j), s0 = __ldg(par + 3 * a + j);
    const float w = __ldg(par + 4 * a + j);
    basket = fmaf(s0 * expf(drift + vol * (bt + d)), w, basket);
    if (ANTI) basket_m = fmaf(s0 * expf(drift + vol * (d - bt)), w, basket_m);
  }
}

// The register-tiled product of K3's and K48's items and of K54's rounds
// (csrc/rqmc.cu): TILED_THREADS threads form the basket values of nu <=
// TILED_UNITS units whose a normals sit in shared memory unit by unit
// ([a][128], each row's 128 units contiguous).  Per j-tile of 32 assets
// (the tiles end at a) the slice of L it reads ([l][32], L[j][l] at l <= j,
// zero above the diagonal and below asset 0) is staged beside them.  Each
// thread holds a tile of 4 units x 4 assets: per l one float4 of normals
// and one of L feed 16 fmaf.  Warp w takes units 64 (w & 1) .. + 64 and
// assets 8 (w >> 1) .. + 8 of the j-tile, up to l = its last asset + 1
// (none if they lie below asset 0): every bt_j is fmaf(L[j][l], z[l], bt)
// from 0.0f over l = 0 .. j ascending, as packed_baskets forms it, followed
// by fmaf(0, z, bt) for the l of its tile above j, which return bt but for
// the sign of a zero bt, and expf(+-0) = 1 makes the term the same.  The
// tile's threads form term_j = s0_j expf(drift_j + vol_j (bt_j + d_j)) (and
// the mirror's, d_j - bt_j) into shared memory, and the unit's thread folds
// the j-tile into its running basket, fmaf(term_j, w_j, basket) with j
// ascending.  So each unit's basket values are packed_baskets' bit for bit
// under the including source's flags.  Shared memory at a = 100,
// antithetic: 94.5 KB, two blocks an SM.
constexpr int TILED_THREADS = 256;  // an item's threads
constexpr int TILED_UNITS = 128;    // unit slots of a chunk
constexpr int TILED_JT = 32;        // assets of a j-tile

// Dynamic shared memory of a tiled item: the chunk's normals and L's
// slice, the terms of one sign or both.
__host__ __device__ inline size_t tiled_smem_bytes(int a, bool anti) {
  return (static_cast<size_t>(a) * (TILED_UNITS + TILED_JT) +
          (anti ? 2 : 1) * TILED_JT * TILED_UNITS) * sizeof(float);
}

// The basket values of units 0 .. nu - 1 from their normals in zs
// ([a][TILED_UNITS], then tiled_smem_bytes' L slice and terms): thread q <
// nu gets unit q's (and under ANTI its mirror's).  The normals' writes are
// fenced by the first barrier here; zs may be written again once the
// calling thread returns (every thread has passed the last barrier, after
// the last read of zs), the terms only after the next call's first barrier.
template <bool ANTI>
__device__ __forceinline__ void tiled_baskets(const float* __restrict__ lt,
                                              const float* __restrict__ par,
                                              int a, int nu, float* zs,
                                              float& basket,
                                              float& basket_m) {
  float* ls = zs + a * TILED_UNITS;          // [a][TILED_JT]
  float* ts = ls + a * TILED_JT;             // [TILED_JT][TILED_UNITS]
  float* tms = ts + TILED_JT * TILED_UNITS;  // the mirror's (ANTI)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int uw = (warp & 1) * 64, jw = (warp >> 1) * 8;
  const int ub = uw + (lane & 15) * 4;  // the thread's first unit
  const int jb = jw + (lane >> 4) * 4;  // its first asset in the j-tile
  basket = 0.0f;
  basket_m = 0.0f;
  // j-tiles end at a: the first holds the a mod 32 lowest assets (its
  // warps below j = 0 idle), so no tile takes a full-depth l loop for a
  // few assets.
  for (int j0 = a - (a + TILED_JT - 1) / TILED_JT * TILED_JT; j0 < a;
       j0 += TILED_JT) {
    const int kt = j0 + TILED_JT;
    for (int t = threadIdx.x; t < kt * TILED_JT; t += TILED_THREADS) {
      const int l = t / TILED_JT, j = j0 + (t - l * TILED_JT);
      ls[t] = (j >= 0 && l <= j) ? __ldg(lt + j * a + l) : 0.0f;
    }
    __syncthreads();
    if (uw < nu && j0 + jw + 8 > 0) {
      const int kmax = j0 + jw + 8;
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[u][jj] = 0.0f;
      }
#pragma unroll 4
      for (int l = 0; l < kmax; ++l) {
        const float4 z4 =
            *reinterpret_cast<const float4*>(zs + l * TILED_UNITS + ub);
        const float4 l4 =
            *reinterpret_cast<const float4*>(ls + l * TILED_JT + jb);
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
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jb + jj;
        if (j >= 0) {
          const float drift = __ldg(par + j), vol = __ldg(par + a + j);
          const float d = __ldg(par + 2 * a + j);
          const float s0 = __ldg(par + 3 * a + j);
          float t[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            t[u] = s0 * expf(drift + vol * (acc[u][jj] + d));
          }
          *reinterpret_cast<float4*>(ts + (jb + jj) * TILED_UNITS + ub) =
              make_float4(t[0], t[1], t[2], t[3]);
          if (ANTI) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              t[u] = s0 * expf(drift + vol * (d - acc[u][jj]));
            }
            *reinterpret_cast<float4*>(tms + (jb + jj) * TILED_UNITS + ub) =
                make_float4(t[0], t[1], t[2], t[3]);
          }
        }
      }
    }
    __syncthreads();
    // The fold reads the terms after the barrier; the next j-tile writes
    // them (and the next call its normals) only after its own first
    // barrier, which each unit's thread reaches after its fold.
    if (tid < nu) {
      for (int jj = max(0, -j0); jj < TILED_JT; ++jj) {
        const float w = __ldg(par + 4 * a + j0 + jj);
        basket = fmaf(ts[jj * TILED_UNITS + tid], w, basket);
        if (ANTI) basket_m = fmaf(tms[jj * TILED_UNITS + tid], w, basket_m);
      }
    }
  }
}

// K3's and K48's items at width 128 (9-128 assets): one CUDA block of
// TILED_THREADS threads per (simulation block, iteration) item walks the
// unsplit kernels' chunks of chunk_rows rows on their key and counters
// (draws (r0 * width + e, i)), and unit q = 2 path + branch of a chunk (at
// most TILED_UNITS of them) goes to thread q, as in the unsplit kernels'
// per-unit loop; tiled_baskets forms each chunk's basket values.
// Runs the chunks of one item in order; after each, thread q < nu (the
// chunk's units) calls unit(u0, q, basket, basket_m) with u0 = 2 c r0, the
// chunk's first unit in the item.
template <bool ANTI, class Unit>
__device__ __forceinline__ void tiled_item(const float* __restrict__ lt,
                                           const float* __restrict__ par,
                                           int a, int a_tile, int chunk_rows,
                                           Key key, uint32_t i, int rows,
                                           Unit&& unit) {
  extern __shared__ float4 smem4[];
  float* zs = reinterpret_cast<float*>(smem4);  // [a][TILED_UNITS]
  constexpr int width = LANES;
  const int c = width / a_tile;
  const int tid = threadIdx.x;
  // The draw: thread t takes path t % 64 of a chunk (at most 64 paths, as
  // 2 c chunk_rows <= TILED_UNITS) and its assets t / 64, t / 64 + 4, ...
  const int dp = tid & (TILED_UNITS / 2 - 1), dl = tid / (TILED_UNITS / 2);
  const int drow = dp / c, dlane = (dp - drow * c) * a_tile;
  for (int r0 = 0; r0 < rows; r0 += chunk_rows) {
    const int np = min(chunk_rows, rows - r0) * c;  // the chunk's paths
    const int nu = 2 * np;                          // and units
    if (dp < np) {
      const uint32_t e0 =
          static_cast<uint32_t>((r0 + drow) * width + dlane);
      for (int l = dl; l < a; l += TILED_THREADS / (TILED_UNITS / 2)) {
        float2 z;
        draw_normal_pair(key, e0 + static_cast<uint32_t>(l), i, z.x, z.y);
        *reinterpret_cast<float2*>(zs + l * TILED_UNITS + 2 * dp) = z;
      }
    }
    float basket, basket_m;
    tiled_baskets<ANTI>(lt, par, a, nu, zs, basket, basket_m);
    if (tid < nu) unit(2 * c * r0, tid, basket, basket_m);
  }
}

}  // namespace mct
