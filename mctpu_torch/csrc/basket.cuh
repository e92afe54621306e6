// The per-path cores of the terminal basket kernels, shared by basket.cu
// (K2, K3: the payoff) and varred.cu (K47, K48: the payoff and the basket
// value, the control variate).  Each source compiles them with its own
// flags: varred.cu takes no FMA contraction (mctpu_torch/_build.py), so its
// L z and basket sums round as the plain version's multiplies and adds.
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

}  // namespace mct
