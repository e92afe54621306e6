// The vanilla Greek integrands of one draw, shared by greeks.cu (K6, over
// K1's Philox draws) and rqmc.cu (K53, over a Sobol net): the payoff and
// the delta, vega, rho, theta, gamma, vanna and volga integrands of
// mctpu/kernels/greeks.py::_greek_tile (pathwise first order, the mixed
// pathwise-likelihood-ratio device for the second order, a signed
// indicator for the put).  Each source compiles them with its own flags:
// rqmc.cu takes no FMA contraction (mctpu_torch/_build.py), so K53's
// integrands round as the plain version's separate operations do.
#pragma once

#include "common.cuh"

namespace mct {

struct VanPar {
  float s0, k, r, v, t, mu, sig, sqt, cg, cvn, cvg, inv_s0;
};

// The integrands' constants from par = [s, k, r, v, t, mu, sig, sqt]
// (mctpu_torch/kernels/greeks.py, params).
__device__ __forceinline__ VanPar van_par(const float* par) {
  VanPar P;
  P.s0 = par[0];
  P.k = par[1];
  P.r = par[2];
  P.v = par[3];
  P.t = par[4];
  P.mu = par[5];
  P.sig = par[6];
  P.sqt = par[7];
  P.cg = P.k / (P.s0 * P.s0 * P.sig);
  P.cvn = P.k / (P.s0 * P.sig);
  P.cvg = P.k / P.sig;
  P.inv_s0 = 1.0f / P.s0;
  return P;
}

// Payoff and the 7 integrands of one draw (mctpu _greek_tile's quants).
template <bool PUT>
__device__ __forceinline__ void van_quants(const VanPar& P, float zz,
                                           float (&q)[8]) {
  const float st = P.s0 * expf(P.mu + P.sig * zz);
  float ind, p;
  if (PUT) {
    ind = st < P.k ? -1.0f : 0.0f;
    p = fmaxf(P.k - st, 0.0f);
  } else {
    ind = st > P.k ? 1.0f : 0.0f;
    p = fmaxf(st - P.k, 0.0f);
  }
  const float w = ind * st;
  const float gd = w * P.inv_s0;
  const float wv = P.sqt * zz - P.v * P.t;
  q[0] = p;
  q[1] = gd;
  q[2] = w * wv;
  q[3] = (P.t * P.k) * ind;
  q[4] = w * (P.r - 0.5f * P.v * P.v + 0.5f * P.v * zz / P.sqt) - P.r * p;
  q[5] = P.cg * (ind * zz);
  q[6] = gd * wv + P.cvn * (ind * (wv * zz - P.sqt));
  q[7] = w * (wv * wv - P.t) + P.cvg * (ind * (wv * (wv * zz - 2.0f * P.sqt)));
}

}  // namespace mct
