"""Closed-form financial math on tensors (counterpart of :mod:`mctpu.math`).

The oracles (Black-Scholes, the CVA, netting-set CVA and xVA,
geometric-Asian, barrier, lookback, cliquet and two-asset rainbow closed
forms, the CRR lattice price of an American option) and the host-side
setup (Cholesky, default-leg and xVA leg
weights) run in float64 — the port's ``wide_dtype`` is always float64, as
``mctpu`` under x64.  ``norm_cdf_hastings`` is the kernels' CDF and runs
in the dtype it is given; the leg-weight tables also build in float32 for
the kernels.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "wide_dtype",
    "norm_cdf",
    "norm_cdf_hastings",
    "bs_call",
    "bs_put",
    "bs_greeks",
    "cholesky_lower",
    "default_leg_weights",
    "cva_closed_form",
    "cva_portfolio_closed_form",
    "cva_multi_closed_form",
    "xva_leg_weights",
    "funding_leg_weights",
    "xva_leg_weight_derivs",
    "xva_multi_closed_form",
    "geometric_asian_call",
    "up_and_out_call",
    "barrier_continuity_correction",
    "lookback_floating_call",
    "cliquet_closed_form",
    "bivariate_norm_cdf",
    "rainbow_min_call",
    "rainbow_max_call",
    "binomial_american",
    "erf_inv_f32",
    "norm_ppf_f32",
]


def wide_dtype() -> torch.dtype:
    """The estimator's and the combine's dtype: always float64 here."""
    return torch.float64


def _t(x, dtype=torch.float64) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float64), dtype=dtype)


def _as(x, dtype) -> torch.Tensor:
    """``x`` in ``dtype``; a tensor stays in its autograd graph."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return _t(x, dtype)


def _wide(x) -> torch.Tensor:
    """``x`` as float64; a tensor stays in its autograd graph."""
    return _as(x, torch.float64)


# Hastings polynomial (Abramowitz & Stegun 26.2.17), the reference's `cnd`.
_A1 = 0.31938153
_A2 = -0.356563782
_A3 = 1.781477937
_A4 = -1.821255978
_A5 = 1.330274429
_ONEOVER2PI = 0.39894228040143267793994605993438


def norm_cdf_hastings(d: torch.Tensor) -> torch.Tensor:
    """Hastings approximation of the standard normal CDF (|err| < 7.5e-8)."""
    k = 1.0 / (1.0 + 0.2316419 * d.abs())
    poly = k * (_A1 + k * (_A2 + k * (_A3 + k * (_A4 + k * _A5))))
    cnd = _ONEOVER2PI * torch.exp(-0.5 * d * d) * poly
    return torch.where(d > 0, 1.0 - cnd, cnd)


def norm_cdf(d: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF via erf."""
    return 0.5 * (1.0 + torch.erf(d * (2.0 ** -0.5)))


# Giles (2010), "Approximating the erfinv function": the float32 polynomial
# pair (central for w < 5, tail otherwise) of mctpu.math, which the RQMC
# kernels (csrc/rqmc.cu) evaluate in the same order.
_GILES_CENTRAL = (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164,
                  0.246640727, 1.50140941)
_GILES_TAIL = (0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047,
               1.00167406, 2.83297682)


def _f32(x) -> torch.Tensor:
    """``x`` rounded to float32 as ``jnp.float32(x)`` rounds it."""
    return torch.tensor(np.float32(x))


def _giles_from_w(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The Giles polynomials in ``w = -log(1 - x^2)``, times ``x``:
    float32 Horner steps ``c + p * wc``, both branches evaluated, selected
    by ``w < 5``.  The square root is the correctly rounded one (taken in
    float64, rounded once), as ``sqrtf`` gives it on the card and
    ``jnp.sqrt`` on the CPU."""
    wc = w - 2.5
    p = _f32(2.81022636e-08)
    for c in _GILES_CENTRAL:
        p = _f32(c) + p * wc
    wt = torch.sqrt(w.double()).float() - 3.0
    q = _f32(-0.000200214257)
    for c in _GILES_TAIL:
        q = _f32(c) + q * wt
    return torch.where(w < 5.0, p, q) * x


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function (Giles polynomial pair)."""
    w = -torch.log(torch.clamp((1.0 - x) * (1.0 + x), min=_f32(1e-37)))
    return _giles_from_w(w, x)


def norm_ppf_f32(u: torch.Tensor) -> torch.Tensor:
    """float32 inverse standard-normal CDF of uniforms: ``sqrt(2)
    erfinv(2u - 1)`` entered through ``w = -log(4 u (1 - u))``, with ``u``
    clipped to ``[1e-7, 1 - 1e-7]`` (float32 bounds)."""
    eps = _f32(1e-7)
    u = torch.minimum(torch.maximum(u, eps), 1.0 - eps)
    x = 2.0 * u - 1.0
    w = -torch.log(4.0 * u * (1.0 - u))
    return _giles_from_w(w, x) * _f32(1.4142135623730951)


def bs_call(s, k, r, v, t) -> torch.Tensor:
    """Black-Scholes European call in float64; intrinsic value at ``t = 0``.
    Differentiable by autograd in every tensor argument."""
    s, k, r, v, t = (_wide(x) for x in (s, k, r, v, t))
    eps = 1e-12
    t_safe = torch.clamp(t, min=eps)
    sq = v * torch.sqrt(t_safe)
    d1 = (torch.log(s / k) + (r + 0.5 * v * v) * t_safe) / sq
    d2 = d1 - sq
    price = s * norm_cdf(d1) - k * torch.exp(-r * t_safe) * norm_cdf(d2)
    return torch.where(t > eps, price, torch.clamp(s - k, min=0.0))


def bs_put(s, k, r, v, t) -> torch.Tensor:
    """Black-Scholes European put by put-call parity."""
    s_, k_, r_, t_ = (_t(x) for x in (s, k, r, t))
    return bs_call(s, k, r, v, t) - s_ + k_ * torch.exp(-r_ * t_)


def bs_greeks(s, k, r, v, t) -> dict:
    """Closed-form Black-Scholes call Greeks in float64: price, delta,
    gamma, vega, theta (d/d maturity), rho, vanna (d2V/ds dv) and volga
    (d2V/dv2); vanna, volga, gamma and vega are the same for the put."""
    s, k, r, v, t = (_t(x) for x in (s, k, r, v, t))
    sq = v * torch.sqrt(t)
    d1 = (torch.log(s / k) + (r + 0.5 * v * v) * t) / sq
    d2 = d1 - sq
    pdf = torch.exp(-0.5 * d1 * d1) * 0.3989422804014327
    disc = torch.exp(-r * t)
    return {
        "price": s * norm_cdf(d1) - k * disc * norm_cdf(d2),
        "delta": norm_cdf(d1),
        "gamma": pdf / (s * sq),
        "vega": s * pdf * torch.sqrt(t),
        "theta": s * pdf * v / (2 * torch.sqrt(t)) + r * k * disc * norm_cdf(d2),
        "rho": k * t * disc * norm_cdf(d2),
        "vanna": -pdf * d2 / v,
        "volga": s * pdf * torch.sqrt(t) * d1 * d2 / v,
    }


def cholesky_lower(corr) -> torch.Tensor:
    """Lower Cholesky factor ``L`` with ``L @ L.T == corr``, PSD-tolerant.

    A pivot below ``n * eps * max|diag|`` is numerically zero and leaves its
    column zero, as the reference's pivot-guarded ``Chol`` does — needed for
    the reference's singular 3-asset matrix.
    """
    c = _t(corr)
    n = c.shape[0]
    a = torch.zeros_like(c)
    idx = torch.arange(n)
    tol = n * torch.finfo(c.dtype).eps * c.diagonal().abs().max()
    for j in range(n):
        v = c[:, j] - a @ a[j, :]
        col = torch.where(v[j] > tol, v / torch.sqrt(torch.maximum(v[j], tol)),
                          torch.zeros_like(v))
        a[:, j] = torch.where(idx >= j, col, torch.zeros_like(col))
    return a


def default_leg_weights(intensity, t, n_grid: int,
                        dtype=torch.float64) -> torch.Tensor:
    """Default-probability mass per node, ``dp_j = e^{-lam t_{j-1}} -
    e^{-lam t_j}``, in the cancellation-free form ``e^{-lam dt (j-1)} *
    (-expm1(-lam dt))``."""
    dt = _t(t, dtype) / n_grid
    j = torch.arange(1, n_grid + 1, dtype=dtype)
    lam = _t(intensity, dtype)
    return torch.exp(-lam * dt * (j - 1)) * (-torch.expm1(-lam * dt))


def _cva_node_factor(intensity, r, t, n_grid: int) -> torch.Tensor:
    """``sum_j dp_j e^{r t_j}``: the martingale factor of the closed forms."""
    dp = default_leg_weights(intensity, t, n_grid)
    tj = _t(t) / n_grid * torch.arange(1, n_grid + 1, dtype=torch.float64)
    return torch.sum(dp * torch.exp(_t(r) * tj))


def cva_closed_form(intensity, lgd, s, k, r, v, t,
                    n_grid: int) -> torch.Tensor:
    """Exact expectation of the (undiscounted) CVA estimator:
    ``lgd * C(S_0, T) * sum_j dp_j e^{r t_j}``."""
    return _t(lgd) * bs_call(s, k, r, v, t) * _cva_node_factor(
        intensity, r, t, n_grid)


def cva_portfolio_closed_form(intensity, lgd, s, r, v, t, strikes, weights,
                              n_grid: int) -> torch.Tensor:
    """Exact CVA of an all-long call portfolio (netting never binds)."""
    if (np.asarray(weights) < 0).any():
        raise ValueError("closed form requires non-negative weights "
                         "(netting may bind otherwise)")
    c0 = torch.sum(_t(weights) * bs_call(s, strikes, r, v, t))
    return _t(lgd) * c0 * _cva_node_factor(intensity, r, t, n_grid)


def cva_multi_closed_form(intensity, lgd, s, v, strikes, weights, r, t,
                          n_grid: int) -> torch.Tensor:
    """Exact CVA of an all-long netting set over ``M`` correlated
    underlyings in float64: with non-negative weights the netting never
    binds, and each option's discounted Black-Scholes value is a martingale
    in its own underlying, so the correlation drops out:

        CVA = lgd (sum_m w_m C_0(s_m, k_m, v_m)) sum_j dp_j e^{r t_j}.

    Differentiable by autograd in every tensor argument (``intensity``
    through the default-leg masses)."""
    lam, lgd, s, v, strikes, weights, r, t = (
        _wide(x) for x in (intensity, lgd, s, v, strikes, weights, r, t))
    c0 = torch.sum(weights * bs_call(s, strikes, r, v, t))
    dt = t / n_grid
    j = torch.arange(1, n_grid + 1, dtype=torch.float64)
    dp = torch.exp(-lam * dt * (j - 1)) * (-torch.expm1(-lam * dt))
    growth = torch.sum(dp * torch.exp(r * (t * j / n_grid)))
    return lgd * c0 * growth


def xva_leg_weights(intensity, own_intensity, t, n_grid: int,
                    dtype=torch.float64):
    """Bilateral default-leg node tables ``(w_cva, w_dva)``, ``(n_grid,)``
    each, first-to-default weighted at the start of each interval:

        w_cva_j = S_B(t_{j-1}) [S_C(t_{j-1}) - S_C(t_j)],
        w_dva_j = S_C(t_{j-1}) [S_B(t_{j-1}) - S_B(t_j)],

    ``S_X(u) = exp(-lambda_X u)``, in the factored ``exp * (-expm1)`` form:
    at ``own_intensity = 0`` ``w_cva`` is :func:`default_leg_weights` bit
    for bit and ``w_dva`` is zero.  The start-of-interval weighting counts
    both parties defaulting in one interval twice, an O(lambda_C lambda_B
    dt^2) bias per node that :func:`xva_multi_closed_form` and the oracle
    share.  Differentiable by autograd in tensor arguments."""
    dt = _as(t, dtype) / n_grid
    j = torch.arange(1, n_grid + 1, dtype=dtype)
    lam_c = _as(intensity, dtype)
    lam_b = _as(own_intensity, dtype)
    surv_prev = torch.exp(-(lam_c + lam_b) * dt * (j - 1))
    return (surv_prev * (-torch.expm1(-lam_c * dt)),
            surv_prev * (-torch.expm1(-lam_b * dt)))


def funding_leg_weights(intensity, own_intensity, funding_spread, t,
                        n_grid: int, dtype=torch.float64) -> torch.Tensor:
    """Funding accrual node table ``w_fnd_j = sf dt S_B(t_{j-1})
    S_C(t_{j-1})``, ``(n_grid,)``: forward-valued, with no discount factor
    (the CVA estimator's undiscounted semantics)."""
    dt = _as(t, dtype) / n_grid
    j = torch.arange(1, n_grid + 1, dtype=dtype)
    lam = _as(intensity, dtype) + _as(own_intensity, dtype)
    return _as(funding_spread, dtype) * dt * torch.exp(-lam * dt * (j - 1))


def xva_leg_weight_derivs(intensity, own_intensity, t, n_grid: int,
                          dtype=torch.float64):
    """``(dw_cva/dlambda_C, dw_dva/dlambda_B, dw_fnd/dspread)``, ``(n_grid,)``
    each: each leg's table differentiated in its own intensity or spread
    only (the cross terms through the joint survival are left out, as in
    ``mctpu``):

        dw_cva_j = S(t_{j-1}) (t_{j-1} expm1(-lambda_C dt)
                               + dt exp(-lambda_C dt)),

    the same with ``lambda_B`` for the DVA leg, and ``dt S(t_{j-1})``."""
    dt = _as(t, dtype) / n_grid
    j = torch.arange(1, n_grid + 1, dtype=dtype)
    lam_c = _as(intensity, dtype)
    lam_b = _as(own_intensity, dtype)
    t_prev = dt * (j - 1)
    surv_prev = torch.exp(-(lam_c + lam_b) * t_prev)
    dwc = surv_prev * (t_prev * torch.expm1(-lam_c * dt)
                       + dt * torch.exp(-lam_c * dt))
    dwd = surv_prev * (t_prev * torch.expm1(-lam_b * dt)
                       + dt * torch.exp(-lam_b * dt))
    return dwc, dwd, dt * surv_prev


def xva_multi_closed_form(intensity, lgd, own_intensity, own_lgd,
                          funding_spread, s, v, strikes, weights, r, t,
                          n_grid: int):
    """Exact xVA legs ``(cva, dva, fca, fba)`` of a single-signed netting
    set in float64.  All-long weights never trip the netting clamp, so
    ``E[EPE_j] = sum_m w_m C_0m e^{r t_j}`` and ``ENE_j = 0`` (DVA = FBA =
    0 exactly); all-short sets mirror onto the ENE side.  Mixed-sign
    weights raise ``ValueError``: the clamp binds path by path.
    Differentiable by autograd in every tensor argument."""
    w_np = np.asarray(weights.detach() if isinstance(weights, torch.Tensor)
                      else weights)
    if (w_np < 0).any() and (w_np > 0).any():
        raise ValueError("closed form requires single-signed weights "
                         "(netting binds otherwise); use the MC engine")
    lgd, own_lgd, s, v, strikes, weights, r, t = (
        _wide(x) for x in (lgd, own_lgd, s, v, strikes, weights, r, t))
    c0 = torch.sum(weights * bs_call(s, strikes, r, v, t))
    t_j = t * torch.arange(1, n_grid + 1, dtype=torch.float64) / n_grid
    growth = torch.exp(r * t_j)
    epe = torch.clamp(c0, min=0.0) * growth
    ene = torch.clamp(-c0, min=0.0) * growth
    w_cva, w_dva = xva_leg_weights(intensity, own_intensity, t, n_grid)
    w_fnd = funding_leg_weights(intensity, own_intensity, funding_spread, t,
                                n_grid)
    return (lgd * torch.sum(w_cva * epe), own_lgd * torch.sum(w_dva * ene),
            torch.sum(w_fnd * epe), torch.sum(w_fnd * ene))


def geometric_asian_call(s, k, r, v, t, n_obs: int) -> torch.Tensor:
    """Exact price of the discretely monitored geometric-average Asian call
    in float64: over ``t_i = i T / m`` the log of the geometric mean is
    normal with mean ``log s + (r - v^2/2) T (m+1) / (2m)`` and variance
    ``v^2 T (m+1)(2m+1) / (6 m^2)``.  Differentiable by autograd in every
    tensor argument."""
    s, k, r, v, t = (_wide(x) for x in (s, k, r, v, t))
    m = n_obs
    mu_g = torch.log(s) + (r - 0.5 * v * v) * t * (m + 1) / (2 * m)
    var_g = v * v * t * (m + 1) * (2 * m + 1) / (6 * m * m)
    sd = torch.sqrt(var_g)
    d1 = (mu_g - torch.log(k) + var_g) / sd
    d2 = d1 - sd
    fwd_g = torch.exp(mu_g + 0.5 * var_g)
    return torch.exp(-r * t) * (fwd_g * norm_cdf(d1) - k * norm_cdf(d2))


def up_and_out_call(s, k, r, v, t, barrier) -> torch.Tensor:
    """Continuously monitored up-and-out call (Reiner-Rubinstein) in
    float64: the vanilla call less the up-and-in call; 0 where ``s`` or
    ``k`` is at or above the barrier.  Differentiable by autograd."""
    s, k, r, v, t, b = (_wide(x) for x in (s, k, r, v, t, barrier))
    sq = v * torch.sqrt(t)
    lam = (r + 0.5 * v * v) / (v * v)
    x = torch.log(s / k) / sq + lam * sq
    x1 = torch.log(s / b) / sq + lam * sq
    y = torch.log(b * b / (s * k)) / sq + lam * sq
    y1 = torch.log(b / s) / sq + lam * sq
    disc = torch.exp(-r * t)
    pow1 = (b / s) ** (2 * lam)
    pow2 = (b / s) ** (2 * lam - 2)
    price = (
        s * (norm_cdf(x) - norm_cdf(x1))
        - k * disc * (norm_cdf(x - sq) - norm_cdf(x1 - sq))
        + s * pow1 * (norm_cdf(-y) - norm_cdf(-y1))
        - k * disc * pow2 * (norm_cdf(-y + sq) - norm_cdf(-y1 + sq))
    )
    zero = torch.zeros_like(price)
    price = torch.where(s >= b, zero, price)
    price = torch.where(k >= b, zero, price)
    return torch.clamp(price, min=0.0)


def barrier_continuity_correction(barrier, s, v, t, n_obs: int,
                                  up: bool = True) -> torch.Tensor:
    """Broadie-Glasserman-Kou effective barrier of a walk monitored at
    ``n_obs`` dates: ``barrier * exp(+-beta v sqrt(T / n_obs))`` with
    ``beta = zeta(1/2) / sqrt(2 pi)``, float64.  ``s`` does not enter;
    it is kept so calls read as ``mctpu.math``'s."""
    del s
    beta = 0.5825971579390106
    dt = _wide(t) / n_obs
    shift = torch.exp((beta if up else -beta) * _wide(v) * torch.sqrt(dt))
    return _wide(barrier) * shift


def lookback_floating_call(s, r, v, t, m=None) -> torch.Tensor:
    """Continuously monitored floating-strike lookback call (Goldman-Sosin-
    Gatto 1979) in float64: pays ``S_T - min_{u<=T} S_u``; ``m`` is the
    running minimum so far (``s`` for a newly written option).  A
    discretely monitored minimum is higher, so the discrete price
    approaches this value from below as ``n_obs`` grows.  Differentiable
    by autograd."""
    s, r, v, t = (_wide(x) for x in (s, r, v, t))
    m = s if m is None else _wide(m)
    sq = v * torch.sqrt(t)
    a1 = (torch.log(s / m) + (r + 0.5 * v * v) * t) / sq
    a2 = a1 - sq
    a3 = (torch.log(s / m) + (-r + 0.5 * v * v) * t) / sq
    q = 2.0 * r / (v * v)
    disc = torch.exp(-r * t)
    return (s * norm_cdf(a1) - m * disc * norm_cdf(a2)
            + s * disc * (1.0 / q)
            * ((s / m) ** (-q) * norm_cdf(-a3)
               - torch.exp(r * t) * norm_cdf(-a1)))


def cliquet_closed_form(r, v, t, n_periods: int, cap, floor) -> torch.Tensor:
    """Exact value of the locally capped and floored cliquet in float64.

    The period gross returns ``R = exp((r - v^2/2) dt + v sqrt(dt) z)`` are
    i.i.d., so the value is ``e^{-rT} n E[clip(R - 1, floor, cap)]`` with
    ``E[clip] = floor + E[(R - (1 + floor))^+] - E[(R - (1 + cap))^+]`` and
    the undiscounted Black expectation ``E[(R - K)^+] = e^{r dt} N(d1) -
    K N(d2)``.  Differentiable by autograd in ``r``, ``v`` and ``t``."""
    r, v, t = (_wide(x) for x in (r, v, t))
    dt = t / n_periods
    sq = v * torch.sqrt(dt)

    def call_on_gross(kk):
        kk = _wide(kk)
        d1 = (-torch.log(kk) + (r + 0.5 * v * v) * dt) / sq
        return torch.exp(r * dt) * norm_cdf(d1) - kk * norm_cdf(d1 - sq)

    e_clip = (_wide(floor) + call_on_gross(1.0 + floor)
              - call_on_gross(1.0 + cap))
    return torch.exp(-r * t) * n_periods * e_clip


def bivariate_norm_cdf(a, b, rho, n_nodes: int = 256) -> torch.Tensor:
    """``P(X <= a, Y <= b)`` for standard bivariate normals of correlation
    ``rho`` in float64: Gauss-Legendre quadrature of ``int_{-8}^a phi(x)
    Phi((b - rho x) / sqrt(1 - rho^2)) dx`` on ``n_nodes`` nodes (about
    1e-9 accurate at 256), as ``mctpu.math``'s.  Differentiable by
    autograd."""
    x_np, w_np = np.polynomial.legendre.leggauss(n_nodes)
    a, b, rho = (_wide(x) for x in (a, b, rho))
    lo = -8.0
    half = (a - lo) / 2.0
    mid = (a + lo) / 2.0
    x = mid + half * _t(x_np)
    w = half * _t(w_np)
    phi = torch.exp(-0.5 * x * x) * 0.3989422804014327
    denom = torch.sqrt(torch.clamp(1.0 - rho * rho, min=1e-12))
    inner = norm_cdf((b - rho * x) / denom)
    return torch.sum(w * phi * inner)


def rainbow_min_call(s1, s2, k, r, v1, v2, rho, t) -> torch.Tensor:
    """European call on the minimum of two correlated GBMs (Stulz 1982) in
    float64: ``S1 M(y1, -d; rho1) + S2 M(y2, d - s sqrt(T); rho2) - K
    e^{-rT} M(y1 - v1 sqrt(T), y2 - v2 sqrt(T); rho)`` with ``s^2 = v1^2 +
    v2^2 - 2 rho v1 v2``.  Differentiable by autograd."""
    s1, s2, k, r, v1, v2, rho, t = (_wide(x) for x in
                                    (s1, s2, k, r, v1, v2, rho, t))
    sq1 = v1 * torch.sqrt(t)
    sq2 = v2 * torch.sqrt(t)
    sig = torch.sqrt(v1 * v1 + v2 * v2 - 2.0 * rho * v1 * v2)
    sqs = sig * torch.sqrt(t)
    d = (torch.log(s1 / s2) + 0.5 * sig * sig * t) / sqs
    y1 = (torch.log(s1 / k) + (r + 0.5 * v1 * v1) * t) / sq1
    y2 = (torch.log(s2 / k) + (r + 0.5 * v2 * v2) * t) / sq2
    rho1 = (rho * v2 - v1) / sig
    rho2 = (rho * v1 - v2) / sig
    m = bivariate_norm_cdf
    return (s1 * m(y1, -d, rho1) + s2 * m(y2, d - sqs, rho2)
            - k * torch.exp(-r * t) * m(y1 - sq1, y2 - sq2, rho))


def rainbow_max_call(s1, s2, k, r, v1, v2, rho, t) -> torch.Tensor:
    """European call on the maximum of two correlated GBMs (Stulz 1982):
    ``C_max = C1 + C2 - C_min``.  Differentiable by autograd."""
    return (bs_call(s1, k, r, v1, t) + bs_call(s2, k, r, v2, t)
            - rainbow_min_call(s1, s2, k, r, v1, v2, rho, t))


def binomial_american(s, k, r, v, t, n_steps: int = 2000,
                      payoff: str = "put") -> float:
    """Cox-Ross-Rubinstein binomial price of an American option, in NumPy
    float64 (``mctpu.reference.binomial_american``): the independent
    lattice oracle of the Longstaff-Schwartz pricers
    (:mod:`mctpu_torch.lsm`); converges O(1/n) to the continuous-exercise
    price, and at ``n_steps`` dates prices the Bermudan."""
    dt = t / n_steps
    u = np.exp(v * np.sqrt(dt))
    d = 1.0 / u
    p = (np.exp(r * dt) - d) / (u - d)
    disc = np.exp(-r * dt)
    j = np.arange(n_steps + 1)
    st = s * u ** (n_steps - j) * d ** j

    def exercise(sv):
        return (np.maximum(k - sv, 0.0) if payoff == "put"
                else np.maximum(sv - k, 0.0))

    values = exercise(st)
    for step in range(n_steps - 1, -1, -1):
        st = st[: step + 1] * d  # spots at this level
        values = disc * (p * values[:-1] + (1 - p) * values[1:])
        values = np.maximum(values, exercise(st))
    return float(values[0])
