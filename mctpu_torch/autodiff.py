"""Monte Carlo Greeks by automatic differentiation and by bump-and-revalue.

Counterpart of :mod:`mctpu.greeks` for the products the port has.  The
engine tier (:func:`mctpu_torch.greeks`, kernels K5-K8, K10, K13) is the
production path; this tier differentiates a float64 estimator with
``torch.autograd`` over normals drawn from an explicit ``torch.Generator``,
and is the oracle for the engine's basket delta.  Pathwise differentiation
is unbiased here because the payoff kinks have measure zero; the barrier's
knock-out is not a kink, so its delta goes by common-random-number bumps of
the engine's pricer (:func:`barrier_delta_crn`).  (The engine's ``greeks``
dispatcher is exported from the package under that name, so this module
is not called ``greeks``.)
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mctpu_torch import engine
from mctpu_torch.math import cholesky_lower, norm_cdf
from mctpu_torch.models import basket as mbasket
from mctpu_torch.models import heston as mheston
from mctpu_torch.types import (AsianOption, BarrierOption, BasketOption,
                               HestonOption, VanillaOption)

__all__ = ["vanilla_greeks", "basket_delta", "asian_greeks",
           "heston_greeks", "barrier_delta_crn", "bump_and_revalue"]

_F64 = torch.float64


def _leaf(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float64), dtype=_F64,
                        requires_grad=True)


def vanilla_greeks(opt: VanillaOption, n_paths: int, gen: torch.Generator,
                   antithetic: bool = True) -> dict:
    """Pathwise Greeks of a European call in float64: price, delta, vega,
    theta (d/d maturity, as :func:`mctpu_torch.math.bs_greeks`) and rho,
    from ``n_paths`` paths (pairs of mirrored paths under antithetic).
    Gamma has no pathwise estimator; use :func:`bump_and_revalue`."""
    if opt.kind != "call":
        raise ValueError("vanilla_greeks prices calls; use put-call parity "
                         "for put Greeks")
    n = n_paths // 2 if antithetic else n_paths
    z = torch.randn(n, generator=gen, dtype=_F64)
    s, k, r, v, t = (_leaf(x) for x in (opt.s, opt.k, opt.r, opt.v, opt.t))
    mu = (r - 0.5 * v * v) * t
    sig = v * torch.sqrt(t)
    pay = torch.clamp(s * torch.exp(mu + sig * z) - k, min=0.0)
    if antithetic:
        pay = 0.5 * (pay + torch.clamp(s * torch.exp(mu - sig * z) - k,
                                       min=0.0))
    price = torch.exp(-r * t) * pay.mean()
    delta, rho, vega, theta = torch.autograd.grad(price, (s, r, v, t))
    return {"price": price.detach(), "delta": delta, "vega": vega,
            "theta": theta, "rho": rho}


def basket_delta(opt: BasketOption, n_paths: int, gen: torch.Generator):
    """``(price, per-asset pathwise delta vector)`` of the basket call in
    float64."""
    a = opt.n_assets
    chol = cholesky_lower(opt.corr)
    z = torch.randn((n_paths, a), generator=gen, dtype=_F64)
    s = _leaf(opt.s)
    v, w, d, k, r, t = (torch.tensor(np.asarray(x, np.float64), dtype=_F64)
                        for x in (opt.v, opt.w, opt.d, opt.k, opt.r, opt.t))
    pay = mbasket.terminal_payoff(s, v, w, d, k, r, t, chol, z)
    price = torch.exp(-r * t) * pay.mean()
    (delta,) = torch.autograd.grad(price, (s,))
    return price.detach(), delta


def asian_greeks(opt: AsianOption, n_paths: int,
                 gen: torch.Generator) -> dict:
    """Pathwise price, delta, vega and rho of the Asian call in float64,
    differentiated through the walk over ``(n_obs, n_paths)`` normals."""
    opt.validate()
    z = torch.randn((opt.n_obs, n_paths), generator=gen, dtype=_F64)
    s, k, r, v, t = (_leaf(x) for x in (opt.s, opt.k, opt.r, opt.v, opt.t))
    geometric = opt.average == "geometric"
    dt = t / opt.n_obs
    drift = (r - 0.5 * v * v) * dt
    vol = v * torch.sqrt(dt)
    spot = s.expand(n_paths)
    acc = torch.zeros(n_paths, dtype=_F64)
    for zj in z:
        spot = spot * torch.exp(drift + vol * zj)
        acc = acc + (torch.log(spot) if geometric else spot)
    avg = torch.exp(acc / opt.n_obs) if geometric else acc / opt.n_obs
    price = torch.exp(-r * t) * torch.clamp(avg - k, min=0.0).mean()
    delta, rho, vega = torch.autograd.grad(price, (s, r, v))
    return {"price": price.detach(), "delta": delta, "vega": vega,
            "rho": rho}


def heston_greeks(opt: HestonOption, n_paths: int, gen: torch.Generator,
                  n_steps: int = 100, scheme: str = "euler") -> dict:
    """Pathwise price, delta, d/d(v0) and d/d(xi) of a Heston call in
    float64, differentiated through the whole walk over ``(n_steps, 2,
    n_paths)`` normals (``mctpu.greeks.heston_greeks``): the Euler scheme
    walks the spot multiplicatively, QE the log-spot with the exact normal
    CDF; QE's branches are selected with ``where``, which keeps autograd
    finite."""
    opt.validate()
    if scheme not in ("euler", "qe"):
        raise ValueError("scheme must be 'euler' or 'qe'")
    z = torch.randn((n_steps, 2, n_paths), generator=gen, dtype=_F64)
    s0, v0, xi = (_leaf(x) for x in (opt.s, opt.v0, opt.xi))
    k, r, t, kappa, theta, rho = (torch.tensor(float(x), dtype=_F64) for x in
                                  (opt.k, opt.r, opt.t, opt.kappa, opt.theta,
                                   opt.rho))
    if scheme == "qe":
        c = mheston.qe_constants(dataclasses.replace(opt, v0=v0, xi=xi),
                                 n_steps, _F64)
        x = torch.zeros(n_paths, dtype=_F64)
        v = v0.expand(n_paths)
        for zj in z:
            x, v = mheston.qe_step(x, v, zj[0], zj[1], c, norm_cdf)
        st = s0 * torch.exp(x)
    else:
        dt = t / n_steps
        sqdt = torch.sqrt(dt)
        rho_s = torch.sqrt(1.0 - rho * rho)
        st, v = s0.expand(n_paths), v0.expand(n_paths)
        for zj in z:
            vp = torch.clamp(v, min=0.0)
            sq_v = torch.sqrt(vp) * sqdt
            z_s = rho * zj[0] + rho_s * zj[1]
            st = st * torch.exp(r * dt - 0.5 * vp * dt + sq_v * z_s)
            v = v + kappa * (theta - vp) * dt + xi * sq_v * zj[0]
    price = torch.exp(-r * t) * torch.clamp(st - k, min=0.0).mean()
    delta, dv0, dxi = torch.autograd.grad(price, (s0, v0, xi))
    return {"price": price.detach(), "delta": delta, "dv0": dv0, "dxi": dxi}


def barrier_delta_crn(opt: BarrierOption, n_paths: int, seed: int,
                      config: engine.EngineConfig = engine.EngineConfig(),
                      eps: float = 0.5) -> float:
    """Barrier-call delta by common-random-number central differences of
    :func:`mctpu_torch.price_barrier` at ``s +- eps``.

    Pathwise differentiation is biased here: the knock-out indicator is
    discontinuous in the spot and its derivative (a surface term)
    differentiates to zero.  The bumped runs draw the same paths (same
    seed and plan), so the Monte Carlo noise cancels to first order."""
    opt.validate()

    def price(s0):
        o = dataclasses.replace(opt, s=float(s0))
        return float(engine.price_barrier(o, n_paths, seed, config).price)

    return bump_and_revalue(price, float(opt.s), eps, order=1)


def bump_and_revalue(price_fn: Callable, x0, eps: float, order: int = 2):
    """Central finite differences with common random numbers.

    ``price_fn(x)`` must be deterministic in ``x`` (fix its seed or
    generator state inside), so the bumped runs reuse the same paths and
    the Monte Carlo noise cancels to first order.  ``order=1`` gives the
    first derivative, ``order=2`` ``(f(x+e) - 2 f(x) + f(x-e)) / e^2``.
    """
    up = price_fn(x0 + eps)
    dn = price_fn(x0 - eps)
    if order == 1:
        return (up - dn) / (2 * eps)
    mid = price_fn(x0)
    return (up - 2 * mid + dn) / (eps * eps)
