"""Heston stochastic volatility: the characteristic-function price and the
per-step constants and QE step of the Monte Carlo walks.

Counterpart of :mod:`mctpu.models.heston`:

    dS = r S dt + sqrt(v) S dW_s
    dv = kappa (theta - v) dt + xi sqrt(v) dW_v,   d<W_s, W_v> = rho dt

:func:`cf_call_price` integrates the two in-the-money probabilities of
Gatheral's "little trap" characteristic function by Gauss-Legendre
quadrature in NumPy complex128: it is an oracle and stays on the CPU.
:func:`step_constants`, :func:`qe_constants` and :func:`qe_step` are torch,
in ``mctpu``'s expression order, so that float32 scalars and steps round as
the JAX kernels' do; they run in whatever dtype they are given, and carry
autograd through tensor-valued fields (:mod:`mctpu_torch.autodiff`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["cf_call_price", "step_constants", "qe_constants", "qe_step",
           "QE_KEYS"]

# The QE constants in the order K27 reads them (mctpu's _QE_KEYS).
QE_KEYS = ("e", "c1", "c2", "r_dt", "k0", "k1", "k2", "k3", "k4", "theta")


@functools.lru_cache(maxsize=8)
def _gauss_legendre(n: int, u_max: float):
    """Nodes and weights of the quadrature over ``[0, u_max]``."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * u_max * (x + 1.0), 0.5 * u_max * w


def _cf_log_spot(u, s0, r, t, v0, kappa, theta, xi, rho):
    """Characteristic function ``E[e^{iu ln S_T}]`` (Gatheral's form)."""
    iu = 1j * u
    alpha = kappa - rho * xi * iu
    d = np.sqrt(alpha * alpha + xi * xi * (iu + u * u))
    g2 = (alpha - d) / (alpha + d)
    edt = np.exp(-d * t)
    cc = (kappa * theta / (xi * xi)) * (
        (alpha - d) * t - 2.0 * np.log((1.0 - g2 * edt) / (1.0 - g2)))
    dd = ((alpha - d) / (xi * xi)) * (1.0 - edt) / (1.0 - g2 * edt)
    return np.exp(cc + dd * v0 + iu * (np.log(s0) + r * t))


def cf_call_price(opt, n_nodes: int = 192, u_max: float = 200.0) -> float:
    """European call under Heston by the P1/P2 probability integrals:
    ``C = S0 P1 - K e^{-rT} P2`` with ``P_j = 1/2 + (1/pi) int_0^inf
    Re[e^{-iu ln K} phi_j(u) / (iu)] du``, ``phi_2 = phi`` and ``phi_1(u) =
    phi(u - i) / phi(-i)``; float64 and complex128 throughout."""
    s0, k, r, t = (float(x) for x in (opt.s, opt.k, opt.r, opt.t))
    v0, kap, th = (float(x) for x in (opt.v0, opt.kappa, opt.theta))
    xi, rho = float(opt.xi), float(opt.rho)
    u, w = _gauss_legendre(n_nodes, u_max)
    lnk = np.log(k)

    def prob(shifted: bool) -> float:
        if shifted:
            phi = (_cf_log_spot(u - 1j, s0, r, t, v0, kap, th, xi, rho)
                   / _cf_log_spot(np.complex128(-1j), s0, r, t, v0, kap, th,
                                  xi, rho))
        else:
            phi = _cf_log_spot(u, s0, r, t, v0, kap, th, xi, rho)
        integrand = np.real(np.exp(-1j * u * lnk) * phi / (1j * u))
        return 0.5 + float(np.sum(w * integrand)) / np.pi

    return s0 * prob(True) - k * np.exp(-r * t) * prob(False)


def _as(x, dtype) -> torch.Tensor:
    """``x`` as a 0-d tensor of ``dtype``; a tensor keeps its graph."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.tensor(float(x), dtype=dtype)


def step_constants(opt, n_steps: int, dtype=torch.float32):
    """``(dt, sqrt(dt))`` of the full-truncation Euler step.  The root of a
    float32 ``dt`` is taken in float64 and rounded once, which is the
    correctly rounded float32 root (as ``jnp.sqrt``)."""
    dt = _as(opt.t, dtype) / n_steps
    return dt, torch.sqrt(dt.double()).to(dtype)


def qe_constants(opt, n_steps: int, dtype=torch.float32) -> dict:
    """The per-step constants of Andersen's (2008) quadratic-exponential
    scheme with the central ``gamma1 = gamma2 = 1/2`` drift weighting, by
    name (:data:`QE_KEYS`), in ``mctpu``'s expression order."""
    kappa, theta, xi, rho, r, t = (
        _as(x, dtype) for x in (opt.kappa, opt.theta, opt.xi, opt.rho, opt.r,
                                opt.t))
    dt = t / n_steps
    e = torch.exp(-kappa * dt)
    g1 = g2 = 0.5
    k_ratio = kappa * rho / xi - 0.5
    one_e = 1.0 - e
    return {
        "e": e,
        "c1": xi * xi * e * one_e / kappa,
        "c2": theta * xi * xi * (one_e * one_e) / (2.0 * kappa),
        "r_dt": r * dt,
        "k0": -rho * kappa * theta * dt / xi,
        "k1": g1 * dt * k_ratio - rho / xi,
        "k2": g2 * dt * k_ratio + rho / xi,
        "k3": g1 * dt * (1.0 - rho * rho),
        "k4": g2 * dt * (1.0 - rho * rho),
        "theta": theta,
    }


def qe_step(x, v, z_v, z_s, c, norm_cdf):
    """One QE step ``(x, v) -> (x', v')`` with ``x = ln(S / S0)``
    (``mctpu.models.heston.qe_step``): the moment-matched quadratic
    ``a (b + z_v)^2`` for ``psi <= 1.5``, else the exponential with its mass
    at zero, drawn through ``u = Phi(z_v)``; the log-spot by the K0..K4
    discretization.  Both branches are formed and one is selected, as in
    ``mctpu``, so that autograd through the step stays finite."""
    m = c["theta"] + (v - c["theta"]) * c["e"]
    s2 = v * c["c1"] + c["c2"]
    inv_m = 1.0 / torch.clamp(m, min=1e-30)
    psi = s2 * inv_m * inv_m
    quad = psi <= 1.5
    two_over = 2.0 / psi
    quad_arg = torch.where(
        quad, torch.clamp(two_over * (two_over - 1.0), min=0.0), 1.0)
    b2 = torch.where(quad, two_over - 1.0 + torch.sqrt(quad_arg), 0.0)
    a = m / (1.0 + b2)
    w = torch.sqrt(b2) + z_v
    v_quad = a * (w * w)
    psip1 = psi + 1.0
    u = torch.clamp(norm_cdf(z_v), 0.0, 1.0 - 1e-7)
    at_zero = u * psip1 <= psi - 1.0
    log_arg = torch.where(at_zero, 1.0,
                          2.0 / torch.clamp(psip1 * (1.0 - u), min=1e-30))
    v_exp = torch.where(at_zero, 0.0,
                        torch.log(log_arg) * (0.5 * m * psip1))
    v_new = torch.where(quad, v_quad, v_exp)
    x_new = (x + c["r_dt"] + c["k0"] + c["k1"] * v + c["k2"] * v_new
             + torch.sqrt(torch.clamp(c["k3"] * v + c["k4"] * v_new,
                                      min=1e-20)) * z_s)
    return x_new, v_new
