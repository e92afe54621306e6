"""American options by two-pass Longstaff-Schwartz regression Monte Carlo
(counterpart of :mod:`mctpu.lsm`).

* Pass 1 (fit): simulate a pilot path set, induct backward over the
  exercise dates and fit the continuation value ``E[V_cont | S]`` on the
  cubic basis of centered moneyness ``y = s / k - 1`` at each date: ridge
  normal equations over the in-the-money paths, solved in float64 with
  ``torch.linalg.solve`` on the device (:func:`fit_exercise_rule`).
* Pass 2 (price): fresh paths forward only under the frozen rule, in O(n)
  memory.  With an ``EngineConfig`` this is K50 (:mod:`mctpu_torch.kernels.
  lsm`), the fixed-order float64 combine and the estimator with discount 1
  (the cashflows are present values); without one, the float64 oracle
  tier, a plain torch walk.

The rule is fitted on paths independent of the priced ones, so the price
is a genuine low-biased bound; :func:`price_american_bounds` adds the
Rogers / Haugh-Kogan dual upper bound from the same regression, and
:func:`price_american_heston` prices under Heston dynamics with the
variance in the basis.

Seeds: the public functions take an int32 ``seed``.  ``mctpu`` derives its
fit and pricing keys by Threefry, ``split(fold_in(key, 0x15A1))``; the port
draws the pilot from a CPU generator keyed by the murmur3 fold of ``(seed,
0x15A1)`` (:data:`FIT_WORD`), independent of the pricing stream and the
same on every device, and runs K50 on ``seed`` itself.  So the engine
tier's price at ``seed = key_to_seed(k_price)`` draws ``mctpu``'s pricing
stream and differs from ``mctpu``'s only in the pilot's draws, through the
rule they fit.  The oracle tier, the dual pass (:data:`DUAL_WORD`) and the
Heston American (:data:`HESTON_WORD`) draw every normal from such
generators, never from the global RNG, so their prices differ from
``mctpu``'s at a key in all their draws; they run on the ``device`` given
(``"cuda"`` unless the caller asks for the CPU).  Imports neither jax nor
mctpu.
"""
from __future__ import annotations

import dataclasses

import torch

from mctpu_torch import estimator as mcest
from mctpu_torch import math as mcmath
from mctpu_torch.engine import EngineConfig, american_setup
from mctpu_torch.kernels import lsm as klsm
from mctpu_torch.kernels.common import seed_key
from mctpu_torch.models import heston as mheston
from mctpu_torch.rng import wrap_int32
from mctpu_torch.types import (AmericanBounds, AmericanOption, HestonOption,
                               McResult)

__all__ = ["price_american", "price_american_bounds",
           "price_american_heston", "fit_exercise_rule", "AmericanBounds",
           "FIT_WORD", "DUAL_WORD", "HESTON_WORD"]

# The words mctpu folds into its key (mctpu/lsm.py, fold_in(key, ...)): the
# rule fit, the dual pass, the Heston American.
FIT_WORD = 0x15A1
DUAL_WORD = 0xD0A1
HESTON_WORD = 0x4E57

_BASIS = klsm.BASIS  # 1, y, y^2, y^3
_HBASIS = 6  # 1, y, y^2, y^3, v, y v (moneyness x variance cross term)
_RIDGE = 1e-6


def _generator(*words) -> torch.Generator:
    """A CPU generator keyed by the murmur3 fold of the int32 ``words``
    (the kernels' ``seed_key``); its draws are the same on every device."""
    k0, k1 = seed_key(*(wrap_int32(w) for w in words))
    return torch.Generator().manual_seed((k0 << 32) | k1)


def _normal(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """Standard normals drawn in float64 on the CPU from ``gen``."""
    z = torch.randn(shape, generator=gen, dtype=torch.float64)
    return z.to(device=device, dtype=dtype)


def _device(device) -> torch.device:
    """``device`` checked as an :class:`EngineConfig`'s is."""
    return EngineConfig(device=str(device)).torch_device()


def _scalars(dtype, device, *xs):
    return tuple(torch.tensor(float(x), dtype=dtype, device=device)
                 for x in xs)


def _payoff(kind: str, s, k):
    return torch.clamp(k - s if kind == "put" else s - k, min=0.0)


def _basis(s, k):
    """Cubic basis in centered moneyness ``y = s/k - 1``: ``(..., 4)``.
    Centering keeps the normal equations well conditioned over the bulk of
    the spot distribution."""
    y = s / k - 1.0
    return torch.stack([torch.ones_like(y), y, y * y, y * y * y], dim=-1)


def _hbasis(s, k, v):
    y = s / k - 1.0
    return torch.stack([torch.ones_like(y), y, y * y, y * y * y, v, y * v],
                       dim=-1)


def _regress(x, ev, cf):
    """The ridge regression of the in-the-money cashflows on the basis
    ``x``, then LSM's update of the cashflows: ``(cf', beta)``."""
    itm = ev > 0
    w = itm.to(x.dtype)
    xw = x * w[:, None]
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    a = xw.T @ x + _RIDGE * eye
    b = xw.T @ (w * cf)
    beta = torch.linalg.solve(a, b)
    cf = torch.where(itm & (ev > x @ beta), ev, cf)
    return cf, beta


def _fit_rule(s0, k, r, v, t, z: torch.Tensor, kind: str) -> torch.Tensor:
    """Backward induction on the pilot normals ``z`` ``(n_steps, n_pilot)``
    in their dtype and on their device: ``beta`` ``(n_steps - 1, 4)``, row
    ``j`` the regression at date ``t_{j+1}`` (no decision at maturity)."""
    n_steps = z.shape[0]
    s0, k, r, v, t = _scalars(z.dtype, z.device, s0, k, r, v, t)
    dt = t / n_steps
    drift = (r - 0.5 * v * v) * dt
    vol = v * torch.sqrt(dt)
    disc = torch.exp(-r * dt)
    spots = torch.empty_like(z)
    s = s0.expand(z.shape[1])
    for j in range(n_steps):  # the pilot walk, mctpu's scan
        s = s * torch.exp(drift + vol * z[j])
        spots[j] = s
    cf = _payoff(kind, spots[-1], k)  # valued at its exercise date
    betas = torch.empty((n_steps - 1, _BASIS), dtype=z.dtype, device=z.device)
    for j in range(n_steps - 2, -1, -1):
        s_t = spots[j]
        cf, betas[j] = _regress(_basis(s_t, k), _payoff(kind, s_t, k),
                                cf * disc)
    return betas


def fit_exercise_rule(s0, k, r, v, t, seed: int, n_pilot: int, n_steps: int,
                      kind: str, dtype=torch.float64, device="cuda"):
    """Fit the per-date continuation regressions on ``n_pilot`` pilot paths
    whose normals come from ``seed`` folded with :data:`FIT_WORD`.
    Returns ``beta`` ``(n_steps - 1, 4)`` on ``device``: row ``j`` is the
    regression for exercise date ``t_{j+1}``.  Standard LSM backward
    induction with ridge-regularized normal equations (stable when few
    pilot paths are in the money)."""
    z = _normal(_generator(seed, FIT_WORD), (n_steps, n_pilot), dtype,
                _device(device))
    return _fit_rule(s0, k, r, v, t, z, kind)


def _estimate(cf, n_paths: int):
    """``(mean, se, sum_p, sum_p2)`` of the per-path values ``cf`` in their
    dtype, as float64 CPU tensors."""
    n = torch.tensor(float(n_paths), dtype=cf.dtype, device=cf.device)
    sum_p = torch.sum(cf)
    sum_p2 = torch.sum(cf * cf)
    mean = sum_p / n
    var = torch.clamp(n * sum_p2 - sum_p * sum_p, min=0.0) / (n * (n - 1.0))
    se = torch.sqrt(var) / torch.sqrt(n)
    return tuple(x.double().cpu() for x in (mean, se, sum_p, sum_p2))


def _result(stats, n: int, n_paths: int) -> McResult:
    mean, se, sum_p, sum_p2 = stats
    return McResult(price=mean, ci=1.96 * se, std_error=se, sum_p=sum_p,
                    sum_p2=sum_p2, n=n, n_paths=n_paths)


def _price_forward(opt: AmericanOption, beta, seed: int, n_paths: int,
                   antithetic: bool, dtype) -> McResult:
    """The oracle tier: a plain forward walk under the frozen rule in
    ``dtype`` on ``beta``'s device, O(n_paths) memory, normals drawn per
    step from the generator of ``seed``; the antithetic mirror rides a
    leading axis and the pair mean is the i.i.d. unit."""
    dev = beta.device
    n = opt.n_steps
    beta = beta.to(dtype)
    s0, k, r, v, t = _scalars(dtype, dev, opt.s, opt.k, opt.r, opt.v, opt.t)
    dt = t / n
    drift = (r - 0.5 * v * v) * dt
    vol = v * torch.sqrt(dt)
    n_var = 2 if antithetic else 1
    sgn = torch.tensor([1.0, -1.0], dtype=dtype, device=dev)[:n_var, None]
    gen = _generator(seed)
    s = s0.expand(n_var, n_paths)
    cf = torch.zeros((n_var, n_paths), dtype=dtype, device=dev)
    alive = torch.ones((n_var, n_paths), dtype=torch.bool, device=dev)
    for j in range(n):
        z = _normal(gen, (n_paths,), dtype, dev)
        s = s * torch.exp(drift + vol * (sgn * z))
        df = torch.exp(-r * dt * (j + 1))  # discount to t = 0
        pay = _payoff(opt.payoff, s, k)
        if j < n - 1:
            ex = alive & (pay > 0) & (pay > _basis(s, k) @ beta[j])
        else:
            ex = alive
        cf = torch.where(ex, cf + df * pay, cf)
        alive = alive & ~ex
    return _result(_estimate(torch.mean(cf, dim=0), n_paths), n_paths,
                   n_paths * n_var)


def _price_forward_engine(opt: AmericanOption, beta, seed: int,
                          n_paths: int, config: EngineConfig,
                          antithetic: bool) -> McResult:
    """The engine tier: K50 under the frozen rule ``beta`` on ``seed``'s
    stream at ``antithetic``, the fixed-order float64 combine, the
    estimator with discount 1 (K50 sums present-value cashflows)."""
    cfg = (dataclasses.replace(config, antithetic=antithetic)
           if config.antithetic != antithetic else config)
    plan, ops = american_setup(opt, beta, n_paths, cfg)
    partials = klsm.partials(ops, wrap_int32(seed), 0, plan, plan.num_blocks,
                             opt.payoff == "put")
    sum_p, sum_p2 = mcest.combine_block_partials(partials)
    return mcest.estimate(sum_p, sum_p2, plan.total_units, discount=1.0,
                          n_paths=plan.total_paths)


def _fit_for(opt: AmericanOption, n_paths: int, seed: int, pilot_paths,
             dtype, device):
    if pilot_paths is None:
        pilot_paths = min(n_paths, 1 << 15)
    return fit_exercise_rule(opt.s, opt.k, opt.r, opt.v, opt.t, seed,
                             pilot_paths, opt.n_steps, opt.payoff,
                             dtype=dtype or torch.float64, device=device)


def price_american(opt: AmericanOption, n_paths: int, seed: int,
                   antithetic: bool = True, pilot_paths: int | None = None,
                   dtype=None, config: EngineConfig | None = None,
                   device="cuda") -> McResult:
    """Two-pass Longstaff-Schwartz price of an American put or call.

    ``n_paths`` fresh pricing paths (per antithetic leg; the pair mean is
    the i.i.d. unit); ``pilot_paths`` (default ``min(n_paths, 2^15)``)
    sizes the rule-fitting set; ``dtype`` (default float64) is the fit's
    and the oracle tier's.  With ``config`` the pricing pass is K50 on the
    config's device (the engine tier, per-block partials, fixed-order
    combine); without it, the oracle tier's float64 walk on ``device``.
    The result carries the honest sums of the discounted cashflows
    (discount 1) and the sampling CI under the frozen rule.
    """
    opt.validate()
    dev = config.torch_device() if config is not None else _device(device)
    beta = _fit_for(opt, n_paths, seed, pilot_paths, dtype, dev)
    if config is not None:
        return _price_forward_engine(opt, beta, seed, n_paths, config,
                                     antithetic)
    return _price_forward(opt, beta, seed, n_paths, antithetic,
                          dtype or torch.float64)


# ---------------------------------------------------------------------------
# Duality: a martingale upper bound bracketing the LSM lower bound
# ---------------------------------------------------------------------------
# For any martingale M with M_0 = 0, V_0 <= E[max_j (e^{-r t_j} h(S_j) -
# M_j)] (Rogers 2002, Haugh-Kogan 2004).  M is built from the fitted
# regression's value function Vhat_j(s) = e^{-r t_j} max(h, European,
# 1{ITM} max(Chat_j, 0)) with n_sub fresh antithetic one-step inner
# samples per node; the inner samples come from the exact one-step GBM
# transition, so E[dM_j | F_{j-1}] = 0 exactly and the bound stays valid
# (Andersen-Broadie 2004).

def _european(kind: str, s, k, r, v, t):
    """The Black-Scholes call (intrinsic value at ``t -> 0``), or the put
    by parity, on ``s``'s device and in its dtype."""
    call = mcmath.bs_call(s, k, r, v, t).to(s.dtype)
    return call - s + k * torch.exp(-r * t) if kind == "put" else call


def _dual_upper(opt: AmericanOption, beta, seed: int, n_paths: int,
                n_sub: int, dtype) -> McResult:
    """The dual (martingale) upper-bound pass on ``beta``'s device, normals
    from ``seed`` folded with :data:`DUAL_WORD`; per step one ``(n_sub / 2,
    n_paths)`` inner tile evaluates the value function at antithetic
    one-step exits."""
    dev = beta.device
    n, kind = opt.n_steps, opt.payoff
    beta = beta.to(dtype)
    s0, k, r, v, t = _scalars(dtype, dev, opt.s, opt.k, opt.r, opt.v, opt.t)
    dt = t / n
    drift = (r - 0.5 * v * v) * dt
    vol = v * torch.sqrt(dt)
    half = max(n_sub // 2, 1)
    gen = _generator(seed, DUAL_WORD)

    def vhat(j, s):
        """Discounted approximate value at date ``j + 1``: the regression
        is pure extrapolation out of the money, where the exact European
        value (a lower bound on the American) takes over."""
        df = torch.exp(-r * dt * (j + 1))
        h = _payoff(kind, s, k)
        if j == n - 1:
            return df * h
        tau = torch.clamp(t - dt * (j + 1), min=0.0)
        c = torch.where(h > 0.0,
                        torch.clamp(_basis(s, k) @ beta[j], min=0.0), 0.0)
        e = _european(kind, s, k, r, v, tau)
        return df * torch.maximum(h, torch.maximum(e, c))

    s = s0.expand(n_paths)
    m = torch.zeros(n_paths, dtype=dtype, device=dev)
    best = _payoff(kind, s0, k).expand(n_paths)
    for j in range(n):
        z = _normal(gen, (n_paths,), dtype, dev)
        zi = _normal(gen, (half, n_paths), dtype, dev)
        s_new = s * torch.exp(drift + vol * z)
        v_up = vhat(j, s[None, :] * torch.exp(drift + vol * zi))
        v_dn = vhat(j, s[None, :] * torch.exp(drift - vol * zi))
        cond_exp = 0.5 * (torch.mean(v_up, dim=0) + torch.mean(v_dn, dim=0))
        m = m + vhat(j, s_new) - cond_exp
        df = torch.exp(-r * dt * (j + 1))
        best = torch.maximum(best, df * _payoff(kind, s_new, k) - m)
        s = s_new
    return _result(_estimate(best, n_paths), n_paths, n_paths)


def price_american_bounds(opt: AmericanOption, n_paths: int, seed: int,
                          n_sub: int = 64, antithetic: bool = True,
                          pilot_paths: int | None = None, dtype=None,
                          config: EngineConfig | None = None,
                          device="cuda") -> AmericanBounds:
    """Two-sided American price: the LSM lower bound (:func:`price_american`
    bit for bit, the engine tier with ``config``) and the duality upper
    bound from the same fitted rule, ``n_sub`` antithetic one-step inner
    samples per node, on ``max(min(n_paths / 4, 2^14), 2^10)`` outer paths
    independent of both the pilot and the lower pass.  Typical gap on the
    50-date at-the-money put: about 0.2% of the price at ``n_sub = 64``."""
    opt.validate()
    dtype = dtype or torch.float64
    dev = config.torch_device() if config is not None else _device(device)
    beta = _fit_for(opt, n_paths, seed, pilot_paths, dtype, dev)
    if config is not None:
        lower = _price_forward_engine(opt, beta, seed, n_paths, config,
                                      antithetic)
    else:
        lower = _price_forward(opt, beta, seed, n_paths, antithetic, dtype)
    # The dual pass needs far fewer outer paths: its variance comes from
    # the max statistic, and each path costs n_sub value evaluations a step.
    n_dual = max(min(n_paths // 4, 1 << 14), 1 << 10)
    upper = _dual_upper(opt, beta, seed, n_dual, n_sub, dtype)
    return AmericanBounds(lower=lower, upper=upper)


# ---------------------------------------------------------------------------
# American options under Heston stochastic volatility
# ---------------------------------------------------------------------------

class _HestonWalk:
    """One step of the Heston walk in ``dtype`` on ``device``: QE on the
    log-spot ``x = ln(S / S0)`` (:func:`mctpu_torch.models.heston.qe_step`)
    or full-truncation Euler on the spot; :meth:`spot` maps the state to
    ``S``."""

    def __init__(self, opt: HestonOption, n_steps: int, scheme: str, dtype,
                 device):
        self.qe = scheme == "qe"
        self.s0, self.r, self.t, self.kappa, self.theta, self.xi, rho = (
            _scalars(dtype, device, opt.s, opt.r, opt.t, opt.kappa,
                     opt.theta, opt.xi, opt.rho))
        if self.qe:
            self.c = {name: x.to(device) for name, x in
                      mheston.qe_constants(opt, n_steps, dtype).items()}
        else:
            self.dt = self.t / n_steps
            self.sqdt = torch.sqrt(self.dt)
            self.rho_c, self.rho_s = rho, torch.sqrt(1.0 - rho * rho)

    def init(self, n_paths: int):
        return (torch.zeros(n_paths, dtype=self.s0.dtype,
                            device=self.s0.device)
                if self.qe else self.s0.expand(n_paths))

    def step(self, state, var, zj):
        if self.qe:
            return mheston.qe_step(state, var, zj[0], zj[1], self.c,
                                   mcmath.norm_cdf)
        vp = torch.clamp(var, min=0.0)
        sq_v = torch.sqrt(vp) * self.sqdt
        z_s = self.rho_c * zj[0] + self.rho_s * zj[1]
        s = state * torch.exp(self.r * self.dt - 0.5 * vp * self.dt
                              + sq_v * z_s)
        var = var + self.kappa * (self.theta - vp) * self.dt \
            + self.xi * sq_v * zj[0]
        return s, var

    def spot(self, state):
        return self.s0 * torch.exp(state) if self.qe else state


def _heston_paths(walk: _HestonWalk, z: torch.Tensor, v0):
    """``(spots, variances)`` at steps 1..n, each ``(n_steps, n_paths)``,
    from the normals ``z`` ``(n_steps, 2, n_paths)``."""
    state = walk.init(z.shape[2])
    var = torch.full((z.shape[2],), float(v0), dtype=z.dtype,
                     device=z.device)
    spots, variances = torch.empty_like(z[:, 0]), torch.empty_like(z[:, 0])
    for j in range(z.shape[0]):
        state, var = walk.step(state, var, z[j])
        spots[j], variances[j] = walk.spot(state), var
    return spots, variances


def _fit_heston_rule(opt: HestonOption, walk: _HestonWalk, z: torch.Tensor,
                     kind: str) -> torch.Tensor:
    """LSM backward induction on the pilot normals ``z`` with the Heston
    basis ``(1, y, y^2, y^3, v, y v)``: ``(n_steps - 1, 6)``."""
    n_steps = z.shape[0]
    spots, variances = _heston_paths(walk, z, opt.v0)
    k, = _scalars(z.dtype, z.device, opt.k)
    disc = torch.exp(-walk.r * walk.t / n_steps)
    cf = _payoff(kind, spots[-1], k)
    betas = torch.empty((n_steps - 1, _HBASIS), dtype=z.dtype,
                        device=z.device)
    for j in range(n_steps - 2, -1, -1):
        s_t = spots[j]
        cf, betas[j] = _regress(_hbasis(s_t, k, variances[j]),
                                _payoff(kind, s_t, k), cf * disc)
    return betas


def _price_heston_forward(opt: HestonOption, walk: _HestonWalk, beta,
                          gen: torch.Generator, n_paths: int, n_steps: int,
                          kind: str) -> McResult:
    """Forward-only pricing under the frozen rule, normals drawn per step
    from ``gen``; O(n_paths) memory."""
    dtype, dev = beta.dtype, beta.device
    k, = _scalars(dtype, dev, opt.k)
    dt = walk.t / n_steps
    state = walk.init(n_paths)
    var = torch.full((n_paths,), float(opt.v0), dtype=dtype, device=dev)
    cf = torch.zeros(n_paths, dtype=dtype, device=dev)
    alive = torch.ones(n_paths, dtype=torch.bool, device=dev)
    for j in range(n_steps):
        state, var = walk.step(state, var,
                               _normal(gen, (2, n_paths), dtype, dev))
        s = walk.spot(state)
        df = torch.exp(-walk.r * dt * (j + 1))
        pay = _payoff(kind, s, k)
        if j < n_steps - 1:
            ex = alive & (pay > 0) & (pay > _hbasis(s, k, var) @ beta[j])
        else:
            ex = alive
        cf = torch.where(ex, cf + df * pay, cf)
        alive = alive & ~ex
    return _result(_estimate(cf, n_paths), n_paths, n_paths)


def price_american_heston(opt: HestonOption, n_paths: int, seed: int,
                          n_steps: int = 50, scheme: str = "qe",
                          pilot_paths: int | None = None,
                          payoff: str = "put", dtype=None,
                          device="cuda") -> McResult:
    """Two-pass Longstaff-Schwartz American option under Heston dynamics
    (QE or Euler), plain torch on ``device``.  The regression basis adds
    the variance state (``1, y, y^2, y^3, v, y v``) so the exercise rule
    responds to the vol level; the rule is fitted on a pilot set and the
    price is an out-of-sample lower bound with an honest CI, as
    :func:`price_american`.  Every normal comes from ``seed`` folded with
    :data:`HESTON_WORD`: first the pilot's, then the pricing walk's."""
    opt.validate()
    dtype = dtype or torch.float64
    dev = _device(device)
    if pilot_paths is None:
        pilot_paths = min(n_paths, 1 << 15)
    gen = _generator(seed, HESTON_WORD)
    walk = _HestonWalk(opt, n_steps, scheme, dtype, dev)
    z = _normal(gen, (n_steps, 2, pilot_paths), dtype, dev)
    beta = _fit_heston_rule(opt, walk, z, payoff)
    return _price_heston_forward(opt, walk, beta, gen, n_paths, n_steps,
                                 payoff)
