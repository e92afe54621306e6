"""Product and result records of the PyTorch/CUDA port.

Counterpart of :mod:`mctpu.types` for the products the port has.  The records
are frozen dataclasses holding Python floats (scalars) and NumPy arrays
(vectors, matrices); the engine turns them into device tensors when it
builds a kernel's operands.  Results hold 0-d float64 tensors on the CPU.

:func:`from_reference` carries a record of the JAX package across by class
and field name, reading every value through ``np.asarray`` — it never
imports jax, so the tests can feed both packages identical inputs.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any

import numpy as np
import torch

__all__ = [
    "Precision",
    "VanillaOption",
    "VanillaBook",
    "BasketOption",
    "BasketAsianOption",
    "BasketBarrierOption",
    "RainbowOption",
    "CvaSpec",
    "CvaPortfolioSpec",
    "CvaMultiSpec",
    "XvaSpec",
    "AsianOption",
    "BarrierOption",
    "BarrierBook",
    "LookbackOption",
    "CliquetOption",
    "HestonOption",
    "AmericanOption",
    "McResult",
    "CvaResult",
    "GreeksResult",
    "HestonGreeksResult",
    "CvaGreeksResult",
    "XvaResult",
    "XvaGreeksResult",
    "AmericanBounds",
    "MlmcLevel",
    "MlmcResult",
    "from_reference",
]


def _equicorr(a: int, rho: float) -> np.ndarray:
    """The ``(a, a)`` correlation matrix with ``rho`` off the diagonal."""
    corr = np.full((a, a), rho)
    np.fill_diagonal(corr, 1.0)
    return corr


class Precision(str, enum.Enum):
    """Accumulation/compute precision policy (see ``mctpu.types.Precision``).

    ``F32`` plain f32 sums; ``F32_KAHAN`` f32 compute with compensated
    per-block sums; ``F32_DS`` adds a double-single (hi, lo) carried walk
    state in the CVA kernel; ``F64`` is not a kernel path in the port.
    """

    F32 = "f32"
    F32_KAHAN = "f32_kahan"
    F32_DS = "f32_ds"
    F64 = "f64"

    @property
    def kahan(self) -> bool:
        return self in (Precision.F32_KAHAN, Precision.F32_DS)

    @property
    def ds(self) -> bool:
        return self is Precision.F32_DS


@dataclasses.dataclass(frozen=True)
class VanillaOption:
    """European call or put under Black-Scholes GBM: spot ``s``, strike
    ``k``, rate ``r``, volatility ``v``, maturity ``t`` (years)."""

    s: float
    k: float
    r: float
    v: float
    t: float
    kind: str = "call"

    def validate(self) -> None:
        if self.kind not in ("call", "put"):
            raise ValueError("kind must be 'call' or 'put'")
        if not (float(self.s) > 0 and float(self.k) > 0):
            raise ValueError("spot and strike must be positive")
        if float(self.v) < 0:
            raise ValueError("volatility must be non-negative")
        if float(self.t) <= 0:
            raise ValueError("time to maturity must be positive")


@dataclasses.dataclass(frozen=True)
class VanillaBook:
    """A book of M independent European calls and puts, priced in one
    sweep on shared draws (:func:`mctpu_torch.engine.price_book`).

    ``s, k, r, v, t`` have shape ``(M,)``; ``kinds`` is a length-M tuple of
    ``"call"``/``"put"``.  Every value is runtime data of the kernel, so a
    market tick reprices through the same compiled library.
    """

    s: Any
    k: Any
    r: Any
    v: Any
    t: Any
    kinds: tuple = ()

    @property
    def n_instruments(self) -> int:
        return int(np.shape(self.s)[0])

    @staticmethod
    def from_options(options) -> "VanillaBook":
        """A book of a sequence of :class:`VanillaOption`."""
        opts = list(options)

        def col(f):
            return np.asarray([float(getattr(o, f)) for o in opts], np.float64)

        return VanillaBook(s=col("s"), k=col("k"), r=col("r"), v=col("v"),
                           t=col("t"), kinds=tuple(o.kind for o in opts))

    @staticmethod
    def serving(m: int = 64, kind: str = "mixed") -> "VanillaBook":
        """The first ``m`` instruments of the 64-instrument serving book
        (``benchmarks/book_rate_r4.py``): s=100, k = 80 + 40 (j mod 5) / 4,
        r=0.05, v = 0.15 + 0.05 (j mod 4), t = 0.5 + 0.5 (j mod 3); calls
        and puts alternate for ``kind="mixed"``, else all are ``kind``."""
        return VanillaBook.from_options([
            VanillaOption(100.0, 80.0 + 40.0 * (j % 5) / 4, 0.05,
                          0.15 + 0.05 * (j % 4), 0.5 + 0.5 * (j % 3),
                          kind=("call", "put")[j % 2] if kind == "mixed"
                          else kind)
            for j in range(m)])

    def option(self, i: int) -> VanillaOption:
        """Instrument ``i`` as a standalone :class:`VanillaOption`."""
        return VanillaOption(*(float(np.asarray(x)[i]) for x in
                               (self.s, self.k, self.r, self.v, self.t)),
                             kind=self.kinds[i])

    def validate(self) -> None:
        m = self.n_instruments
        if m < 1:
            raise ValueError("book must hold at least one instrument")
        for name, x in (("s", self.s), ("k", self.k), ("r", self.r),
                        ("v", self.v), ("t", self.t)):
            if np.shape(x) != (m,):
                raise ValueError(f"{name} must have shape ({m},), "
                                 f"got {np.shape(x)}")
        if len(self.kinds) != m:
            raise ValueError(f"kinds must have {m} entries, "
                             f"got {len(self.kinds)}")
        if any(kd not in ("call", "put") for kd in self.kinds):
            raise ValueError("kinds entries must be 'call' or 'put'")
        s, k, v, t = (np.asarray(x) for x in (self.s, self.k, self.v, self.t))
        if not (np.all(s > 0) and np.all(k > 0)):
            raise ValueError("spots and strikes must be positive")
        if np.any(v < 0):
            raise ValueError("volatilities must be non-negative")
        if np.any(t <= 0):
            raise ValueError("maturities must be positive")


@dataclasses.dataclass(frozen=True)
class BasketOption:
    """European call on a weighted basket of correlated GBM underlyings.

    ``s, v, w, d`` have shape ``(n_assets,)`` and ``corr`` is the
    ``(n_assets, n_assets)`` correlation matrix; the engine factorizes it.
    """

    s: Any
    v: Any
    w: Any
    corr: Any
    d: Any
    k: float
    r: float
    t: float

    @property
    def n_assets(self) -> int:
        return int(np.shape(self.s)[0])

    def validate(self) -> None:
        a = self.n_assets
        for name, x in (("s", self.s), ("v", self.v), ("w", self.w),
                        ("d", self.d)):
            if np.shape(x) != (a,):
                raise ValueError(f"{name} must have shape ({a},), "
                                 f"got {np.shape(x)}")
        if np.shape(self.corr) != (a, a):
            raise ValueError(f"corr must have shape ({a},{a})")
        s, v, corr = (np.asarray(self.s), np.asarray(self.v),
                      np.asarray(self.corr))
        if (s <= 0).any():
            raise ValueError("spot prices must be positive")
        if (v < 0).any():
            raise ValueError("volatilities must be non-negative")
        if not np.allclose(corr, corr.T, atol=1e-6):
            raise ValueError("correlation matrix must be symmetric")
        if not np.allclose(np.diag(corr), 1.0, atol=1e-6):
            raise ValueError("correlation matrix must have unit diagonal")
        if float(self.t) <= 0:
            raise ValueError("time to maturity must be positive")

    @staticmethod
    def equicorrelated(n_assets: int, rho: float = 0.3) -> "BasketOption":
        """Equicorrelation ``rho``, vols alternating 0.3/0.2, equal weights."""
        a = n_assets
        return BasketOption(
            s=np.full((a,), 100.0),
            v=np.where(np.arange(a) % 2 == 0, 0.3, 0.2),
            w=np.full((a,), 1.0 / a),
            corr=_equicorr(a, rho),
            d=np.zeros((a,)),
            k=100.0,
            r=0.048790164,
            t=1.0,
        )

    @staticmethod
    def default_reference(n_assets: int = 3) -> "BasketOption":
        """The reference driver's basket; for ``n_assets != 3`` its
        alternating fallback, whose correlation matrix is indefinite (the
        pivot-guarded Cholesky truncates it, as the reference does)."""
        a = n_assets
        if a == 3:
            v = np.array([0.2, 0.3, 0.2])
            corr = np.array(
                [[1.0, -0.5, -0.5], [-0.5, 1.0, -0.5], [-0.5, -0.5, 1.0]]
            )
        else:
            v = np.where(np.arange(a) % 2 == 0, 0.3, 0.2)
            corr = np.empty((a, a))
            for i in range(a):
                for j in range(i, a):
                    rho = 1.0 if i == j else (0.5 if j % 2 == 0 else -0.5)
                    corr[i, j] = corr[j, i] = rho
        return BasketOption(
            s=np.full((a,), 100.0),
            v=v,
            w=np.full((a,), 1.0 / a),
            corr=corr,
            d=np.zeros((a,)),
            k=100.0,
            r=0.048790164,
            t=1.0,
        )


@dataclasses.dataclass(frozen=True)
class BasketAsianOption:
    """Discretely monitored arithmetic-average call on a correlated basket:
    ``max(mean_j sum_a w_a S_a(t_j) - k, 0)`` over ``n_obs`` equally spaced
    dates (the basket's ``k``, ``r`` and ``t``)."""

    basket: BasketOption
    n_obs: int = 12

    def validate(self) -> None:
        if self.n_obs < 1:
            raise ValueError("n_obs must be >= 1")
        self.basket.validate()


@dataclasses.dataclass(frozen=True)
class BasketBarrierOption:
    """Discretely monitored knock-out call on a correlated basket value:
    ``"up-and-out"`` dies when the basket value ``w @ S`` touches or
    exceeds ``barrier`` at any of the ``n_obs`` dates, ``"down-and-out"``
    when it touches or falls below it."""

    basket: BasketOption
    barrier: float = 130.0
    n_obs: int = 50
    kind: str = "up-and-out"

    def validate(self) -> None:
        if self.kind not in ("up-and-out", "down-and-out"):
            raise ValueError("kind must be 'up-and-out' or 'down-and-out'")
        if self.n_obs < 1:
            raise ValueError("n_obs must be >= 1")
        self.basket.validate()
        if float(self.barrier) <= 0:
            raise ValueError("barrier must be positive")
        b0 = float(np.asarray(self.basket.w) @ np.asarray(self.basket.s))
        if self.kind == "up-and-out" and b0 >= float(self.barrier):
            raise ValueError("up-and-out basket already knocked out")
        if self.kind == "down-and-out" and b0 <= float(self.barrier):
            raise ValueError("down-and-out basket already knocked out")


@dataclasses.dataclass(frozen=True)
class RainbowOption:
    """European call on the maximum (``kind="max"``) or minimum
    (``"min"``) of correlated GBM underlyings: spots ``s`` and vols ``v``
    of shape ``(n_assets,)``, correlation ``corr`` ``(n_assets,
    n_assets)``, strike ``k``, rate ``r``, maturity ``t``.  Two-asset
    prices have the Stulz (1982) closed form
    (:func:`mctpu_torch.math.rainbow_max_call`, ``rainbow_min_call``); at
    ``k = 0`` the max and min calls sum to ``s1 + s2``."""

    s: Any
    v: Any
    corr: Any
    k: float
    r: float
    t: float
    kind: str = "max"

    @property
    def n_assets(self) -> int:
        return int(np.shape(self.s)[0])

    @staticmethod
    def equicorrelated(s, v, rho: float, k: float, r: float, t: float = 1.0,
                       kind: str = "max") -> "RainbowOption":
        """Spots ``s`` and vols ``v`` (one per asset) at equicorrelation
        ``rho``."""
        s = np.asarray(s, np.float64)
        return RainbowOption(s=s, v=np.asarray(v, np.float64),
                             corr=_equicorr(s.shape[0], rho), k=k, r=r, t=t,
                             kind=kind)

    def validate(self) -> None:
        if self.kind not in ("max", "min"):
            raise ValueError("kind must be 'max' or 'min'")
        m = self.n_assets
        if np.shape(self.v) != (m,):
            raise ValueError(f"v must have shape ({m},)")
        if np.shape(self.corr) != (m, m):
            raise ValueError(f"corr must have shape ({m},{m})")
        if (np.asarray(self.s) <= 0).any():
            raise ValueError("spots must be positive")
        if float(self.k) < 0:
            raise ValueError("strike must be non-negative")
        if float(self.t) <= 0:
            raise ValueError("time to maturity must be positive")


@dataclasses.dataclass(frozen=True)
class CvaSpec:
    """CVA of a European call: default ``intensity``, loss given default
    ``lgd``, the ``option`` and the number of exposure-grid steps."""

    intensity: float
    lgd: float
    option: VanillaOption
    n_grid: int = 50

    def validate(self) -> None:
        if self.n_grid < 1:
            raise ValueError("n_grid must be >= 1")
        if self.option.kind != "call":
            raise ValueError("CVA exposure model prices call options")
        self.option.validate()
        if float(self.intensity) < 0:
            raise ValueError("default intensity must be non-negative")
        if not 0.0 <= float(self.lgd) <= 1.0:
            raise ValueError("lgd must lie in [0, 1]")


@dataclasses.dataclass(frozen=True)
class CvaPortfolioSpec:
    """CVA of a netted portfolio of calls on one underlying.

    Exposure at node ``j`` is ``max(sum_m w_m BS(S_j, k_m, T - t_j), 0)``;
    ``wwr_b != 0`` makes the hazard path-dependent (wrong-way risk, see
    ``mctpu.types.CvaPortfolioSpec``).
    """

    intensity: float
    lgd: float
    s: float
    r: float
    v: float
    t: float
    strikes: Any  # (M,)
    weights: Any  # (M,)
    wwr_b: float = 0.0
    n_grid: int = 50

    @property
    def n_options(self) -> int:
        return int(np.shape(self.strikes)[0])

    def validate(self) -> None:
        if self.n_grid < 1:
            raise ValueError("n_grid must be >= 1")
        m = self.n_options
        if np.shape(self.weights) != (m,):
            raise ValueError(f"weights must have shape ({m},)")
        if float(self.s) <= 0:
            raise ValueError("spot must be positive")
        if (np.asarray(self.strikes) <= 0).any():
            raise ValueError("strikes must be positive")
        if float(self.v) < 0:
            raise ValueError("volatility must be non-negative")
        if float(self.t) <= 0:
            raise ValueError("time to maturity must be positive")
        if float(self.intensity) < 0:
            raise ValueError("default intensity must be non-negative")
        if not 0.0 <= float(self.lgd) <= 1.0:
            raise ValueError("lgd must lie in [0, 1]")

    @staticmethod
    def from_single(spec: CvaSpec, wwr_b: float = 0.0) -> "CvaPortfolioSpec":
        o = spec.option
        return CvaPortfolioSpec(
            intensity=spec.intensity, lgd=spec.lgd,
            s=o.s, r=o.r, v=o.v, t=o.t,
            strikes=np.reshape(np.asarray(o.k, np.float64), (1,)),
            weights=np.ones((1,)),
            wwr_b=wwr_b,
            n_grid=spec.n_grid,
        )


@dataclasses.dataclass(frozen=True)
class CvaMultiSpec:
    """CVA of a netting set of calls on ``M`` correlated underlyings.

    Option ``m`` is a call struck at ``strikes[m]`` on underlying ``m``;
    the underlyings follow correlated GBMs (``corr``), and the exposure at
    node ``j`` is the netted positive part ``max(sum_m weights[m] BS(S_m,
    strikes[m], T - t_j), 0)``: short positions offset long ones across
    underlyings.  All-long weights admit an exact closed form
    (:func:`mctpu_torch.math.cva_multi_closed_form`).
    """

    intensity: float
    lgd: float
    s: Any  # (M,) spots
    v: Any  # (M,) vols
    corr: Any  # (M, M)
    r: float
    t: float
    strikes: Any  # (M,)
    weights: Any  # (M,)
    n_grid: int = 50

    @property
    def n_underlyings(self) -> int:
        return len(self.s)

    def validate(self) -> None:
        m = self.n_underlyings
        for name, x in (("v", self.v), ("strikes", self.strikes),
                        ("weights", self.weights)):
            if np.shape(x) != (m,):
                raise ValueError(f"{name} must have shape ({m},)")
        if np.shape(self.corr) != (m, m):
            raise ValueError(f"corr must have shape ({m},{m})")
        if self.n_grid < 1:
            raise ValueError("n_grid must be >= 1")
        if (np.asarray(self.s) <= 0).any():
            raise ValueError("spots must be positive")
        if (np.asarray(self.strikes) <= 0).any():
            raise ValueError("strikes must be positive")
        if float(self.intensity) < 0:
            raise ValueError("default intensity must be non-negative")
        if not 0.0 <= float(self.lgd) <= 1.0:
            raise ValueError("lgd must lie in [0, 1]")


@dataclasses.dataclass(frozen=True)
class XvaSpec:
    """Bilateral xVA of a netting set: the :class:`CvaMultiSpec`
    ``netting`` (the counterparty's hazard ``netting.intensity`` and
    ``netting.lgd``) plus the bank's own ``own_intensity`` and ``own_lgd``,
    which drive the DVA leg on the negative exposure side, and the funding
    ``funding_spread`` (continuously accrued, per year) of the FCA and FBA
    legs.  At ``own_intensity = 0`` and ``funding_spread = 0`` the CVA leg
    is :func:`mctpu_torch.price_cva_multi`'s on the same streams."""

    netting: CvaMultiSpec
    own_intensity: Any = 0.0
    own_lgd: Any = 0.6
    funding_spread: Any = 0.0

    def validate(self) -> None:
        self.netting.validate()
        if float(self.own_intensity) < 0:
            raise ValueError("own default intensity must be non-negative")
        if not 0.0 <= float(self.own_lgd) <= 1.0:
            raise ValueError("own_lgd must lie in [0, 1]")
        if float(self.funding_spread) < 0:
            raise ValueError("funding_spread must be non-negative")


@dataclasses.dataclass(frozen=True)
class AsianOption:
    """Discretely monitored average-price (Asian) call: the average runs
    over ``n_obs`` equally spaced dates ``t_i = i T / n_obs`` (i = 1..n_obs),
    ``average`` is ``"arithmetic"`` or ``"geometric"`` (the geometric one
    has the exact closed form :func:`mctpu_torch.math.geometric_asian_call`).
    """

    s: float
    k: float
    r: float
    v: float
    t: float
    n_obs: int = 50
    average: str = "arithmetic"

    def validate(self) -> None:
        if self.average not in ("arithmetic", "geometric"):
            raise ValueError("average must be 'arithmetic' or 'geometric'")
        if self.n_obs < 1:
            raise ValueError("n_obs must be >= 1")
        if not (float(self.s) > 0 and float(self.k) > 0):
            raise ValueError("spot and strike must be positive")
        if float(self.v) < 0:
            raise ValueError("volatility must be non-negative")
        if float(self.t) <= 0:
            raise ValueError("time to maturity must be positive")


@dataclasses.dataclass(frozen=True)
class BarrierOption:
    """Discretely monitored knock-out barrier call: ``"up-and-out"`` dies
    when the spot touches or exceeds ``barrier`` at any of the ``n_obs``
    dates, ``"down-and-out"`` when it touches or falls below it."""

    s: float
    k: float
    r: float
    v: float
    t: float
    barrier: float
    n_obs: int = 50
    kind: str = "up-and-out"

    def validate(self) -> None:
        if self.kind not in ("up-and-out", "down-and-out"):
            raise ValueError("kind must be 'up-and-out' or 'down-and-out'")
        if self.n_obs < 1:
            raise ValueError("n_obs must be >= 1")
        if not (float(self.s) > 0 and float(self.k) > 0):
            raise ValueError("spot and strike must be positive")
        if float(self.barrier) <= 0:
            raise ValueError("barrier must be positive")
        if self.kind == "up-and-out" and float(self.s) >= float(self.barrier):
            raise ValueError("up-and-out option is already knocked out "
                             "(spot >= barrier)")
        if self.kind == "down-and-out" and float(self.s) <= float(self.barrier):
            raise ValueError("down-and-out option is already knocked out "
                             "(spot <= barrier)")
        if float(self.v) < 0:
            raise ValueError("volatility must be non-negative")
        if float(self.t) <= 0:
            raise ValueError("time to maturity must be positive")


@dataclasses.dataclass(frozen=True)
class BarrierBook:
    """A book of M knock-out barrier options that share one walk
    (:func:`mctpu_torch.engine.price_barrier_book`).

    ``s, k, r, v, t, barrier`` have shape ``(M,)``; ``kinds`` is a length-M
    tuple of ``"call"``/``"put"`` and ``directions`` one of
    ``"up-and-out"``/``"down-and-out"``; every instrument is watched at the
    same ``n_obs`` dates.  All M instruments step on one shared stream of
    standard normals, each with its own drift and vol, and every value and
    direction is runtime data of the kernel, so a market tick reprices
    through the same compiled library.
    """

    s: Any
    k: Any
    r: Any
    v: Any
    t: Any
    barrier: Any
    n_obs: int = 50
    kinds: tuple = ()
    directions: tuple = ()

    @property
    def n_instruments(self) -> int:
        return int(np.shape(self.s)[0])

    @staticmethod
    def from_options(options) -> "BarrierBook":
        """A book of a sequence of :class:`BarrierOption` (calls, which must
        share ``n_obs``)."""
        opts = list(options)
        n_obs = {o.n_obs for o in opts}
        if len(n_obs) != 1:
            raise ValueError("BarrierBook instruments must share n_obs "
                             f"(got {sorted(n_obs)})")

        def col(f):
            return np.asarray([float(getattr(o, f)) for o in opts], np.float64)

        return BarrierBook(s=col("s"), k=col("k"), r=col("r"), v=col("v"),
                           t=col("t"), barrier=col("barrier"),
                           n_obs=n_obs.pop(), kinds=("call",) * len(opts),
                           directions=tuple(o.kind for o in opts))

    @staticmethod
    def serving(m: int = 32, kind: str = "mixed") -> "BarrierBook":
        """The first ``m`` instruments of the 32-instrument serving book, the
        JAX command line's ``--product barrier-book`` recipe at its defaults
        (``mctpu/cli/exotic.py``): s=100, r=0.05, k = 100 (0.8 + 0.4 (j mod
        5) / 4), v = 0.2 (0.8 + 0.1 (j mod 4)), t = 0.5 + 0.25 (j mod 3),
        n_obs=50; with ``kind="mixed"`` every fourth instrument (j mod 4 =
        3) is a down-and-out put with barrier 60, the rest up-and-out calls
        with barrier 130 (1 + 0.1 (j mod 3)); with ``kind="call"`` all are
        those calls."""
        puts = [kind == "mixed" and j % 4 == 3 for j in range(m)]
        return BarrierBook(
            s=np.full(m, 100.0),
            k=np.asarray([100.0 * (0.8 + 0.4 * (j % 5) / 4)
                          for j in range(m)]),
            r=np.full(m, 0.05),
            v=np.asarray([0.2 * (0.8 + 0.1 * (j % 4)) for j in range(m)]),
            t=np.asarray([1.0 * (0.5 + 0.25 * (j % 3)) for j in range(m)]),
            barrier=np.asarray([0.6 * 100.0 if put
                                else 130.0 * (1.0 + 0.1 * (j % 3))
                                for j, put in enumerate(puts)]),
            n_obs=50,
            kinds=tuple("put" if put else "call" for put in puts),
            directions=tuple("down-and-out" if put else "up-and-out"
                             for put in puts))

    def option(self, i: int) -> BarrierOption:
        """Instrument ``i`` as a standalone :class:`BarrierOption` (calls
        only: the single barrier pricer has no put)."""
        if self.kinds[i] != "call":
            raise ValueError("single BarrierOption is call-only")
        s, k, r, v, t, b = (float(np.asarray(x)[i]) for x in
                            (self.s, self.k, self.r, self.v, self.t,
                             self.barrier))
        return BarrierOption(s, k, r, v, t, barrier=b, n_obs=self.n_obs,
                             kind=self.directions[i])

    def validate(self) -> None:
        m = self.n_instruments
        if m < 1:
            raise ValueError("book must hold at least one instrument")
        if self.n_obs < 1:
            raise ValueError("n_obs must be >= 1")
        for name, x in (("s", self.s), ("k", self.k), ("r", self.r),
                        ("v", self.v), ("t", self.t),
                        ("barrier", self.barrier)):
            if np.shape(x) != (m,):
                raise ValueError(f"{name} must have shape ({m},), "
                                 f"got {np.shape(x)}")
        if len(self.kinds) != m or len(self.directions) != m:
            raise ValueError(f"kinds and directions must have {m} entries")
        if any(kd not in ("call", "put") for kd in self.kinds):
            raise ValueError("kinds entries must be 'call' or 'put'")
        if any(d not in ("up-and-out", "down-and-out")
               for d in self.directions):
            raise ValueError("directions entries must be 'up-and-out' or "
                             "'down-and-out'")
        s, k, v, t, b = (np.asarray(x) for x in
                         (self.s, self.k, self.v, self.t, self.barrier))
        if not (np.all(s > 0) and np.all(k > 0) and np.all(b > 0)):
            raise ValueError("spots, strikes and barriers must be positive")
        if np.any(v < 0):
            raise ValueError("volatilities must be non-negative")
        if np.any(t <= 0):
            raise ValueError("maturities must be positive")
        up = np.asarray([d == "up-and-out" for d in self.directions])
        dead = np.where(up, s >= b, s <= b)
        if np.any(dead):
            raise ValueError("instrument starts knocked out "
                             f"(indices {np.nonzero(dead)[0].tolist()})")


@dataclasses.dataclass(frozen=True)
class LookbackOption:
    """Discretely monitored lookback option on the running extreme of the
    ``n_obs`` dates (and the initial fixing): ``"floating"`` call pays
    ``S_T - min_j S_j`` (put ``max_j S_j - S_T``), ``"fixed"`` call pays
    ``max(max_j S_j - k, 0)`` (put ``max(k - min_j S_j, 0)``).  The
    continuously monitored floating call
    (:func:`mctpu_torch.math.lookback_floating_call`) bounds the discrete
    one from above."""

    s: float
    r: float
    v: float
    t: float
    k: float = 0.0  # strike (fixed kind only)
    n_obs: int = 50
    kind: str = "floating"
    payoff: str = "call"

    def validate(self) -> None:
        if self.kind not in ("floating", "fixed"):
            raise ValueError("kind must be 'floating' or 'fixed'")
        if self.payoff not in ("call", "put"):
            raise ValueError("payoff must be 'call' or 'put'")
        if self.n_obs < 1:
            raise ValueError("n_obs must be >= 1")
        if float(self.s) <= 0:
            raise ValueError("spot must be positive")
        if self.kind == "fixed" and float(self.k) <= 0:
            raise ValueError("fixed-strike lookback needs a positive strike")
        if float(self.v) < 0:
            raise ValueError("volatility must be non-negative")
        if float(self.t) <= 0:
            raise ValueError("time to maturity must be positive")


@dataclasses.dataclass(frozen=True)
class CliquetOption:
    """Locally capped and floored cliquet: pays ``sum_j clip(S_{t_j} /
    S_{t_{j-1}} - 1, floor, cap)`` at maturity over ``n_periods`` equal
    periods.  The period returns are i.i.d. under GBM, so the value has the
    exact closed form :func:`mctpu_torch.math.cliquet_closed_form`; spot
    delta is identically zero."""

    s: float
    r: float
    v: float
    t: float
    n_periods: int = 12
    cap: float = 0.08
    floor: float = 0.0

    def validate(self) -> None:
        if self.n_periods < 1:
            raise ValueError("n_periods must be >= 1")
        if float(self.s) <= 0:
            raise ValueError("spot must be positive")
        if float(self.v) < 0:
            raise ValueError("volatility must be non-negative")
        if float(self.t) <= 0:
            raise ValueError("time to maturity must be positive")
        if float(self.cap) <= float(self.floor):
            raise ValueError("cap must exceed floor")
        if float(self.floor) < -1.0:
            raise ValueError("floor below -100% is meaningless")


@dataclasses.dataclass(frozen=True)
class HestonOption:
    """European call under Heston stochastic volatility: spot ``s``, strike
    ``k``, rate ``r``, maturity ``t``, initial variance ``v0``,
    mean-reversion speed ``kappa``, long-run variance ``theta``, vol-of-vol
    ``xi`` and spot-variance correlation ``rho``.  The characteristic-
    function price (:func:`mctpu_torch.models.heston.cf_call_price`) is its
    oracle."""

    s: Any
    k: Any
    r: Any
    t: Any
    v0: Any
    kappa: Any
    theta: Any
    xi: Any
    rho: Any

    def validate(self) -> None:
        if not (float(self.s) > 0 and float(self.k) > 0):
            raise ValueError("spot and strike must be positive")
        if float(self.t) <= 0:
            raise ValueError("time to maturity must be positive")
        if float(self.v0) < 0 or float(self.theta) < 0:
            raise ValueError("variances must be non-negative")
        if float(self.kappa) < 0 or float(self.xi) < 0:
            raise ValueError("kappa and xi must be non-negative")
        if not -1.0 <= float(self.rho) <= 1.0:
            raise ValueError("rho must lie in [-1, 1]")


@dataclasses.dataclass(frozen=True)
class AmericanOption:
    """American-exercise put or call priced by Longstaff-Schwartz regression
    Monte Carlo (:mod:`mctpu_torch.lsm`): ``n_steps`` exercise dates on a
    uniform grid; ``payoff`` is ``"put"`` or ``"call"`` (without dividends
    the call's value equals the European call's)."""

    s: float
    k: float
    r: float
    v: float
    t: float
    n_steps: int = 50
    payoff: str = "put"

    def validate(self) -> None:
        if self.payoff not in ("put", "call"):
            raise ValueError("payoff must be 'put' or 'call'")
        if self.n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if not (float(self.s) > 0 and float(self.k) > 0):
            raise ValueError("spot and strike must be positive")
        if float(self.v) < 0:
            raise ValueError("volatility must be non-negative")
        if float(self.t) <= 0:
            raise ValueError("time to maturity must be positive")


@dataclasses.dataclass(frozen=True)
class McResult:
    """Monte Carlo estimate: ``price``, ``std_error`` and the 95% half-width
    ``ci`` in discounted units; raw undiscounted ``sum_p``/``sum_p2``; ``n``
    i.i.d. samples (pairs under antithetic) from ``n_paths`` GBM paths."""

    price: torch.Tensor
    ci: torch.Tensor
    std_error: torch.Tensor
    sum_p: torch.Tensor
    sum_p2: torch.Tensor
    n: int = 0
    n_paths: int = 0

    def __repr__(self):
        if self.price.numel() == 1:
            body = f"price={float(self.price):.6f}, ci=±{float(self.ci):.6f}"
        else:  # a vector result (a ladder, a book, a basket's deltas): pairs
            pairs = ", ".join(f"{p:.4f}±{c:.4f}" for p, c in zip(
                self.price.reshape(-1).tolist(), self.ci.reshape(-1).tolist()))
            body = f"prices=[{pairs}]"
        return f"McResult({body}, n={self.n}, n_paths={self.n_paths})"

    def to_dict(self) -> dict:
        """Plain-Python record (JSON-ready) of a scalar result."""
        return {"price": float(self.price), "ci": float(self.ci),
                "std_error": float(self.std_error), "n": int(self.n),
                "n_paths": int(self.n_paths)}


@dataclasses.dataclass(frozen=True)
class CvaResult:
    """CVA (undiscounted mean of per-path default legs, as the reference)
    plus the expected-exposure profile per grid node and the deterministic
    default-leg masses at ``wwr_b = 0``."""

    cva: torch.Tensor
    ci: torch.Tensor
    std_error: torch.Tensor
    expected_exposure: torch.Tensor  # (n_grid,)
    default_leg: torch.Tensor  # (n_grid,)
    n: int = 0
    n_paths: int = 0

    def __repr__(self):
        return (f"CvaResult(cva={float(self.cva):.6f}, "
                f"ci=±{float(self.ci):.6f}, n={self.n}, "
                f"n_paths={self.n_paths})")


def _fmt(r) -> str:
    if r is None:
        return "None"
    if r.price.ndim == 0:
        return f"{float(r.price):.6f}±{float(r.ci):.6f}"
    return np.array2string(r.price.numpy(), precision=4)


@dataclasses.dataclass(frozen=True)
class GreeksResult:
    """Price plus pathwise Greeks, each a full :class:`McResult`.

    ``delta``/``vega``/``gamma`` are per-asset vectors for baskets;
    ``rho``/``theta``/``gamma``/``vanna``/``volga`` are ``None`` where not
    computed.  ``theta`` is d/d(maturity), as :func:`mctpu_torch.math.
    bs_greeks`; ``gamma`` is the mixed pathwise-likelihood-ratio estimator.
    """

    price: McResult
    delta: McResult
    vega: McResult
    rho: Any = None
    theta: Any = None
    gamma: Any = None
    vanna: Any = None  # d2V/ds dv (vanilla)
    volga: Any = None  # d2V/dv2 (vanilla)

    def __repr__(self):
        return (f"GreeksResult(price={_fmt(self.price)}, "
                f"delta={_fmt(self.delta)}, vega={_fmt(self.vega)}, "
                f"rho={_fmt(self.rho)}, theta={_fmt(self.theta)}, "
                f"gamma={_fmt(self.gamma)})")


@dataclasses.dataclass(frozen=True)
class HestonGreeksResult(GreeksResult):
    """Heston Greeks: the :class:`GreeksResult` contract, with ``vega`` the
    initial-variance sensitivity dV/dv0, extended with ``dtheta`` (long-run
    variance), ``dkappa`` (mean reversion) and ``dxi`` (vol-of-vol)."""

    dtheta: Any = None
    dkappa: Any = None
    dxi: Any = None

    def __repr__(self):
        base = super().__repr__()[len("GreeksResult("):-1]
        return (f"HestonGreeksResult({base}, dtheta={_fmt(self.dtheta)}, "
                f"dkappa={_fmt(self.dkappa)}, dxi={_fmt(self.dxi)})")


@dataclasses.dataclass(frozen=True)
class CvaGreeksResult:
    """CVA plus its pathwise sensitivities, each a full :class:`McResult`
    with the CVA's undiscounted-mean semantics: ``credit_delta``
    dCVA/dlambda, ``delta`` dCVA/dS0, ``vega`` dCVA/dv, ``gamma``
    d2CVA/dS0^2, ``credit_gamma`` d2CVA/dlambda^2 and ``cross_gamma``
    d2CVA/dS0 dlambda."""

    cva: McResult
    credit_delta: McResult
    delta: McResult
    vega: McResult
    gamma: Any = None
    credit_gamma: Any = None
    cross_gamma: Any = None

    def __repr__(self):
        return (f"CvaGreeksResult(cva={_fmt(self.cva)}, "
                f"credit_delta={_fmt(self.credit_delta)}, "
                f"delta={_fmt(self.delta)}, vega={_fmt(self.vega)}, "
                f"gamma={_fmt(self.gamma)}, "
                f"credit_gamma={_fmt(self.credit_gamma)}, "
                f"cross_gamma={_fmt(self.cross_gamma)})")


@dataclasses.dataclass(frozen=True)
class XvaResult:
    """Bilateral xVA legs of one sweep, each a full :class:`McResult` with
    the CVA's undiscounted-mean semantics, and both exposure profiles:
    ``epe_profile`` and ``ene_profile`` are ``E[max(+-V_j, 0)]`` per node.
    The legs share their paths, so ``bcva`` and ``fva`` carry
    common-random-number noise only."""

    cva: McResult
    dva: McResult
    fca: McResult
    fba: McResult
    epe_profile: torch.Tensor  # (n_grid,)
    ene_profile: torch.Tensor  # (n_grid,)

    @property
    def bcva(self):
        """Bilateral CVA = CVA - DVA (first-to-default weighted legs)."""
        return self.cva.price - self.dva.price

    @property
    def fva(self):
        """Funding value adjustment = FCA - FBA."""
        return self.fca.price - self.fba.price

    def __repr__(self):
        legs = ", ".join(
            f"{leg}={float(getattr(self, leg).price):.6f}"
            f"±{float(getattr(self, leg).ci):.6f}"
            for leg in ("cva", "dva", "fca", "fba"))
        return (f"XvaResult({legs}, bcva={float(self.bcva):.6f}, "
                f"fva={float(self.fva):.6f})")

    def to_dict(self) -> dict:
        """Plain-Python record (JSON-ready)."""
        d = {leg: getattr(self, leg).to_dict()
             for leg in ("cva", "dva", "fca", "fba")}
        d["bcva"] = float(self.bcva)
        d["fva"] = float(self.fva)
        d["epe_profile"] = np.asarray(self.epe_profile).tolist()
        d["ene_profile"] = np.asarray(self.ene_profile).tolist()
        return d


@dataclasses.dataclass(frozen=True)
class XvaGreeksResult:
    """The xVA legs and their sensitivities from one sweep, each a full
    :class:`McResult` with the CVA's undiscounted-mean semantics: the four
    legs, ``credit_cpty`` dCVA/dlambda_C, ``credit_own`` dDVA/dlambda_B,
    ``funding`` dFVA/dspread (each leg in its own intensity or spread,
    :func:`mctpu_torch.math.xva_leg_weight_derivs`) and the per-underlying
    ``delta`` and ``vega`` vectors of the total XVA = CVA - DVA + FCA -
    FBA."""

    cva: McResult
    dva: McResult
    fca: McResult
    fba: McResult
    credit_cpty: McResult
    credit_own: McResult
    funding: McResult
    delta: McResult  # (M,) d(XVA)/ds0_m
    vega: McResult  # (M,) d(XVA)/dv_m

    def __repr__(self):
        def fmt(r):
            if r.price.ndim:
                return (f"{np.array2string(r.price.numpy(), precision=4)}"
                        f"±{np.array2string(r.ci.numpy(), precision=4)}")
            return f"{float(r.price):.6f}±{float(r.ci):.6f}"

        body = ", ".join(f"{f.name}={fmt(getattr(self, f.name))}"
                         for f in dataclasses.fields(self))
        return f"XvaGreeksResult({body})"

    def to_dict(self) -> dict:
        """Plain-Python record (JSON-ready); the vectors as lists."""
        out = {}
        for f in dataclasses.fields(self):
            r = getattr(self, f.name)
            if r.price.ndim:
                out[f.name] = {"price": r.price.tolist(),
                               "ci": r.ci.tolist(), "n": int(r.n),
                               "n_paths": int(r.n_paths)}
            else:
                out[f.name] = r.to_dict()
        return out


@dataclasses.dataclass(frozen=True)
class AmericanBounds:
    """Two-sided American price bracket: the frozen-rule Longstaff-Schwartz
    lower bound and the regression-martingale dual upper bound, each a
    full :class:`McResult`.  ``gap`` (upper minus lower point estimate) is
    the measured rule-suboptimality bias; ``[lower.price - lower.ci,
    upper.price + upper.ci]`` brackets the true price at the joint
    confidence of the two independent CIs."""

    lower: McResult
    upper: McResult

    @property
    def gap(self) -> float:
        return float(self.upper.price) - float(self.lower.price)

    def __repr__(self):
        return (f"AmericanBounds(lower={float(self.lower.price):.6f}"
                f"±{float(self.lower.ci):.6f}, "
                f"upper={float(self.upper.price):.6f}"
                f"±{float(self.upper.ci):.6f}, gap={self.gap:.6f})")

    def to_dict(self) -> dict:
        return {"lower": self.lower.to_dict(), "upper": self.upper.to_dict(),
                "gap": self.gap}


@dataclasses.dataclass(frozen=True)
class MlmcLevel:
    """Recorded statistics of one multilevel Monte Carlo level."""

    level: int
    n_steps: int
    n_paths: int
    mean: float     # E[P_l - P_{l-1}] (level 0: E[P_0])
    var: float      # Var of the level correction
    cost: float     # fine + coarse steps simulated per path


@dataclasses.dataclass(frozen=True)
class MlmcResult:
    """MLMC estimate: discounted price, 95% CI, and the level table (a
    tuple of :class:`MlmcLevel`)."""

    price: float
    ci: float
    std_error: float
    levels: tuple
    total_path_steps: float

    def validate(self) -> "MlmcResult":
        assert np.isfinite(self.price) and np.isfinite(self.ci)
        return self


_RECORDS = {cls.__name__: cls for cls in
            (VanillaOption, VanillaBook, BasketOption, BasketAsianOption,
             BasketBarrierOption, RainbowOption, CvaSpec,
             CvaPortfolioSpec, CvaMultiSpec, AsianOption, BarrierOption,
             BarrierBook,
             LookbackOption, CliquetOption, HestonOption, AmericanOption,
             XvaSpec, McResult, CvaResult, GreeksResult, HestonGreeksResult,
             CvaGreeksResult, XvaResult, XvaGreeksResult, AmericanBounds,
             MlmcLevel, MlmcResult)}
# Results whose numeric fields the port holds as float64 CPU tensors.
_TENSOR_RECORDS = (McResult, CvaResult, XvaResult)


def _carry(value):
    if value is None:  # a Greek a result does not compute
        return None
    if dataclasses.is_dataclass(value) or isinstance(value, enum.Enum):
        return from_reference(value)
    if isinstance(value, str):
        return value
    if isinstance(value, tuple) and value \
            and all(dataclasses.is_dataclass(x) for x in value):
        return tuple(from_reference(x) for x in value)  # an MLMC level table
    if isinstance(value, tuple) and all(isinstance(x, str) for x in value):
        return tuple(str(x) for x in value)  # a book's kinds, directions
    arr = np.asarray(value, np.float64)
    return float(arr) if arr.ndim == 0 else arr


def from_reference(obj):
    """The port's record equal to a ``mctpu`` record (or ``Precision``).

    Matches by class name and field names; every numeric field is read
    through ``np.asarray`` (scalars become Python floats, vectors float64
    arrays), except the fields the port's record declares ``int``
    (``n_grid``, ``n_obs``, ``n_periods``, ``n_steps``, a result's ``n``),
    which stay ints; strings, and tuples of strings (a book's ``kinds``),
    stay so; a nested record (an :class:`XvaSpec`'s netting set, a
    result's legs, an :class:`AmericanBounds`' bounds, an
    :class:`MlmcResult`'s tuple of levels) comes across the same way.  A result (:class:`McResult`,
    :class:`CvaResult`, :class:`GreeksResult`, :class:`HestonGreeksResult`,
    :class:`CvaGreeksResult`, :class:`XvaResult`,
    :class:`XvaGreeksResult`) comes across with float64 CPU tensors, as the
    port's entry points return it, and ``None`` for a Greek it lacks.
    """
    if isinstance(obj, enum.Enum):
        return Precision(obj.value)
    cls = _RECORDS.get(type(obj).__name__)
    if cls is None:
        raise TypeError(f"no port record for {type(obj).__name__}")
    kwargs = {}
    for f in dataclasses.fields(cls):
        value = getattr(obj, f.name)
        if f.type == "int":
            kwargs[f.name] = int(value)
        elif cls in _TENSOR_RECORDS and not dataclasses.is_dataclass(value):
            kwargs[f.name] = torch.tensor(np.asarray(value, np.float64))
        else:
            kwargs[f.name] = _carry(value)
    return cls(**kwargs)
