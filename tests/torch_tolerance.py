"""Tolerance for per-block Greek partials, laid out as ``(sum x, sum x^2)``
pairs along axis 1.

A Greek's block sum can nearly cancel (vanna near the money, the cross
gamma of a netted portfolio), so a bound relative to it alone fails where
the rounding of its terms does not.  A ``sum x`` column is held to

    |got - want| <= rtol * (|want sum x| + sqrt(n * want sum x^2))

where ``n`` is the units per block: by Cauchy-Schwarz the root bounds
``sum |x|``, so the bound tracks the rounding of the terms.  A ``sum x^2``
column has non-negative terms, so its ``sum |terms|`` is itself: it is held
to ``rtol * want sum x^2``.  Exact zeros (padded basket slots) must stay
exactly zero.  ``rtol`` is one number, or one per pair where the pairs'
outputs are conditioned differently.  The RQMC nets' unfolded Neumaier
quads ``[s, c, s2, c2]`` are compared folded (:func:`assert_quads_close`).
This module imports neither jax nor mctpu.
"""
import numpy as np


def pair_bounds(want, n: int, rtol):
    """Per-element bound of :func:`assert_pairs_close`; ``rtol`` a number
    or one per pair."""
    want = np.asarray(want, np.float64)
    s, s2 = want[:, 0::2], want[:, 1::2]
    rtol = np.broadcast_to(np.asarray(rtol, np.float64), s.shape[1:])
    bound = np.empty_like(want)
    bound[:, 0::2] = rtol * (np.abs(s) + np.sqrt(n * np.abs(s2)))
    bound[:, 1::2] = rtol * np.abs(s2)
    return bound


def assert_pairs_close(got, want, n: int, rtol):
    """Assert the ``(sum x, sum x^2)`` pairs of ``got`` match ``want``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    bound = pair_bounds(want, n, rtol)
    worst = np.unravel_index(np.argmax(err - bound), err.shape)
    assert (err <= bound).all(), (
        f"beyond the scaled bound at {worst}: got {got[worst]!r}, want "
        f"{want[worst]!r}, bound {bound[worst]!r}")


def assert_moments_close(got, want, n: int, rtol):
    """Assert the control variates' ``(sum d, sum d^2, sum cc, sum cc^2,
    sum d cc)`` rows of ``got`` match ``want``.  ``sum d`` and ``sum cc``
    are centered and can sit near 0, so each is held, with its square, by
    the pair bound above; the cross sum by ``rtol * sqrt(sum d^2 * sum
    cc^2)``, its Cauchy-Schwarz bound on ``sum |d cc|``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and got.shape[1] == 5, got.shape
    assert_pairs_close(got[:, :4], want[:, :4], n, rtol)
    err = np.abs(got[:, 4] - want[:, 4])
    bound = rtol * np.sqrt(np.abs(want[:, 1] * want[:, 3]))
    assert (err <= bound).all(), (
        f"sum d cc beyond rtol * sqrt(sum d^2 sum cc^2): got {got[:, 4]!r}, "
        f"want {want[:, 4]!r}, bound {bound!r}")


def fold_quads(quads):
    """The float64 ``(s + c, s2 + c2)`` pairs of unfolded Neumaier quads
    ``[s, c, s2, c2]`` laid out along axis 1 (a NumPy or JAX array, or a
    tensor on any device).  ``s`` and ``c`` each depend on the float32 order
    of a chunk's sum; their sum does not, up to rounding."""
    if hasattr(quads, "detach"):
        quads = quads.detach().cpu().double().numpy()
    q = np.asarray(quads, np.float64)
    out = np.empty((q.shape[0], q.shape[1] // 2))
    out[:, 0::2] = q[:, 0::4] + q[:, 1::4]
    out[:, 1::2] = q[:, 2::4] + q[:, 3::4]
    return out


def assert_quads_close(got, want, rtol, units=None):
    """Assert the folded quads of ``got`` match ``want``: at ``rtol`` each,
    or, given the ``units`` a replicate, by the pair bound above (a Greek's
    sum can cancel)."""
    fg, fw = fold_quads(got), fold_quads(want)
    if units is None:
        np.testing.assert_allclose(fg, fw, rtol=rtol, atol=0)
    else:
        assert_pairs_close(fg, fw, units, rtol)
