"""Sub-plateau root refinement (`refine_root`, VERDICT r04 next #3).

The production solve reproduces the reference's first-order masked
quadrature (`create_grids.py:102-110`): the solved root carries an
O(grid cell) systematic bias vs the continuous quantile. refine_root
re-solves in a +-cell window against a trapezoid/fractional-cell
estimate of the same integrand. The closed-form cross-check: with an
identity-correlation Gaussian copula and per-day forecast vols v, the
portfolio return is N(0, sum_i w_i^2 v_i^2), so the continuous
alpha-quantile is z_alpha * sqrt(sum w_i^2 v_i^2) exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from copula_var.backtest import VaRBacktest, GarchAdapter
from copula_var.copulas.fit import GaussianFit
from copula_var.data import returns as returns_mod
from copula_var.models.fit import GarchFit
from copula_var.ops.special import norm_ppf


def _setup(engine, n_points=100, T=120, refine=False):
    """2-asset GARCH(1,1) backtest with a pinned identity-corr Gaussian
    copula, on a FIXED seed (every call sees identical data). Mild vols
    keep the +-5 box >= 4.5 sigma so truncation is negligible next to
    the discretization error being measured."""
    n_in = 260
    # unit-scale vols: the +-5 box is ~4.5 sigma (negligible truncation)
    # and the root lands in the grid's fine interior, the regime the
    # refinement targets (unconditional var = 0.2/(1-0.1-0.7) = 1.0)
    rets = np.random.default_rng(7).standard_normal((n_in + T, 2))
    data = returns_mod.from_returns(rets, n_insample=n_in)
    fits = [
        GarchFit(1, 1, 0.2, np.array([0.1]), np.array([0.7]), 0.0, 0.0,
                 np.array([0.2, 0.1, 0.7]))
        for _ in range(2)
    ]
    return VaRBacktest(
        data, GarchAdapter(p_max=1, q_max=1), "gaussian",
        num_points=n_points, engine=engine,
        interpret=engine in ("pallas", "sharded_pallas"),
        model_fits_override=fits,
        copula_fit_override=GaussianFit(np.eye(2), 0.0, np.zeros(1)),
        refine_root=refine,
    )


def _analytic(bt, alpha, w=None):
    """Continuous quantile under the REFERENCE's garch-family pairing:
    weights[0] pairs the INNERMOST grid dimension (`integration_algo.py:
    6-20`), and the garch integrand puts asset d on grid dim d
    (`garch_integration_function.py:32` divides grid column d by
    forecasted_vol[d]) — so weights[0] multiplies the LAST ticker. Only
    visible at unequal weights (equal weights are permutation-
    invariant), reproduced faithfully by every engine."""
    z = float(np.asarray(norm_ppf(jnp.asarray(alpha))))
    fv = np.asarray(bt.integration_inputs.forecast_vols)  # (T, 2)
    if w is None:
        w = np.asarray(bt.data.weights)
    ptf_mean = float(np.sum(bt.data.in_sample_mean * w))
    return z * np.sqrt((fv[:, ::-1] ** 2 * w[None, :] ** 2).sum(axis=1)) \
        + ptf_mean


def test_refined_beats_unrefined_10x():
    bt = _setup("xla")
    alpha = 0.05
    truth = _analytic(bt, alpha)
    raw = bt.calc_var(alpha)
    bt_r = _setup("xla", refine=True)
    ref = bt_r.calc_var(alpha)
    err_raw = np.abs(raw - truth)
    err_ref = np.abs(ref - truth)
    # the staircase root's error is bias-dominated (~1.5e-2 at n=100);
    # the second-order re-solve must beat it by >= 10x in the median
    # and never be worse than the plateau bound anywhere
    assert np.median(err_ref) < np.median(err_raw) / 10.0
    assert err_ref.max() < err_raw.max()


def test_refine_pallas_matches_xla():
    bt_x = _setup("xla", refine=True)
    want = bt_x.calc_var(0.05)
    bt_p = _setup("pallas", refine=True)
    got = bt_p.calc_var(0.05)
    assert bt_p.last_solve_dispatches == 2  # fused solve + refine pass
    # both refine against the same trap kernel; the staircase start
    # point may differ by the f32 plateau but the refined re-solve
    # contracts both into the same trap root
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_refine_levels_and_portfolios_consistent():
    bt = _setup("xla", refine=True)
    levels = bt.calc_var_levels((0.01, 0.05))
    one = bt.calc_var(0.01)
    np.testing.assert_allclose(levels[0], one, atol=1e-9)
    wb = np.array([[0.5, 0.5], [0.3, 0.7]])
    ports = bt.calc_var_portfolios(wb, obj_var=0.05)
    np.testing.assert_allclose(ports[0], bt.calc_var(0.05), atol=1e-9)
    # row 1 must track ITS OWN weights' closed-form quantile
    truth = _analytic(bt, 0.05, w=wb[1])
    assert np.median(np.abs(ports[1] - truth)) < 3e-3


def test_refine_sharded_pallas_matches_xla():
    bt_x = _setup("xla", refine=True)
    want = bt_x.calc_var(0.05)
    bt_sp = _setup("sharded_pallas", refine=True)
    got = bt_sp.calc_var(0.05)
    assert bt_sp.last_solve_dispatches == 2
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_refine_sharded_portfolios_match_xla():
    bt_x = _setup("xla", refine=True)
    bt_s = _setup("sharded", refine=True)
    wb = np.array([[0.5, 0.5], [0.3, 0.7]])
    want = bt_x.calc_var_portfolios(wb, obj_var=0.05)
    got = bt_s.calc_var_portfolios(wb, obj_var=0.05)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_trap_sweep_ignores_nan_outside_slab():
    """A NaN cell OUTSIDE the integration slab (e.g. a saturated student
    marginal above the VaR bound) must contribute 0 exactly like the
    staircase where-mask — C * A alone poisoned the whole day (review
    finding r05)."""
    from copula_var.ops.grids import garch_grid
    from copula_var.ops.quadrature import (
        garch_integrals_cached, garch_integrals_trap,
    )

    n = 24
    x, dx = garch_grid(n)
    V = np.exp(-0.5 * (x[:, None] ** 2 + x[None, :] ** 2)) / (2 * np.pi)
    V = np.tile(V[None], (3, 1, 1))
    V[:, :, -2:] = np.nan  # inner-dim top nodes (3.75, 5.0): above any cut
    w = np.array([0.5, 0.5])
    b = np.tile([-100.0, -1.2], (3, 1))
    stair = np.asarray(garch_integrals_cached(
        jnp.asarray(b), jnp.asarray(V), jnp.asarray(x), jnp.asarray(dx),
        jnp.asarray(w)))
    trap = np.asarray(garch_integrals_trap(
        jnp.asarray(b), jnp.asarray(V), jnp.asarray(x), jnp.asarray(w)))
    assert np.all(np.isfinite(stair))
    assert np.all(np.isfinite(trap)), trap
    np.testing.assert_allclose(trap, stair, rtol=0.2)  # same integral family


def test_trap_bisect_nan_keeps_staircase_root():
    """If the trap sweep goes non-finite inside the window, the cell
    keeps its staircase root instead of silently marching to root - h."""
    from copula_var.ops.solvers import trap_bisect

    roots = jnp.asarray([[-1.0, -2.0]])

    def sweep(b):  # second cell always NaN
        mid = b[..., 1]
        return jnp.stack(
            [0.5 * (mid[..., 0] + 2.0), jnp.nan * mid[..., 1]], axis=-1
        )[None][0][None][0][None]  # keep (1, 2)

    def sweep2(b):
        mid = b[..., 1]
        F0 = 0.5 * (mid[..., 0] + 2.0)
        return jnp.stack([F0, jnp.full_like(F0, jnp.nan)], axis=-1)

    out = np.asarray(trap_bisect(sweep2, roots,
                                 jnp.asarray([[0.4]]), 0.5))
    assert abs(out[0, 1] - (-2.0)) < 1e-12  # NaN cell: staircase kept
    assert abs(out[0, 0] - (-1.2)) < 1e-3  # finite cell refined normally


def test_msm_short_b_values_polish():
    """fit_msm with fewer than 3 basin starts must not crash the polish
    (review finding r05: hardcoded top=3 reshape)."""
    from copula_var.models import fit as mfit

    rng = np.random.default_rng(0)
    r = rng.standard_normal(200)
    fit = mfit.fit_msm(r, 2, basin_iter=0, b_values=[5.0, 10.0])
    assert np.isfinite(fit.log_likelihood)
    fit1 = mfit.fit_msm(r, 2, basin_iter=0, b_values=[5.0])
    assert np.isfinite(fit1.log_likelihood)
