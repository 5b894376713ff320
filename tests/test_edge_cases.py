"""Edge-case hardening: NaN-day propagation, weight-sign semantics,
undersized grids, and artifacts round-trip through the Pallas engine.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from copula_var.backtest import MsmAdapter, VaRBacktest
from copula_var.copulas.fit import StudentFit
from copula_var.data.returns import from_returns
from copula_var.models.fit import MsmFit
from copula_var.ops.grids import garch_grid, msm_grid
from copula_var.ops.quadrature import halfspace_mask

CORR = np.array([[1.0, 0.45], [0.45, 1.0]])


def _tiny_sigma_backtest(rng, engine):
    """sigma so small the mixture CDF saturates to {0, 1} on most grid
    points -> t_ppf +-inf -> the student density's 0/0 NaN parity
    (`student.py:128-131`) -> NaN CDF days."""
    N, T = 40, 8
    rets = rng.multivariate_normal(np.zeros(2), CORR, size=N + T)
    data = from_returns(rets, ["A", "B"], N, np.array([0.5, 0.5]))
    fits = [
        MsmFit(m_0=0.45, b=3.0, gamma=0.5, sigma=1e-3, log_likelihood=0.0),
        MsmFit(m_0=0.55, b=5.0, gamma=0.3, sigma=1.0, log_likelihood=0.0),
    ]
    return VaRBacktest(
        data, MsmAdapter(k=2), "student", num_points=24,
        model_fits_override=fits,
        copula_fit_override=StudentFit(6.0, CORR, 0.0,
                                       np.array([6.0, 0.45])),
        engine=engine, interpret=engine == "pallas",
    )


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_nan_days_surface_as_nan(rng, engine):
    """A day whose CDF is NaN has no solvable quantile: calc_var must
    return NaN for it (`backtest.py` nan_days surfacing), on the fused
    Pallas engine as well as XLA."""
    bt = _tiny_sigma_backtest(rng, engine)
    var = bt.calc_var(0.05)
    assert var.shape == (bt.data.out_sample_n,)
    assert np.all(np.isnan(var)), var


def test_halfspace_mask_nonequal_and_negative_inner_weight(rng):
    """weights[0] (the divisor, `integration_algo.py:5-20`) with both
    signs and unequal magnitudes: the mask must equal the brute-force
    membership test with the same strict-lower/inclusive-upper, clamped
    semantics (`create_grids.py:102-110`)."""
    x, _ = msm_grid(24)
    n = len(x)
    for w in (np.array([0.7, 0.3]), np.array([-0.5, 0.5]),
              np.array([0.2, -0.8])):
        lower, upper = -3.2, -1.1
        got = np.asarray(halfspace_mask(jnp.asarray(x), lower, upper,
                                        jnp.asarray(w)))
        want = np.zeros((n, n), dtype=bool)
        for i in range(n):
            prev = x[i] * w[1]
            dyn_up = (upper - prev) / w[0]
            dyn_lo = max((lower - prev) / w[0], -5.0)
            want[i] = (x > dyn_lo) & (x <= dyn_up)
        np.testing.assert_array_equal(got, want, err_msg=f"weights={w}")


def test_grid_raises_when_num_points_too_small():
    """The reference's region splits silently produce an empty central
    region when the divisors eat the whole budget; `build_grid` raises
    instead (`ops/grids.py`). The msm/garch fixed splits (4,7)/(8,5) can
    never trigger it (2/4 + 2/7 < 1), so drive the generic entry (nonuniform_grid)."""
    from copula_var.ops.grids import nonuniform_grid

    with pytest.raises(ValueError, match="too small"):
        nonuniform_grid(8, outer_div=2, middle_div=2)
    # fixed splits stay valid down to tiny sizes
    x, dx = msm_grid(8)
    assert len(x) == 8 and len(dx) == 8


def test_artifacts_roundtrip_through_pallas_engine(rng, tmp_path):
    """save -> load -> engine='pallas' solve must equal the pre-save
    pallas solve (the checkpoint/resume path feeding the fused engine)."""
    from copula_var.utils.artifacts import load_artifacts, save_artifacts

    N, T = 40, 8
    rets = rng.multivariate_normal(np.zeros(2), CORR, size=N + T)
    data = from_returns(rets, ["A", "B"], N, np.array([0.5, 0.5]))
    fits = [
        MsmFit(m_0=0.45, b=3.0, gamma=0.5, sigma=1.0, log_likelihood=0.0),
        MsmFit(m_0=0.55, b=5.0, gamma=0.3, sigma=1.1, log_likelihood=0.0),
    ]
    kwargs = dict(
        num_points=24,
        model_fits_override=fits,
        copula_fit_override=StudentFit(6.0, CORR, 0.0,
                                       np.array([6.0, 0.45])),
    )
    bt = VaRBacktest(data, MsmAdapter(k=2), "student", engine="pallas",
                     interpret=True, **kwargs)
    want = bt.calc_var(0.05)

    path = str(tmp_path / "bt.npz")
    save_artifacts(path, bt)
    bt2 = load_artifacts(path, data, adapter=MsmAdapter(k=2))
    assert bt2.engine == "xla"  # dataclass default on restored objects
    bt2.engine, bt2.interpret = "pallas", True
    got = bt2.calc_var(0.05)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_dim4_transient_budget_guard():
    """dim >= 4 at production num_points must fail LOUDLY, not OOM: at
    n=100, dim=4 one day's density grid is 1e8 f64 elements (~800 MB) —
    `_day_batch` rejects it with an actionable message instead of letting
    the scheduler discover it (the reference's engine silently corrupts
    above dim 2, `create_grids.py:135-137`)."""
    from copula_var.ops.quadrature import _day_batch

    with pytest.raises(ValueError, match="transient budget"):
        _day_batch(100, 4, 500)
    # small-n dim-4 stays within budget and yields a valid chunk size
    assert _day_batch(20, 4, 500) >= 1


def test_dim4_small_n_quadrature_runs():
    """The any-dim tcached engine actually computes a dim-4 integral at
    small n (the guard is a memory bound, not a dimensionality cap):
    independent-copula integral over the full box factorizes to the
    product of per-dim masses — an analytic cross-check."""
    from copula_var.ops.quadrature import (
        CopulaSpec,
        garch_day_columns,
        garch_integrals_tcached,
    )
    from copula_var.ops.grids import garch_grid

    dim, n, T = 4, 16, 3
    x, dx = garch_grid(n)
    corr = np.eye(dim)
    spec = CopulaSpec("gaussian", (jnp.asarray(corr),))
    fvols = np.full((T, dim), 1.0)
    cols, p_cols = garch_day_columns(fvols, x, spec)
    # full box: lower far below, upper far above -> integral = product of
    # per-dim quadrature masses of the standard normal pdf over [-5, 5]
    bounds = np.tile([-1e4, 1e4], (T, 1))
    got = np.asarray(
        garch_integrals_tcached(bounds, cols, p_cols, x, dx,
                                np.full(dim, 1.0 / dim), spec)
    )
    from copula_var.ops.special import norm_pdf

    pdfx = np.asarray(norm_pdf(jnp.asarray(x)))
    mass1 = float(np.sum(pdfx * dx))
    # inner dim: the dynamic lower bound clamps to box_min with a STRICT
    # compare (`create_grids.py:108`), excluding the x == -5 grid point
    # that the inclusive outer box keeps
    mass_inner = float(np.sum((pdfx * dx)[np.asarray(x) > -5.0]))
    np.testing.assert_allclose(got, mass1 ** (dim - 1) * mass_inner,
                               rtol=1e-10)


def test_dim4_backtest_end_to_end(rng):
    """4-asset portfolio through the full pipeline at small num_points
    (the transient budget is a memory bound, not a dimensionality cap):
    xla and the day-sharded transform-column engine agree exactly."""
    from copula_var.backtest import create_var_backtest
    from copula_var.data import returns as returns_mod

    n_total, n_in, dim = 140, 120, 4
    rets = rng.standard_normal((n_total, dim)) * (
        1.0 + 0.3 * np.abs(np.sin(np.arange(n_total) / 11.0))[:, None]
    )
    data = returns_mod.from_returns(rets, n_insample=n_in)
    bt_x = create_var_backtest(data, "garch", "gaussian", num_points=16,
                               engine="xla", p_max=1, q_max=1)
    v_x = bt_x.calc_var()
    assert np.all(np.isfinite(v_x)) and np.all(v_x < 0)
    bt_s = create_var_backtest(data, "garch", "gaussian", num_points=16,
                               engine="sharded", p_max=1, q_max=1,
                               model_fits_override=bt_x.model_fits,
                               copula_fit_override=bt_x.copula_fit)
    np.testing.assert_allclose(bt_s.calc_var(), v_x, atol=1e-12)
