"""Coverage statistics + beyond-reference capability: dim = 3 portfolios
(the reference's recursive grid bookkeeping is only exact for dim = 2,
SURVEY.md §2.7; the masked dense engine generalizes)."""

import numpy as np
import pytest

import jax

from copula_var import stats
from copula_var.backtest import create_var_backtest
from copula_var.data import synthetic_dataset
from copula_var.ops.grids import garch_grid
from copula_var.ops.quadrature import CopulaSpec, garch_integrals


def test_kupiec_and_christoffersen():
    rng = np.random.default_rng(0)
    r = rng.normal(size=1000)
    var_good = np.full(1000, np.quantile(rng.normal(size=100000), 0.05))
    k = stats.kupiec_pof(r, var_good, 0.05)
    assert k.p_value > 0.01  # correct coverage not rejected
    var_bad = np.full(1000, -0.5)  # way too shallow -> ~31% exceptions
    k_bad = stats.kupiec_pof(r, var_bad, 0.05)
    assert k_bad.p_value < 1e-6
    ind = stats.christoffersen_independence(r, var_good)
    assert 0.0 <= ind.p_value <= 1.0
    cc = stats.christoffersen_conditional_coverage(r, var_good, 0.05)
    assert cc.df == 2
    assert cc.statistic >= k.statistic - 1e-9


def test_dim3_quadrature_probability():
    """3-asset masked quadrature: total mass ~ 1, halfspace at 0 ~ 0.5."""
    rng = np.random.default_rng(1)
    x, dx = garch_grid(40)
    corr = np.array(
        [[1.0, 0.3, 0.1], [0.3, 1.0, 0.2], [0.1, 0.2, 1.0]]
    )
    spec = CopulaSpec("gaussian", (corr,))
    w = np.array([1 / 3, 1 / 3, 1 / 3])
    fv = np.array([[1.0, 1.0, 1.0], [0.9, 1.1, 1.0]])
    full = np.asarray(
        garch_integrals(
            np.array([[-100.0, 100.0]] * 2), fv, x, dx, w, spec
        )
    )
    np.testing.assert_allclose(full, 1.0, atol=0.05)
    half = np.asarray(
        garch_integrals(np.array([[-100.0, 0.0]] * 2), fv, x, dx, w, spec)
    )
    np.testing.assert_allclose(half, 0.5, atol=0.06)


def test_dim3_backtest_end_to_end():
    data = synthetic_dataset(
        jax.random.PRNGKey(3), 230, 210, spec=("garch", "garch", "garch")
    )
    assert data.dim == 3
    bt = create_var_backtest(
        data, "garch", "gaussian", num_points=24,
        p_max=1, q_max=1, newton_max_iter=30,
    )
    var = bt.calc_var(obj_var=0.05)
    assert var.shape == (20,)
    assert np.all(np.isfinite(var)) and np.all(var < 0)


@pytest.mark.slow
def test_dim3_msm_backtest():
    data = synthetic_dataset(
        jax.random.PRNGKey(4), 160, 148, spec=("msm", "garch", "msm")
    )
    bt = create_var_backtest(
        data, "msm", "gaussian", num_points=16, k=2, basin_iter=5
    )
    var = bt.calc_var(obj_var=0.05)
    assert var.shape == (12,)
    assert np.all(np.isfinite(var))
