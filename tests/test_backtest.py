"""End-to-end backtest tests: the minimum slice (SURVEY §7) and the full
3x3 model/copula factory matrix on tiny synthetic problems."""

import numpy as np
import pytest

import jax

from copula_var.backtest import create_var_backtest
from copula_var.data import synthetic_dataset


@pytest.fixture(scope="module")
def garch_data():
    # 2 correlated-ish GARCH assets, N=300 in-sample, T=40 out-of-sample
    return synthetic_dataset(jax.random.PRNGKey(7), 340, 300)


def test_minimum_slice_garch_gaussian(garch_data):
    bt = create_var_backtest(
        garch_data, "garch", "gaussian", num_points=40,
        p_max=1, q_max=1, newton_max_iter=60,
    )
    var95 = bt.calc_var(obj_var=0.05)
    T = garch_data.out_sample_n
    assert var95.shape == (T,)
    assert np.all(np.isfinite(var95))
    # 95% VaR of a centered returns portfolio must be negative
    assert np.all(var95 < 0)
    # exceptions: portfolio return below VaR should happen ~5% of days
    ptf = garch_data.out_sample @ garch_data.weights
    exceptions = np.mean(ptf < var95)
    assert exceptions <= 0.35  # loose on T=40

    # deeper quantile is more negative
    var99 = bt.calc_var(obj_var=0.01)
    assert np.all(var99 <= var95 + 1e-6)


def test_var_against_closed_form_gaussian(garch_data):
    """With a Gaussian copula and normal marginals the portfolio w.x is
    normal with variance w^T Sigma w scaled by the forecast vols — the
    solver's VaR must match the closed-form quantile within grid error."""
    bt = create_var_backtest(
        garch_data, "garch", "gaussian", num_points=60,
        p_max=1, q_max=1, newton_max_iter=60,
    )
    var95 = bt.calc_var(obj_var=0.05)
    fv = bt.integration_inputs.forecast_vols  # (T, dim)
    rho = bt.copula_fit.corr_matrix[0, 1]
    w = garch_data.weights
    sig_p = np.sqrt(
        (w[0] * fv[:, 0]) ** 2
        + (w[1] * fv[:, 1]) ** 2
        + 2 * rho * w[0] * w[1] * fv[:, 0] * fv[:, 1]
    )
    from scipy.stats import norm

    want = norm.ppf(0.05) * sig_p + garch_data.ptf_mean
    # restrict to days the [-5, 5] box covers well (>= 2.5 sigma per
    # asset): beyond that the reference-faithful box truncation biases the
    # CDF (same behavior as the reference engine)
    ok = fv.max(axis=1) < 2.0
    assert ok.sum() >= 10
    np.testing.assert_allclose(var95[ok], want[ok], atol=0.12)


@pytest.mark.parametrize("model", ["garch", "mean_reverting", "msm"])
@pytest.mark.parametrize(
    "copula",
    [
        "gaussian",
        # the staged student IFM fit dominates suite wall time; the
        # student path stays covered in the quick tier by
        # test_e2e_parity.py::test_e2e_msm_student and the copula tests
        pytest.param("student", marks=pytest.mark.slow),
        "plackett",
    ],
)
def test_full_matrix_smoke(model, copula):
    """Every (model, copula) pair builds and solves on a tiny problem."""
    data = synthetic_dataset(jax.random.PRNGKey(11), 220, 200)
    kwargs = {}
    if model == "garch":
        kwargs = dict(p_max=1, q_max=1, newton_max_iter=30)
    elif model == "msm":
        kwargs = dict(k=2, basin_iter=10)
    elif model == "mean_reverting":
        kwargs = dict(em_max_iter=10)
    bt = create_var_backtest(data, model, copula, num_points=32, **kwargs)
    var = bt.calc_var(obj_var=0.05)
    assert var.shape == (20,)
    assert np.all(np.isfinite(var))
    assert np.all(var < 1.0)


def test_factory_rejects_unknown():
    data = synthetic_dataset(jax.random.PRNGKey(0), 60, 50)
    with pytest.raises(ValueError):
        create_var_backtest(data, "arma", "gaussian")
    with pytest.raises(ValueError):
        create_var_backtest(data, "garch", "clayton")


def test_device_bisection_matches_host(garch_data):
    """The on-device lax.while_loop bisection must reproduce the host
    loop exactly."""
    bt = create_var_backtest(
        garch_data, "garch", "gaussian", num_points=32,
        p_max=1, q_max=1, newton_max_iter=40,
    )
    var_dev = bt.calc_var(obj_var=0.05)

    # force the host path by pretending dim != 2 at solve time
    class _HostOnly:
        pass

    bt2 = create_var_backtest(
        garch_data, "garch", "gaussian", num_points=32,
        p_max=1, q_max=1, newton_max_iter=40,
    )
    bt2._bisection_device = lambda *a, **k: bt2._bisection(*a, **k)
    var_host = bt2.calc_var(obj_var=0.05)
    np.testing.assert_allclose(var_dev, var_host, rtol=1e-12, atol=1e-12)
