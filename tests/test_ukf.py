"""Golden parity tests: UKF scan kernel vs the reference oracle
(`kalman_mean_reverting/estimate.py` run in pure Python via the numba stub)."""

import numpy as np
import pytest

from copula_var.models import ukf

from tests._reference import ref

CASES = [
    (0.95, 0.0, 0.2),
    (0.9, 0.5, 0.1),
    (0.99, -0.3, 0.05),
]


def _returns(rng, n, a, l, q):
    # simulate the model itself so the filter sees in-distribution data
    x = np.empty(n)
    x[0] = l
    for t in range(1, n):
        x[t] = a * (x[t - 1] - l) + l + q * rng.normal()
    return np.exp(x) * rng.normal(size=n)


@pytest.mark.parametrize("a,l,q", CASES)
def test_filter_parity(rng, a, l, q):
    est = ref("kalman_mean_reverting.estimate")
    r = _returns(rng, 300, a, l, q)
    oracle = est.KalmanFilterVolEstimation(a, l, q, l, q, len(r), r)
    means, variances, ll, fc, valid = ukf.filter_series(r, a, l, q)
    assert bool(valid)
    np.testing.assert_allclose(np.asarray(means), oracle.state_estimation, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(variances), oracle.var_setimation, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(float(ll), oracle.LL, rtol=1e-10)
    np.testing.assert_allclose(float(fc), oracle.forecasts, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("a,l,q", CASES[:2])
def test_vol_and_eps_parity(rng, a, l, q):
    est = ref("kalman_mean_reverting.estimate")
    r = _returns(rng, 200, a, l, q)
    oracle = est.KalmanFilterVolEstimation(a, l, q, l, q, len(r), r)
    np.testing.assert_allclose(
        np.asarray(ukf.vol_path(r, a, l, q)), oracle.sto_vol_estimation(), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(ukf.standardized_residuals(r, a, l, q)),
        oracle.calc_eps_t(),
        rtol=1e-10,
    )


@pytest.mark.parametrize("a,l,q", CASES[:1])
def test_forecast_parity(rng, a, l, q):
    fc_mod = ref("kalman_mean_reverting.forecast")
    r = _returns(rng, 150, a, l, q)
    want = fc_mod.calc_forecast(r, a, l, q)
    got = float(ukf.forecast_vol(r, a, l, q))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_failure_sentinel():
    # enormous returns make eta overflow -> h underflows -> Z < 1e-10
    r = np.full(20, 1e300)
    _, _, ll, _, valid = ukf.filter_series(r, 0.95, 0.0, 0.2)
    assert not bool(valid)
    assert float(ll) == ukf.FAIL_LL


def test_simulate_moments():
    import jax

    X, vol, r = ukf.simulate(jax.random.PRNGKey(0), 0.95, 0.0, 0.2, 20000)
    assert X.shape == vol.shape == r.shape == (20000,)
    # OU stationary std = q / sqrt(1 - a^2)
    np.testing.assert_allclose(
        float(np.std(np.asarray(X))), 0.2 / np.sqrt(1 - 0.95**2), rtol=0.1
    )
