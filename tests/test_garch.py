"""Golden parity tests: GARCH scan kernels vs the reference oracle.

The reference (`/root/reference/garch/estimation.py`, `forecast.py`,
`generate_data.py`) runs here in pure Python via the numba passthrough stub
(see tests/_reference.py) and provides exact golden values.
"""

import numpy as np
import pytest

from copula_var.models import garch

from tests._reference import ref


def _simulate_returns(rng, n=400):
    # plain normal-vol returns are fine as inputs for parity
    return rng.normal(size=n) * 1.3


CASES = [
    (0.1, [0.08], [0.9]),
    (0.05, [0.05, 0.03], [0.85]),
    (0.2, [0.1], [0.4, 0.3]),
    (0.02, [0.04, 0.02, 0.01], [0.6, 0.2, 0.05]),
]


@pytest.mark.parametrize("omega,alpha,beta", CASES)
def test_conditional_variances_parity(rng, omega, alpha, beta):
    est_mod = ref("garch.estimation")
    r = _simulate_returns(rng)
    oracle = est_mod.ProbEstimation(r, omega, alpha, beta)
    want = oracle.calculate_conditional_variances()
    got = np.asarray(garch.conditional_variances(r, omega, alpha, beta))
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("omega,alpha,beta", CASES)
def test_log_likelihood_parity(rng, omega, alpha, beta):
    est_mod = ref("garch.estimation")
    r = _simulate_returns(rng)
    oracle = est_mod.ProbEstimation(r, omega, alpha, beta)
    want = oracle.calculate_log_likelihood()
    got = float(garch.log_likelihood(r, omega, alpha, beta))
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("omega,alpha,beta", CASES)
def test_eps_t_parity(rng, omega, alpha, beta):
    est_mod = ref("garch.estimation")
    r = _simulate_returns(rng)
    oracle = est_mod.ProbEstimation(r, omega, alpha, beta)
    want = oracle.calculate_eps_t()
    got = np.asarray(garch.standardized_residuals(r, omega, alpha, beta))
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("omega,alpha,beta", CASES)
def test_forecast_parity(rng, omega, alpha, beta):
    fc_mod = ref("garch.forecast")
    r = _simulate_returns(rng)
    want = fc_mod.calc_forecast(omega, np.array(alpha), np.array(beta), r)
    got = float(garch.forecast_vol(r, omega, alpha, beta))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_validate_params_raises():
    with pytest.raises(ValueError):
        garch.validate_params(0.1, [0.6], [0.5])  # non-stationary
    with pytest.raises(ValueError):
        garch.validate_params(-0.1, [0.1], [0.5])
    with pytest.raises(ValueError):
        garch.validate_params(0.1, [-0.1], [0.5])


def test_simulate_shapes_and_stationarity(rng):
    import jax

    y, s2, eps = garch.simulate(jax.random.PRNGKey(0), 0.1, [0.08], [0.9], 2000)
    assert y.shape == (2000,) and s2.shape == (2000,)
    # unconditional variance omega/(1-a-b) = 5; sample var in the ballpark
    v = float(np.var(np.asarray(y)))
    assert 2.0 < v < 12.0


def test_simulate_matches_reference_given_same_draws():
    """Replay the reference simulator's own N(0,1) draws through our scan.

    With p = q = 1 the reference's chopped eps array is exactly the full
    draw sequence (y[0] is dropped by the extra_size chop), so the two
    simulators must agree to fp roundoff.
    """
    gen_mod = ref("garch.generate_data")
    np.random.seed(7)
    g = gen_mod.GenerateData(0.1, [0.08], [0.9])
    y_ref, s2_ref, eps_ref = g.generate(500)
    y, s2, eps = garch.simulate_from_draws(eps_ref, 0.1, [0.08], [0.9], 500)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(s2), s2_ref, rtol=1e-12)
