"""Golden parity tests: MSM scan kernels vs the reference oracle
(`markov_switching_multifractal/`), run in pure Python via the numba stub."""

import numpy as np
import pytest

from copula_var.models import msm

from tests._reference import ref

PARAM_CASES = [
    (2, 0.5, 0.05, 2.0, 0.5),
    (4, 0.3, 1.2, 18.0, 0.5),
    (4, 0.7, 0.8, 3.0, 0.1),
    (6, 0.45, 1.0, 5.0, 0.8),
]


def _returns(rng, n=300, scale=1.0):
    return rng.normal(size=n) * scale


@pytest.mark.parametrize("k,m0,sigma,b,gamma", PARAM_CASES)
def test_state_space_parity(k, m0, sigma, b, gamma, rng):
    cp = ref("markov_switching_multifractal.calc_prob")
    oracle = cp.ProbEstimation(k, m0, sigma, b, gamma, _returns(rng))
    np.testing.assert_allclose(
        np.asarray(msm.state_components(k, m0)), oracle.transi_mat, rtol=1e-15
    )
    np.testing.assert_allclose(
        np.asarray(msm.transition_matrix(k, b, gamma)),
        oracle.transi_probs,
        rtol=1e-13,
    )
    np.testing.assert_allclose(
        np.asarray(msm.vol_states(k, m0, sigma)), oracle.vol_states, rtol=1e-14
    )


@pytest.mark.parametrize("k,m0,sigma,b,gamma", PARAM_CASES)
def test_filter_and_likelihood_parity(k, m0, sigma, b, gamma, rng):
    cp = ref("markov_switching_multifractal.calc_prob")
    r = _returns(rng, scale=sigma)
    oracle = cp.ProbEstimation(k, m0, sigma, b, gamma, r)
    want_states, want_cond = oracle.calc_state_prob()
    want_ll = oracle.calc_likelihood()

    states, cond, _, valid = msm.filter_states(k, m0, sigma, b, gamma, r)
    assert bool(valid)
    np.testing.assert_allclose(np.asarray(cond), want_cond, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(states), want_states, rtol=1e-9, atol=1e-12)
    ll = float(msm.log_likelihood(k, m0, sigma, b, gamma, r))
    np.testing.assert_allclose(ll, want_ll, rtol=1e-10)


@pytest.mark.parametrize("dense", [True, False])
def test_kron_matvec_equals_dense(dense, rng):
    k, b, gamma = 5, 4.0, 0.3
    P = np.asarray(msm.transition_matrix(k, b, gamma))
    v = rng.uniform(size=2**k)
    got = np.asarray(
        msm.kron_transition_matvec(
            msm.component_stay_probs(k, b, gamma), v
        )
    )
    np.testing.assert_allclose(got, P @ v, rtol=1e-13)
    # filter agrees between dense and kron paths
    r = rng.normal(size=50)
    s_d, *_ = msm.filter_states(k, 0.4, 1.0, b, gamma, r, dense=True)
    s_k, *_ = msm.filter_states(k, 0.4, 1.0, b, gamma, r, dense=False)
    np.testing.assert_allclose(np.asarray(s_d), np.asarray(s_k), rtol=1e-11)


@pytest.mark.parametrize("k,m0,sigma,b,gamma", PARAM_CASES[:2])
def test_marginals_densities_forecasts_parity(k, m0, sigma, b, gamma, rng):
    cm = ref("markov_switching_multifractal.calc_marginals")
    r = _returns(rng, scale=sigma)
    want_marg, want_eps, want_vols = cm.calc_marginals(k, m0, sigma, b, gamma, r)
    want_dens = cm.calc_densities(k, m0, sigma, b, gamma, r)
    want_fc = cm.calc_forecasts(k, m0, sigma, b, gamma, r)

    marg, eps, vols = msm.marginals(k, m0, sigma, b, gamma, r)
    np.testing.assert_allclose(np.asarray(marg), want_marg, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(eps), want_eps, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(vols), want_vols, rtol=1e-13)
    np.testing.assert_allclose(
        np.asarray(msm.densities(k, m0, sigma, b, gamma, r)),
        want_dens,
        rtol=1e-9,
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(msm.forecast_state_distribution(k, m0, sigma, b, gamma, r)),
        want_fc,
        rtol=1e-9,
        atol=1e-12,
    )


def test_filter_failure_sentinel():
    # absurd params: sigma tiny makes cond probs underflow to 0 for large r
    r = np.full(20, 1e6)
    ll = float(msm.log_likelihood(4, 0.5, 1e-300, 3.0, 0.5, r))
    assert ll == -np.inf


def test_simulate_moments():
    import jax

    ret, vol, eps, comps = msm.simulate(
        jax.random.PRNGKey(0), 4, 0.4, 1.5, 3.0, 0.5, 20000
    )
    assert ret.shape == (20000,) and comps.shape == (20001, 4)
    # E[vol^2] = sigma^2 * E[prod m] = sigma^2 (multipliers average to 1)
    np.testing.assert_allclose(float(np.mean(np.asarray(vol) ** 2)), 1.5**2, rtol=0.1)


def test_kron_filter_k10(rng):
    """k = 10 (1024 states) — SURVEY hard part (c): the Kronecker-factored
    scan must agree with the dense filter."""
    k, b, gamma, m0, sigma = 10, 5.0, 0.3, 0.45, 1.0
    r = rng.normal(size=40)
    s_d, c_d, ln_d, v_d = msm.filter_states(k, m0, sigma, b, gamma, r, dense=True)
    s_k, c_k, ln_k, v_k = msm.filter_states(k, m0, sigma, b, gamma, r, dense=False)
    assert bool(v_d) and bool(v_k)
    np.testing.assert_allclose(np.asarray(s_d), np.asarray(s_k), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(np.asarray(ln_d), np.asarray(ln_k), rtol=1e-10)
    ll = float(msm.log_likelihood(k, m0, sigma, b, gamma, r))
    assert np.isfinite(ll)
