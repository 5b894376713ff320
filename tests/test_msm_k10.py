"""k = 10 MSM end-to-end (VERDICT r03 task #6; SURVEY §7 hard part (c)).

At k = 10 the Hamilton filter carries 1024 states and the transition is
applied with the O(k 2^k) Kronecker-factored matvec
(`models/msm.py:81-95`; the dense path would be a 1024 x 1024 matvec per
step). These tests prove the full production path — fit, window
forecasts, vol-level collapse (2^10 -> q = 11 unique levels), and a
backtest solve — actually runs at that scale, not just the likelihood.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from copula_var.backtest import create_var_backtest
from copula_var.data import returns as returns_mod
from copula_var.models import fit as mfit
from copula_var.models import msm as msm_mod


def _msm_k10_returns(rng, n):
    """Simulate an MSM(k=10) series (`generate_data.py:5-53` semantics)."""
    k, m0, b, gamma, sigma = 10, 0.4, 4.0, 0.6, 1.0
    gamma_j = 1.0 - (1.0 - gamma) ** (b ** np.arange(k))
    comps = np.where(rng.random(k) < 0.5, m0, 2.0 - m0)
    out = np.empty(n)
    for t in range(n):
        switch = rng.random(k) < gamma_j / 2.0
        fresh = np.where(rng.random(k) < 0.5, m0, 2.0 - m0)
        comps = np.where(switch, fresh, comps)
        vol = sigma * np.sqrt(np.prod(comps))
        out[t] = vol * rng.standard_normal()
    return out


@pytest.mark.slow
def test_fit_msm_k10(rng):
    r = _msm_k10_returns(rng, 600)
    fit = mfit.fit_msm(r, k=10, basin_iter=15)
    assert np.isfinite(fit.log_likelihood)
    assert 0.2 <= fit.m_0 <= 0.8 and 1.0 <= fit.b <= 50.0
    assert 0.05 <= fit.gamma <= 0.95 and fit.sigma > 0
    # the k=10 likelihood at the fit beats the uniform-start init value
    init_ll = float(msm_mod.log_likelihood(10, 0.5, fit.sigma, 10.0, 0.5,
                                           r))
    assert fit.log_likelihood >= init_ll - 1e-9


@pytest.mark.slow
def test_msm_k10_backtest_end_to_end(rng):
    """msm + student at k = 10 through the whole backtest: the 1024-state
    forecasts collapse to q = 11 unique vol levels (k+1 distinct
    multiplier products) and the quadrature solves a finite VaR."""
    n_total, n_in = 230, 200
    r2 = np.column_stack(
        [_msm_k10_returns(rng, n_total), _msm_k10_returns(rng, n_total)]
    )
    data = returns_mod.from_returns(r2, n_insample=n_in)
    bt = create_var_backtest(
        data, "msm", "student", num_points=24, engine="xla",
        k=10, basin_iter=5,
    )
    assert bt.integration_inputs.unique_vols.shape == (2, 11)
    combos = bt.integration_inputs.forecast_combos
    assert combos.shape == (data.out_sample_n, 121)
    np.testing.assert_allclose(np.asarray(combos).sum(axis=1), 1.0,
                               atol=1e-8)
    var = bt.calc_var()
    assert var.shape == (data.out_sample_n,)
    assert np.all(np.isfinite(var)) and np.all(var < 0)


def test_kron_matches_dense_k10(rng):
    """Kron-factored filter == dense-matrix filter at k = 10 (quick
    tier: one likelihood evaluation, rtol 1e-12)."""
    r = _msm_k10_returns(rng, 120)
    args = (10, 0.45, 1.1, 5.0, 0.4, r)
    ll_kron = float(msm_mod.log_likelihood(*args, dense=False))
    ll_dense = float(msm_mod.log_likelihood(*args, dense=True))
    np.testing.assert_allclose(ll_kron, ll_dense, rtol=1e-12)


def test_msm_k12_kron_likelihood_and_collapse(rng):
    """k = 12 (4096 states) stays usable through the Kronecker path: the
    likelihood evaluates finite in O(k 2^k) (the dense path would be a
    4096^2 matvec per step, benchmarks/msm_k_scaling.py), and the vol-state collapse yields the k+1 = 13
    unique multiplier-product levels the adapters integrate over."""
    r = _msm_k10_returns(rng, 200)
    ll = float(msm_mod.log_likelihood(12, 0.45, 1.0, 5.0, 0.4, r,
                                      dense=False))
    assert np.isfinite(ll)
    vols = np.asarray(msm_mod.vol_states(12, 0.45, 1.0))
    assert vols.shape == (4096,)
    rounded = np.round(vols / 1e-6) * 1e-6
    assert len(np.unique(rounded)) == 13


@pytest.mark.slow
def test_msm_k12_backtest_end_to_end(rng):
    """k = 12 (4096 states) through the WHOLE production path — fit
    (Kronecker-factored basin hop + polish), window forecasts, the
    13-level collapse, and a finite VaR solve (VERDICT r04 next #7: the
    k=10 pattern scaled one notch; wall time recorded in PERF.md)."""
    n_total, n_in = 220, 200
    r2 = np.column_stack(
        [_msm_k10_returns(rng, n_total), _msm_k10_returns(rng, n_total)]
    )
    data = returns_mod.from_returns(r2, n_insample=n_in)
    bt = create_var_backtest(
        data, "msm", "student", num_points=24, engine="xla",
        k=12, basin_iter=3, polish_max_iter=8,
    )
    assert bt.integration_inputs.unique_vols.shape == (2, 13)
    combos = bt.integration_inputs.forecast_combos
    assert combos.shape == (data.out_sample_n, 169)
    np.testing.assert_allclose(np.asarray(combos).sum(axis=1), 1.0,
                               atol=1e-8)
    var = bt.calc_var()
    assert np.all(np.isfinite(var)) and np.all(var < 0)


def test_kron_gradient_matches_dense(rng):
    """The hand-written Kronecker VJP (custom_vjp — the (2,)*k autodiff
    residuals ran out of memory at k=12) matches the dense-path
    autodiff gradient of the log-likelihood in every parameter."""
    import jax

    r = _msm_k10_returns(rng, 120)

    def ll(params, dense):
        return msm_mod.log_likelihood(
            8, params[0], params[1], params[2], params[3],
            jnp.asarray(r), dense=dense,
        )

    import jax.numpy as jnp  # noqa: F811
    p0 = jnp.asarray([0.45, 1.1, 5.0, 0.4])
    g_kron = np.asarray(jax.grad(lambda p: ll(p, False))(p0))
    g_dense = np.asarray(jax.grad(lambda p: ll(p, True))(p0))
    np.testing.assert_allclose(g_kron, g_dense, rtol=1e-9)
