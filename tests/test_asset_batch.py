"""Asset-batched fit programs (VERDICT r04 next #1).

The reference fits tickers one at a time (`utils/calc_var_class.py:60-63`);
the adapters now run EVERY asset's optimizer inside one device program.
These tests assert (a) the batched path issues exactly ONE batched-program
call for an A-asset panel, and (b) per-asset results match the
single-asset path (same PRNG streams: asset i uses PRNGKey(seed + i)).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from copula_var.models import fit as mfit
from copula_var.models import garch as garch_mod
from copula_var.models import msm as msm_mod
from copula_var.models import ukf as ukf_mod


def _garch_panel(rng, n=400, A=3):
    cols = []
    for i in range(A):
        key = jax.random.PRNGKey(7 + i)
        y, _, _ = garch_mod.simulate(key, 0.1 + 0.05 * i, np.array([0.1]),
                                     np.array([0.8 - 0.1 * i]), n)
        cols.append(np.asarray(y))
    return np.stack(cols, axis=1)


def test_garch_batch_one_dispatch_and_parity(rng, monkeypatch):
    panel = _garch_panel(rng)
    calls = []
    orig = mfit._newton_garch_assets

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(mfit, "_newton_garch_assets", counting)
    fits = mfit.fit_garch_batch(panel, p_max=2, q_max=2, max_iter=60)
    assert len(calls) == 1, "A-asset GARCH fit must be ONE device program"
    assert len(fits) == panel.shape[1]
    # parity with the single-asset path (which routes through the same
    # program at A=1): identical selected orders and parameters
    for i in range(panel.shape[1]):
        solo = mfit.fit_garch(panel[:, i], p_max=2, q_max=2, max_iter=60)
        assert (solo.p, solo.q) == (fits[i].p, fits[i].q)
        np.testing.assert_allclose(solo.params, fits[i].params, rtol=1e-9)
        np.testing.assert_allclose(solo.nll, fits[i].nll, rtol=1e-9)


def test_msm_batch_one_dispatch_and_parity(rng, monkeypatch):
    k = 3
    cols = []
    for i in range(2):
        r, _, _, _ = msm_mod.simulate(
            jax.random.PRNGKey(3 + i), k, 0.6, 1.0, 3.0, 0.5, 300
        )
        cols.append(np.asarray(r))
    panel = np.stack(cols, axis=1)

    calls = []
    orig_prog = mfit._msm_basin_program

    def counting_prog(kk):
        bd, bn, ba = orig_prog(kk)

        def counted(*a, **kw):
            calls.append(1)
            return ba(*a, **kw)

        return bd, bn, counted

    monkeypatch.setattr(mfit, "_msm_basin_program", counting_prog)
    # basin_iter=0 keeps the trajectory deterministic (fixed b-grid starts
    # + L-BFGS polish): the stochastic hop's accept/reject flips on
    # sub-ulp vmap-reassociation differences, so parameter-exact parity
    # is only defined for the deterministic path
    fits = mfit.fit_msm_batch(panel, k, basin_iter=0, seed=5)
    assert len(calls) == 1, "A-asset MSM basin hop must be ONE program"
    for i in range(2):
        solo = mfit.fit_msm(panel[:, i], k, basin_iter=0, seed=5 + i)
        np.testing.assert_allclose(
            solo.log_likelihood, fits[i].log_likelihood, rtol=1e-8
        )
        np.testing.assert_allclose(
            [solo.m_0, solo.b, solo.gamma, solo.sigma],
            [fits[i].m_0, fits[i].b, fits[i].gamma, fits[i].sigma],
            rtol=1e-3,
        )


def test_ukf_batch_one_dispatch_and_parity(rng, monkeypatch):
    cols = []
    for i in range(2):
        _, _, y = ukf_mod.simulate(
            jax.random.PRNGKey(11 + i), 0.9, 0.4, 0.2, 300
        )
        cols.append(np.asarray(y))
    panel = np.stack(cols, axis=1)

    calls = []
    orig = mfit._ukf_em_assets

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(mfit, "_ukf_em_assets", counting)
    fits = mfit.fit_ukf_em_batch(panel, max_iter=40, seed=2)
    assert len(calls) == 1, "A-asset UKF EM must be ONE device program"
    for i in range(2):
        solo = mfit.fit_ukf_em(panel[:, i], max_iter=40, seed=2 + i)
        np.testing.assert_allclose(
            [solo.a, solo.l, solo.q],
            [fits[i].a, fits[i].l, fits[i].q], rtol=1e-8,
        )


def test_garch_padded_forecast_matches_exact(rng):
    """forecast_vol_padded with end-zero-padded rows + traced (p, q)
    reproduces forecast_vol's quirk pairing exactly at p != q."""
    y, _, _ = garch_mod.simulate(
        jax.random.PRNGKey(0), 0.1, np.array([0.05, 0.08]),
        np.array([0.6]), 200
    )
    exact = garch_mod.forecast_vol(
        y, 0.1, jnp.asarray([0.05, 0.08]), jnp.asarray([0.6])
    )
    padded = garch_mod.forecast_vol_padded(
        y, 0.1, jnp.asarray([0.05, 0.08, 0.0]),
        jnp.asarray([0.6, 0.0, 0.0]), 2, 1
    )
    np.testing.assert_allclose(
        np.asarray(padded), np.asarray(exact), rtol=1e-12
    )
