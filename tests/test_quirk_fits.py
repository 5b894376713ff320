"""Optimizer-trajectory quirk flags: fits-included golden comparison.

VERDICT r03 missing #2 / task #8: the UKF EM's frozen-`a` M-step
(`/root/reference/kalman_mean_reverting/optimize.py:83` — the local `a`
is assigned once before the loop and never updated) and the MSM
optimizer's min-LL start selection
(`markov_switching_multifractal/opti.py:125-128`) are DEFECTS we fix by
default; `reference_quirks=True` reproduces them so the reference's
*fitted parameters* — not just its kernels — can be golden-compared.

Determinism windows used here:
  * MSM with basin_iter=0: the reference's basin_hopping loop body never
    runs, so each b-grid start returns its init + the closed-form sigma +
    the true LL — fully deterministic on both sides; only the (defective)
    selection rule decides the winner.
  * UKF EM on well-behaved synthetic data: the trajectory is pure
    deterministic EM updates until convergence (random perturbation only
    fires on filter failure / stall / the post-convergence sweep, and the
    sweep can only replace the best on a strict improvement).
"""

import numpy as np
import pytest

from copula_var.models import fit as mfit

from tests._reference import ref


def _msm_returns(rng, n=400):
    # mildly vol-clustered series, safely inside the MSM bounds
    vol = 1.0 + 0.5 * np.abs(np.sin(np.arange(n) / 23.0))
    return rng.standard_normal(n) * vol


def test_msm_min_ll_selection_quirk_golden(rng):
    """fit_msm(basin_iter=0, reference_quirks=True) reproduces the
    reference optimizer's selected parameters EXACTLY (same init grid,
    same closed-form sigma, same true-LL evaluation, same min-LL
    selection defect)."""
    r = _msm_returns(rng)
    k = 2
    b_values = np.linspace(1.0, 50.0, 10)

    opti_mod = ref("markov_switching_multifractal.opti")
    opt = opti_mod.Optimizer(returns=r, k=k, basin_iter=0)
    bounds = [(0.2, 0.8), (1.0, 50.0), (0.05, 0.95)]
    best_ll = np.inf
    best = None
    for b in b_values:  # `optimize()` without the process pool
        m_0, b_v, gamma, sigma, ll = opt.evaluate_b(
            b, np.array([0.5, 10.0, 0.5]), bounds
        )
        if ll < best_ll:  # the reference's min-LL defect (`opti.py:125`)
            best_ll = ll
            best = (m_0, b_v, gamma, sigma)

    got = mfit.fit_msm(r, k, basin_iter=0, b_values=b_values,
                       reference_quirks=True)
    np.testing.assert_allclose(
        [got.m_0, got.b, got.gamma, got.sigma], best, rtol=1e-9
    )
    np.testing.assert_allclose(got.log_likelihood, best_ll, rtol=1e-9)

    # and the defect is OBSERVABLE: the fixed selection picks a different
    # (better-likelihood) start on this grid
    fixed = mfit.fit_msm(r, k, basin_iter=0, b_values=b_values)
    assert fixed.log_likelihood > got.log_likelihood


def _ou_returns(rng, n=300):
    # OU log-vol -> returns (`kalman_mean_reverting/generate.py:18-32`)
    a, l, q = 0.9, 0.3, 0.25
    x = np.empty(n)
    x[0] = l
    for t in range(1, n):
        x[t] = a * (x[t - 1] - l) + l + q * rng.standard_normal()
    return np.exp(x) * rng.standard_normal(n)


def test_ukf_frozen_a_quirk_golden(rng):
    """fit_ukf_em(reference_quirks=True) tracks the reference EM's
    frozen-a trajectory: identical fitted parameters within the
    documented tolerance (E-step f64 parity ~1e-10 compounding over the
    deterministic EM updates), while the defect-fixed default lands on a
    different fixed point."""
    r = _ou_returns(rng)
    max_iter, tol = 25, 1e-12  # deterministic window: no convergence fire

    opt_mod = ref("kalman_mean_reverting.optimize")
    np.random.seed(0)  # the reference perturbs via global np.random
    opt = opt_mod.VolOptimizer(a=0.99, l=0.5, q=0.1, max_iter=max_iter,
                               tol=tol)
    ref_params, ref_ll = opt.em_algorithm(r)

    got = mfit.fit_ukf_em(r, max_iter=max_iter, tol=tol,
                          reference_quirks=True)
    np.testing.assert_allclose(
        [got.a, got.l, got.q], np.asarray(ref_params, float),
        rtol=1e-6, atol=1e-8,
    )
    np.testing.assert_allclose(got.log_likelihood, float(ref_ll),
                               rtol=1e-8)

    fixed = mfit.fit_ukf_em(r, max_iter=max_iter, tol=tol)
    assert abs(fixed.a - got.a) + abs(fixed.l - got.l) > 1e-6, (
        "the frozen-a defect should be observable on this data"
    )


@pytest.mark.slow
def test_garch_reference_trajectory_quirk_golden(rng):
    """fit_garch(reference_quirks=True) walks the reference
    GarchOptimizer's EXACT Newton trajectory (`garch/opti.py:139-181`) —
    FD stencils incl. the defective mixed-partial formula, pinv steps,
    projections, BIC `<` selection.

    The FD Hessian divides ~1e-7-scale NLL differences by eps^2 = 1e-10,
    so the comparison must hold the NLL values fixed: the reference
    optimizer here is run with OUR jitted NLL injected (the NLL itself
    is pinned by the dedicated parity suite, tests/test_garch.py), which
    isolates exactly the trajectory the quirk mode claims to reproduce."""
    import jax.numpy as jnp

    from copula_var.models.fit import _garch_nll

    n = 300
    vol = np.empty(n)
    r = np.empty(n)
    v = 1.0
    for t in range(n):  # GARCH(1,1)-ish data
        v = 0.05 + 0.1 * (r[t - 1] ** 2 if t else 1.0) + 0.85 * v
        vol[t] = np.sqrt(v)
        r[t] = vol[t] * rng.standard_normal()

    opti_mod = ref("garch.opti")

    class InjectedNll(opti_mod.GarchOptimizer):
        def negative_log_likelihood(self, params, p, q):
            return float(_garch_nll(jnp.asarray(r), jnp.asarray(params), p))

    p_max = q_max = 2  # 4 pairs: enough to exercise the BIC selection
    ref_opt = InjectedNll(r, p_max=p_max, q_max=q_max, tol=1e-10,
                          max_iter=60)
    (rp, rq), ref_params, ref_nll, ref_bic = ref_opt.optimize()

    got = mfit.fit_garch(r, p_max=p_max, q_max=q_max, tol=1e-10,
                         max_iter=60, reference_quirks=True)
    assert (got.p, got.q) == (rp, rq)
    np.testing.assert_allclose(got.params, np.asarray(ref_params),
                               rtol=1e-12)
    np.testing.assert_allclose(got.nll, float(ref_nll), rtol=1e-12)
    np.testing.assert_allclose(got.bic, float(ref_bic), rtol=1e-12)
