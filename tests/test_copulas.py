"""Golden parity tests: copula densities + IFM likelihoods vs the reference
oracles (`copulas/{gaussian,student,plackett}` run via the numba stub)."""

import numpy as np
import pytest

from copula_var import copulas
from copula_var.copulas import gaussian, plackett, student

from tests._reference import ref


def _u(rng, n=500, d=2):
    return rng.uniform(0.001, 0.999, size=(n, d))


def _corr(rho, d=2):
    m = np.full((d, d), rho)
    np.fill_diagonal(m, 1.0)
    return m


# --- Gaussian ---------------------------------------------------------------


@pytest.mark.parametrize("rho", [-0.7, 0.0, 0.5, 0.95])
def test_gaussian_density_parity(rng, rho):
    g = ref("copulas.gaussian.gaussian")
    u = _u(rng)
    want = g.copula_density(u, _corr(rho))
    got = np.asarray(gaussian.copula_density(u, _corr(rho)))
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_gaussian_density_3d(rng):
    g = ref("copulas.gaussian.gaussian")
    u = _u(rng, d=3)
    corr = np.array([[1.0, 0.3, 0.1], [0.3, 1.0, -0.2], [0.1, -0.2, 1.0]])
    want = g.copula_density(u, corr)
    got = np.asarray(gaussian.copula_density(u, corr))
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_gaussian_ifm_parity(rng):
    ifm = ref("copulas.gaussian.inference_for_margins")
    u = _u(rng)
    dens = rng.uniform(0.05, 1.0, size=u.shape)
    corr = _corr(0.5)
    want = ifm.GaussianMarginalLikelihoodInference(u, dens, corr).compute_marginal_likelihood()
    got = float(gaussian.ifm_log_likelihood(u, dens, corr))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_gaussian_nll_penalty(rng):
    u = _u(rng)
    dens = rng.uniform(0.05, 1.0, size=u.shape)
    # |rho| > 1 -> not PD -> penalty
    nll = float(gaussian.negative_log_likelihood(np.array([1.5]), u, dens, 2))
    assert nll == 1e10


# --- Student ----------------------------------------------------------------


@pytest.mark.parametrize("nu,rho", [(2.5, 0.5), (5.0, -0.6), (10.0, 0.0), (30.0, 0.9)])
def test_student_density_parity(rng, nu, rho):
    s = ref("copulas.student.student")
    u = _u(rng, n=200)
    want = s.copula_density(u, nu, _corr(rho))
    got = np.asarray(student.copula_density(u, nu, _corr(rho)))
    np.testing.assert_allclose(got, want, rtol=1e-7)


def test_student_density_3d(rng):
    s = ref("copulas.student.student")
    u = _u(rng, n=100, d=3)
    corr = np.array([[1.0, 0.4, 0.2], [0.4, 1.0, 0.1], [0.2, 0.1, 1.0]])
    want = s.copula_density(u, 7.0, corr)
    got = np.asarray(student.copula_density(u, 7.0, corr))
    np.testing.assert_allclose(got, want, rtol=1e-7)


def test_student_density_nan_on_saturated_marginals(rng):
    u = np.array([[0.5, 1.0], [0.0, 0.5], [0.3, 0.7]])
    got = np.asarray(student.copula_density(u, 5.0, _corr(0.5)))
    assert np.isnan(got[0]) and np.isnan(got[1]) and np.isfinite(got[2])


def test_student_ifm_parity(rng):
    ifm = ref("copulas.student.inference_for_margins")
    u = _u(rng, n=300)
    dens = rng.uniform(0.05, 1.0, size=u.shape)
    corr = _corr(0.4)
    want = ifm.MarginalLikelihoodInference(u, dens, 6.0, corr).compute_marginal_likelihood()
    got = float(student.ifm_log_likelihood(u, dens, 6.0, corr))
    np.testing.assert_allclose(got, want, rtol=1e-8)


# --- Plackett ---------------------------------------------------------------


@pytest.mark.parametrize("theta", [0.5, 1.0, 5.0, 50.0])
def test_plackett_density_parity(rng, theta):
    p = ref("copulas.plackett.plackett")
    u = _u(rng)
    want = p.copula_density(u, theta)
    got = np.asarray(plackett.copula_density(u, theta))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_plackett_rejects_non_bivariate(rng):
    with pytest.raises(ValueError):
        plackett.copula_density(_u(rng, d=3), 2.0)


def test_plackett_ifm_parity(rng):
    ifm = ref("copulas.plackett.inference_for_margins")
    u = _u(rng)
    dens = rng.uniform(0.05, 1.0, size=u.shape)
    want = ifm.MarginalLikelihoodInferencePlackett(u, dens, 3.0).compute_marginal_likelihood()
    got = float(plackett.ifm_log_likelihood(u, dens, 3.0))
    np.testing.assert_allclose(got, want, rtol=1e-10)


# --- packing ----------------------------------------------------------------


def test_corr_packing_roundtrip():
    corr = np.array([[1.0, 0.3, 0.1], [0.3, 1.0, -0.2], [0.1, -0.2, 1.0]])
    params = np.asarray(copulas.params_from_corr_matrix(corr))
    back = np.asarray(copulas.corr_matrix_from_params(params, 3))
    np.testing.assert_array_equal(back, corr)
    assert copulas.common.dim_from_n_params(len(params)) == 3


def test_corr_packing_matches_reference_fill_order(rng):
    opti = ref("copulas.gaussian.opti")
    o = opti.GaussianCopulaOptimizer(_u(rng, n=10, d=3), _u(rng, n=10, d=3))
    params = np.array([0.3, 0.1, -0.2])
    want = o.construct_correlation_matrix(params)
    got = np.asarray(copulas.corr_matrix_from_params(params, 3))
    np.testing.assert_array_equal(got, want)
