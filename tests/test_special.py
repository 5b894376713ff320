"""Golden tests for distribution special functions vs scipy (f64)."""

import numpy as np
import scipy.stats as st
from scipy.special import erf

from copula_var.ops import (
    norm_cdf,
    norm_pdf,
    norm_ppf,
    t_cdf,
    t_pdf,
    t_ppf,
    t_sf,
)


def test_norm_pdf_cdf_match_reference_formulas(rng):
    x = rng.normal(size=(64, 3)) * 3
    np.testing.assert_allclose(np.asarray(norm_pdf(x)), st.norm.pdf(x), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(norm_cdf(x)), st.norm.cdf(x), rtol=1e-13)
    # Reference cdf is the erf form (utils/utils.py:4-22); ndtr agrees to
    # absolute fp64 precision (erf form cancels in the deep lower tail).
    ref = 0.5 * (1 + erf(x / np.sqrt(2)))
    np.testing.assert_allclose(np.asarray(norm_cdf(x)), ref, atol=1e-15)
    # scaled variants
    np.testing.assert_allclose(
        np.asarray(norm_pdf(x, std=0.37)), st.norm.pdf(x, scale=0.37), rtol=1e-12
    )


def test_norm_ppf(rng):
    p = rng.uniform(1e-12, 1 - 1e-12, size=500)
    np.testing.assert_allclose(np.asarray(norm_ppf(p)), st.norm.ppf(p), rtol=1e-10)


def test_t_pdf_cdf_sf(rng):
    x = rng.normal(size=300) * 5
    for nu in [2.01, 2.5, 5.0, 10.0, 30.0, 50.0]:
        np.testing.assert_allclose(
            np.asarray(t_pdf(x, nu)), st.t.pdf(x, df=nu), rtol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(t_cdf(x, nu)), st.t.cdf(x, df=nu), rtol=1e-11, atol=1e-15
        )
        np.testing.assert_allclose(
            np.asarray(t_sf(x, nu)), st.t.sf(x, df=nu), rtol=1e-11, atol=1e-15
        )


def test_t_ppf_body_and_tails(rng):
    p_body = rng.uniform(0.001, 0.999, size=400)
    p_tail = np.concatenate(
        [10.0 ** rng.uniform(-60, -3, size=200), 1 - 10.0 ** rng.uniform(-15, -3, 200)]
    )
    p_all = np.concatenate([p_body, p_tail])  # one call/compile per nu
    for nu in [2.01, 3.0, 10.0, 50.0]:
        got = np.asarray(t_ppf(p_all, nu))
        want = st.t.ppf(p_all, df=nu)
        # accuracy floor set by betainc near p=0.5 (~1e-10 relative on
        # quantiles that are themselves ~1e-3)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)


def test_t_ppf_deep_tail_selfconsistent(rng):
    # scipy's own ppf overflows below ~1e-200; check ppf∘cdf identity instead.
    p = 10.0 ** rng.uniform(-250, -50, size=100)
    for nu in [2.01, 4.0, 12.0]:
        x = np.asarray(t_ppf(p, nu))
        assert np.all(np.isfinite(x)) and np.all(x < 0)
        p_back = np.asarray(t_cdf(x, nu))
        np.testing.assert_allclose(p_back, p, rtol=1e-10)


def test_t_ppf_edges():
    nu = 5.0
    out = np.asarray(t_ppf(np.array([0.0, 0.5, 1.0]), nu))
    assert out[0] == -np.inf and out[2] == np.inf and out[1] == 0.0
    assert np.isnan(np.asarray(t_ppf(np.array([-0.1, 1.1]), nu))).all()


def test_t_ppf_roundtrip(rng):
    # |x| capped so p stays away from 1.0 by >> 1 ulp: the upper-tail
    # roundtrip through p is ill-conditioned once 1 - p ~ 1e-16 (true of
    # scipy as well); the well-represented lower tail is covered by
    # test_t_ppf_deep_tail_selfconsistent.
    x = rng.normal(size=200) * 2
    for nu in [2.5, 8.0, 25.0]:
        p = np.asarray(t_cdf(x, nu))
        np.testing.assert_allclose(np.asarray(t_ppf(p, nu)), x, rtol=1e-8, atol=1e-8)
