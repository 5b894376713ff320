"""Parity: vectorized Student-t fixture sampler vs the reference's scalar
bisection pipeline (`copulas/student/generate.py`, numba stub)."""

import numpy as np

from copula_var.copulas import student_sampler

from tests._reference import ref


def test_approx_t_cdf_parity():
    g = ref("copulas.student.generate")
    xs = np.linspace(-8, 8, 41)
    for nu in [1, 3, 5, 10]:
        want = np.array([g.t_cdf(float(x), nu) for x in xs])
        got = student_sampler.approx_t_cdf(xs, nu)
        np.testing.assert_allclose(got, want, rtol=1e-13)


def test_inverse_approx_t_cdf_parity():
    g = ref("copulas.student.generate")
    us = np.linspace(0.05, 0.95, 19)
    for nu in [3, 5]:
        want = np.array([g.inverse_t_cdf(float(u), nu) for u in us])
        got = student_sampler.inverse_approx_t_cdf(us, nu)
        np.testing.assert_allclose(got, want, atol=2e-6)


def test_t_copula_value_parity(rng):
    g = ref("copulas.student.generate")
    u = rng.uniform(0.05, 0.95, size=(50, 2))
    want = np.array([g.t_copula(a, b, 0.5, 5) for a, b in u])
    got = student_sampler.t_copula_value(u[:, 0], u[:, 1], 0.5, 5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-8)


def test_generated_fixture_matches_reference_small():
    """Full pipeline parity on a downscaled run (n=2000, top 50)."""
    g = ref("copulas.student.generate")
    want_m, want_d = g.generate_student_t_copula_data(n=2000, nu=5, rho=0.5, top_n=50)
    got_m, got_d = student_sampler.generate_student_t_copula_data(
        n=2000, nu=5, rho=0.5, top_n=50
    )
    np.testing.assert_allclose(got_m, want_m, rtol=1e-10)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-6)


def test_default_fixture_shape_and_determinism():
    m1, d1 = student_sampler.generate_student_t_copula_data(n=5000, top_n=100)
    m2, d2 = student_sampler.generate_student_t_copula_data(n=5000, top_n=100)
    assert m1.shape == (100, 2) and d1.shape == (100, 2)
    np.testing.assert_array_equal(m1, m2)
    assert np.all((m1 > 0) & (m1 < 1))
