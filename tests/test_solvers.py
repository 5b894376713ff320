"""On-device golden-section minimizer (ops/solvers.py)."""

import numpy as np

import jax.numpy as jnp

from copula_var.ops.solvers import golden_section_min


def test_golden_section_batched_quadratics():
    centers = jnp.asarray(np.array([-0.7, 0.0, 0.31, 42.0]))

    def f(x):
        # batch-size polymorphic ((k*B,) for k in {1, 2}): tile the
        # per-lane constants to the probe batch
        m = x.shape[0] // 4
        c = jnp.concatenate([centers] * m)
        return (x - c) ** 2 + jnp.concatenate([jnp.arange(4.0)] * m)

    lo = jnp.asarray(np.array([-1.0, -1.0, -1.0, 0.1]))
    hi = jnp.asarray(np.array([1.0, 1.0, 1.0, 100.0]))
    x, fx = golden_section_min(f, lo, hi)
    # golden's fp floor on a quadratic is ~sqrt(eps) * scale
    np.testing.assert_allclose(np.asarray(x), np.asarray(centers), atol=1e-6)
    np.testing.assert_allclose(np.asarray(fx), np.arange(4.0), atol=1e-12)


def test_golden_section_boundary_minimum():
    def f(x):
        return x  # minimum at the left endpoint

    x, _ = golden_section_min(f, jnp.array([2.0]), jnp.array([5.0]))
    np.testing.assert_allclose(np.asarray(x), [2.0], atol=1e-9)
