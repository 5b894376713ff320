"""ops/lbfgs.box_lbfgs_batch: batched bounded L-BFGS device program."""

import numpy as np

import jax.numpy as jnp

from copula_var.ops.lbfgs import PENALTY, box_lbfgs_batch


def _rosenbrock(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def test_batched_rosenbrock_converges():
    lo = np.array([-2.0, -2.0])
    hi = np.array([2.0, 2.0])
    x0 = np.array([[-1.2, 1.0], [0.0, 0.0], [1.5, -1.5]])
    xs, fs = box_lbfgs_batch(_rosenbrock, lo, hi, jnp.asarray(x0))
    xs, fs = np.asarray(xs), np.asarray(fs)
    np.testing.assert_allclose(xs, np.ones_like(xs), atol=1e-4)
    assert np.all(fs < 1e-8)


def test_bounds_are_respected():
    # unconstrained optimum (1, 1) lies OUTSIDE the box -> solution on
    # the (open) boundary approach, strictly inside bounds
    lo = np.array([-0.5, -0.5])
    hi = np.array([0.5, 0.5])
    xs, _ = box_lbfgs_batch(_rosenbrock, lo, hi,
                            jnp.asarray(np.zeros((2, 2))))
    xs = np.asarray(xs)
    assert np.all(xs > lo - 1e-12) and np.all(xs < hi + 1e-12)


def test_penalty_plateau_rejected():
    # loss is non-finite outside a disc: the linesearch must back off
    # (PENALTY plateau) and still converge to the interior optimum
    def loss(x):
        r2 = jnp.sum(x * x)
        v = jnp.sum((x - 0.3) ** 2)
        return jnp.where(r2 < 1.0, v, jnp.nan)

    xs, fs = box_lbfgs_batch(loss, np.array([-2.0, -2.0]),
                             np.array([2.0, 2.0]),
                             jnp.asarray(np.zeros((1, 2))))
    np.testing.assert_allclose(np.asarray(xs)[0], [0.3, 0.3], atol=1e-4)
    assert float(np.asarray(fs)[0]) < PENALTY


def test_f32_value_stall_terminates():
    # f32 inputs: the 1e-8 gradient criterion is unreachable; the
    # value-stall exit must terminate the loop with the optimum anyway
    lo = np.array([-2.0, -2.0], dtype=np.float32)
    hi = np.array([2.0, 2.0], dtype=np.float32)
    x0 = jnp.asarray(np.array([[-1.2, 1.0]], dtype=np.float32))
    xs, _ = box_lbfgs_batch(_rosenbrock, lo, hi, x0)
    np.testing.assert_allclose(np.asarray(xs)[0], [1.0, 1.0], atol=5e-2)
