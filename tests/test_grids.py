"""Parity tests for the non-uniform quadrature grid builders."""

import numpy as np

from copula_var.ops import garch_grid, msm_grid


def _reference_grid(num_points, outer_div, middle_div, x_min=-5, x_max=5):
    # Clean-room re-statement of msm_estimation.py:302-319 /
    # garch_estimation.py:167-183 semantics.
    outer = num_points // outer_div
    middle = num_points // middle_div
    central = num_points - 2 * outer - 2 * middle
    x = np.concatenate(
        [
            np.linspace(x_min, -2.5, outer, endpoint=False),
            np.linspace(-2.5, -1, middle, endpoint=False),
            np.linspace(-1, 1, central, endpoint=False),
            np.linspace(1, 2.5, middle, endpoint=False),
            np.linspace(2.5, x_max, outer, endpoint=True),
        ]
    )
    step = np.diff(x, prepend=x[0])
    step[0] = step[1]
    return x, step


def test_msm_grid_layout():
    for n in (100, 64, 257):
        x, s = msm_grid(n)
        rx, rs = _reference_grid(n, 4, 7)
        assert x.shape == (n,)
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(s, rs)
        assert x[0] == -5 and x[-1] == 5
        assert np.all(np.diff(x) > 0)


def test_garch_grid_layout():
    for n in (100, 80):
        x, s = garch_grid(n)
        rx, rs = _reference_grid(n, 8, 5)
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(s, rs)


def test_step_zero_equals_step_one():
    x, s = msm_grid(100)
    assert s[0] == s[1]
