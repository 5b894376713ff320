"""Native C++ grid builder vs the reference recursion and the JAX engine."""

import numpy as np
import pytest

from copula_var import native
from copula_var.ops.grids import garch_grid, msm_grid
from copula_var.ops.quadrature import (
    CopulaSpec,
    garch_day_tensors,
    garch_integrals,
    halfspace_mask,
)

from tests._reference import ref

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)

WEIGHTS = np.array([0.5, 0.5])
BOUNDS = [(-100.0, -3.0), (-3.5, -2.0), (-7.5, 0.0), (-2.0, 1.5)]


def test_native_grid_matches_reference(rng):
    cg = ref("utils.calc_integral.create_grids")
    ia = ref("utils.calc_integral.integration_algo")
    n = 24
    x, dx = msm_grid(n)
    q = 3
    uvols = np.sort(rng.uniform(0.5, 1.5, size=(2, q)), axis=1)
    dens = np.exp(-0.5 * (x[None, None, :] / uvols[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * uvols[:, :, None]
    )
    combos = np.stack(
        np.meshgrid(np.arange(q), np.arange(q), indexing="ij"), axis=-1
    ).reshape(-1, 2)
    for lo, up in BOUNDS:
        want_g, want_d = cg.create_nested_grid(
            num_points=n, dim=2, g=ia.var_function, var=np.array([lo, up]),
            lower_bound=-5, upper_bound=5,
            grids_generation_params=(dens, x, dx, combos.astype(float)),
            weights=WEIGHTS,
        )
        got_g, got_d = native.build_nested_grid(
            x, dx, dens, combos, lo, up, WEIGHTS
        )
        np.testing.assert_array_equal(got_g, want_g)
        np.testing.assert_allclose(got_d, want_d, rtol=1e-14)


def test_native_masked_integrals_match_jax(rng):
    x, dx = garch_grid(32)
    T = 6
    fv = rng.uniform(0.7, 1.5, size=(T, 2))
    bounds = np.array(BOUNDS + [(-100.0, -1.0), (-100.0, 100.0)])[:T]
    corr = np.array([[1.0, 0.45], [0.45, 1.0]])
    spec = CopulaSpec("gaussian", (corr,))
    V = np.asarray(garch_day_tensors(fv, x, spec))
    got = native.masked_integrals(V, x, dx, bounds, WEIGHTS)
    want = np.asarray(garch_integrals(bounds, fv, x, dx, WEIGHTS, spec))
    np.testing.assert_allclose(got, want, rtol=1e-10)
