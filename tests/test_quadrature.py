"""Golden parity: masked dense quadrature vs the reference's recursive
ragged-grid engine (`utils/calc_integral/*`), for both integrand families
and all three copulas, on dim = 2 (the reference's supported case)."""

import numpy as np
import pytest

from copula_var.ops.grids import garch_grid, msm_grid
from copula_var.ops.quadrature import (
    CopulaSpec,
    garch_integrals,
    halfspace_mask,
    msm_integrals,
)

from tests._reference import ref

N_POINTS = 24
WEIGHTS = np.array([0.5, 0.5])
CORR = np.array([[1.0, 0.45], [0.45, 1.0]])
NU = 6.0
THETA = 3.0

UNIQUE_VOLS = np.array([[0.6, 1.0, 1.5], [0.8, 1.1, 1.4]])  # (dim, q)


def _normal_densities(unique_vols, x):
    dim, q = unique_vols.shape
    out = np.zeros((dim, q, x.shape[0]))
    for i in range(dim):
        for j in range(q):
            s = unique_vols[i, j]
            out[i, j] = np.exp(-0.5 * (x / s) ** 2) / (np.sqrt(2 * np.pi) * s)
    return out


def _fbs(rng, T, dim, q):
    f = rng.uniform(0.1, 1.0, size=(T, dim, q))
    return f / f.sum(axis=2, keepdims=True)


def _fcombos(fbs):
    T, dim, q = fbs.shape
    out = np.zeros((T, q**dim))
    for t in range(T):
        out[t] = np.outer(fbs[t, 0], fbs[t, 1]).reshape(-1)
    return out


def _ref_integral(bounds_row, grids_params, integr_params_i, static_params,
                  copula_params, integrand, cop_dens, unpack, x_kind):
    cg = ref("utils.calc_integral.create_grids")
    ia = ref("utils.calc_integral.integration_algo")
    grids, step_sizes = cg.create_nested_grid(
        num_points=N_POINTS,
        dim=2,
        g=ia.var_function,
        var=np.asarray(bounds_row, dtype=float),
        lower_bound=-5,
        upper_bound=5,
        grids_generation_params=grids_params,
        weights=WEIGHTS,
    )
    return ia.multi_integral_function(
        grids=grids,
        step_sizes=step_sizes,
        integrated_function=integrand,
        copula_params=copula_params,
        integrations_params_i=integr_params_i,
        integrations_params_static=static_params,
        copula_density=cop_dens,
        unpack_copula_params=unpack,
    )


BOUNDS_CASES = [
    (-100.0, -3.0),
    (-3.5, -2.0),
    (-7.5, 0.0),
    (-2.0, 1.5),
]


@pytest.mark.parametrize("copula", ["student", "gaussian", "plackett"])
def test_msm_quadrature_parity(rng, copula):
    msm_int = ref(
        "utils.calc_integral.integration_functions.msm_integration_function"
    )
    x, dx = msm_grid(N_POINTS)
    dens = _normal_densities(UNIQUE_VOLS, x)
    dim, q = UNIQUE_VOLS.shape
    combos = np.stack(
        np.meshgrid(*[np.arange(q)] * dim, indexing="ij"), axis=-1
    ).reshape(-1, dim)
    T = len(BOUNDS_CASES)
    fbs = _fbs(rng, T, dim, q)
    fcombos = _fcombos(fbs)
    bounds = np.array(BOUNDS_CASES)

    if copula == "student":
        wrap = ref("utils.model_estimation.copula.student_estimation").StudentCopulaVaR
        packed = np.concatenate(([NU], CORR[np.triu_indices(2, k=1)]))
        spec = CopulaSpec("student", (NU, CORR))
    elif copula == "gaussian":
        wrap = ref("utils.model_estimation.copula.gaussian_estimation").GaussianCopulaVaR
        packed = CORR[np.triu_indices(2, k=1)]
        spec = CopulaSpec("gaussian", (CORR,))
    else:
        wrap = ref("utils.model_estimation.copula.plackett_estimation").PlackettCopulaVaR
        packed = THETA
        spec = CopulaSpec("plackett", (THETA,))

    want = np.array(
        [
            _ref_integral(
                bounds[t],
                (dens, x, dx, combos.astype(float)),
                [fbs[t], fcombos[t]],
                UNIQUE_VOLS,
                packed,
                msm_int.integrated_function,
                wrap.copula_density,
                wrap.unpack_copula_params,
                "msm",
            )
            for t in range(T)
        ]
    )
    got = np.asarray(
        msm_integrals(bounds, fbs, fcombos, x, dx, dens, UNIQUE_VOLS, WEIGHTS, spec)
    )
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-14)


@pytest.mark.parametrize("copula", ["student", "gaussian", "plackett"])
def test_garch_quadrature_parity(rng, copula):
    g_int = ref(
        "utils.calc_integral.integration_functions.garch_integration_function"
    )
    x, dx = garch_grid(N_POINTS)
    dim = 2
    ones = np.ones((dim, 1, x.shape[0]))
    zero_params = np.zeros((1, dim))
    T = len(BOUNDS_CASES)
    fvols = rng.uniform(0.7, 1.6, size=(T, dim))
    bounds = np.array(BOUNDS_CASES)

    if copula == "student":
        wrap = ref("utils.model_estimation.copula.student_estimation").StudentCopulaVaR
        packed = np.concatenate(([NU], CORR[np.triu_indices(2, k=1)]))
        spec = CopulaSpec("student", (NU, CORR))
    elif copula == "gaussian":
        wrap = ref("utils.model_estimation.copula.gaussian_estimation").GaussianCopulaVaR
        packed = CORR[np.triu_indices(2, k=1)]
        spec = CopulaSpec("gaussian", (CORR,))
    else:
        wrap = ref("utils.model_estimation.copula.plackett_estimation").PlackettCopulaVaR
        packed = THETA
        spec = CopulaSpec("plackett", (THETA,))

    want = np.array(
        [
            _ref_integral(
                bounds[t],
                (ones, x, dx, zero_params),
                [fvols[t]],
                None,
                packed,
                g_int.integrated_function,
                wrap.copula_density,
                wrap.unpack_copula_params,
                "garch",
            )
            for t in range(T)
        ]
    )
    got = np.asarray(garch_integrals(bounds, fvols, x, dx, WEIGHTS, spec))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-14)


def test_halfspace_mask_matches_reference_point_set():
    """The masked point set must equal the reference ragged grid rows."""
    cg = ref("utils.calc_integral.create_grids")
    ia = ref("utils.calc_integral.integration_algo")
    x, dx = msm_grid(N_POINTS)
    dens = np.ones((2, 1, x.shape[0]))
    params = np.zeros((1, 2))
    for lo, up in BOUNDS_CASES:
        grids, _ = cg.create_nested_grid(
            num_points=N_POINTS,
            dim=2,
            g=ia.var_function,
            var=np.array([lo, up]),
            lower_bound=-5,
            upper_bound=5,
            grids_generation_params=(dens, x, dx, params),
            weights=WEIGHTS,
        )
        mask = np.asarray(halfspace_mask(x, lo, up, WEIGHTS))
        ii, jj = np.nonzero(mask)
        pts = np.stack([x[ii], x[jj]], axis=1)
        assert pts.shape == grids.shape
        np.testing.assert_array_equal(pts, grids)


def test_garch_integral_is_probability_like(rng):
    """Over the full box with wide bounds, the integral approximates
    P(w.x <= upper) under the joint density — must land in [0, 1]."""
    x, dx = garch_grid(64)
    fvols = np.array([[1.0, 1.0]])
    spec = CopulaSpec("gaussian", (CORR,))
    full = float(
        garch_integrals(np.array([[-100.0, 100.0]]), fvols, x, dx, WEIGHTS, spec)[0]
    )
    assert 0.97 < full < 1.01
    # left-Riemann discretization bias on the non-uniform grid is ~0.02 at
    # n = 64 (reference-faithful; shrinks with num_points)
    half = float(
        garch_integrals(np.array([[-100.0, 0.0]]), fvols, x, dx, WEIGHTS, spec)[0]
    )
    np.testing.assert_allclose(half, 0.5, atol=0.05)


def test_cached_path_matches_direct(rng):
    """The bounds-invariant cached day tensors must reproduce the direct
    engine exactly (up to summation reassociation)."""
    from copula_var.ops.quadrature import (
        garch_day_tensors,
        garch_integrals_cached,
        msm_day_tensors,
        msm_integrals_cached,
    )

    # MSM
    x, dx = msm_grid(N_POINTS)
    dens = _normal_densities(UNIQUE_VOLS, x)
    dim, q = UNIQUE_VOLS.shape
    T = len(BOUNDS_CASES)
    fbs = _fbs(rng, T, dim, q)
    fcombos = _fcombos(fbs)
    bounds = np.array(BOUNDS_CASES)
    spec = CopulaSpec("student", (NU, CORR))
    want = np.asarray(
        msm_integrals(bounds, fbs, fcombos, x, dx, dens, UNIQUE_VOLS, WEIGHTS, spec)
    )
    C = msm_day_tensors(fbs, x, UNIQUE_VOLS, spec)
    got = np.asarray(
        msm_integrals_cached(bounds, C, fcombos, x, dx, dens, WEIGHTS)
    )
    np.testing.assert_allclose(got, want, rtol=1e-12)

    # GARCH
    xg, dxg = garch_grid(N_POINTS)
    fvols = rng.uniform(0.7, 1.6, size=(T, 2))
    specg = CopulaSpec("gaussian", (CORR,))
    wantg = np.asarray(garch_integrals(bounds, fvols, xg, dxg, WEIGHTS, specg))
    V = garch_day_tensors(fvols, xg, specg)
    gotg = np.asarray(garch_integrals_cached(bounds, V, xg, dxg, WEIGHTS))
    np.testing.assert_allclose(gotg, wantg, rtol=1e-12)


def test_transform_cached_matches_direct_dim2(rng):
    """The transform-cached engines (any-dim cache of the per-coordinate
    ppf work) must reproduce the direct engines exactly."""
    from copula_var.ops.quadrature import (
        garch_day_columns,
        garch_integrals_tcached,
        msm_day_columns,
        msm_integrals_tcached,
    )

    x, dx = msm_grid(N_POINTS)
    dens = _normal_densities(UNIQUE_VOLS, x)
    dim, q = UNIQUE_VOLS.shape
    T = len(BOUNDS_CASES)
    fbs = _fbs(rng, T, dim, q)
    fcombos = _fcombos(fbs)
    bounds = np.array(BOUNDS_CASES)
    for spec in (
        CopulaSpec("student", (NU, CORR)),
        CopulaSpec("gaussian", (CORR,)),
        CopulaSpec("plackett", (THETA,)),
    ):
        want = np.asarray(
            msm_integrals(
                bounds, fbs, fcombos, x, dx, dens, UNIQUE_VOLS, WEIGHTS, spec
            )
        )
        cols = msm_day_columns(fbs, x, UNIQUE_VOLS, spec)
        got = np.asarray(
            msm_integrals_tcached(
                bounds, cols, fcombos, x, dx, dens, WEIGHTS, spec,
                day_batch=2,
            )
        )
        np.testing.assert_allclose(got, want, rtol=1e-12)

    xg, dxg = garch_grid(N_POINTS)
    fvols = rng.uniform(0.7, 1.6, size=(T, 2))
    specg = CopulaSpec("gaussian", (CORR,))
    wantg = np.asarray(garch_integrals(bounds, fvols, xg, dxg, WEIGHTS, specg))
    tcols, p_cols = garch_day_columns(fvols, xg, specg)
    gotg = np.asarray(
        garch_integrals_tcached(
            bounds, tcols, p_cols, xg, dxg, WEIGHTS, specg, day_batch=3
        )
    )
    np.testing.assert_allclose(gotg, wantg, rtol=1e-12)


def test_transform_cached_matches_direct_dim3(rng):
    """dim = 3: the transform cache is the production fast path (full day
    tensors would be (T, n^3)); parity vs the direct engine."""
    from copula_var.ops.quadrature import (
        garch_day_columns,
        garch_integrals_tcached,
        msm_day_columns,
        msm_integrals_tcached,
    )

    n = 12
    dim, q, T = 3, 2, 5
    uvols = np.sort(rng.uniform(0.5, 1.6, size=(dim, q)), axis=1)
    x, dx = msm_grid(n)
    dens = _normal_densities(uvols, x)
    fbs = _fbs(rng, T, dim, q)
    fcombos = np.einsum("ti,tj,tk->tijk", fbs[:, 0], fbs[:, 1], fbs[:, 2])
    fcombos = fcombos.reshape(T, -1)
    bounds = np.column_stack(
        [np.full(T, -100.0), rng.uniform(-3.0, -1.0, size=T)]
    )
    w3 = np.array([0.4, 0.3, 0.3])
    corr3 = np.array([[1.0, 0.4, 0.2], [0.4, 1.0, 0.3], [0.2, 0.3, 1.0]])
    for spec in (
        CopulaSpec("student", (NU, corr3)),
        CopulaSpec("gaussian", (corr3,)),
    ):
        want = np.asarray(
            msm_integrals(bounds, fbs, fcombos, x, dx, dens, uvols, w3, spec)
        )
        cols = msm_day_columns(fbs, x, uvols, spec)
        got = np.asarray(
            msm_integrals_tcached(
                bounds, cols, fcombos, x, dx, dens, w3, spec, day_batch=2
            )
        )
        np.testing.assert_allclose(got, want, rtol=1e-12)

        xg, dxg = garch_grid(n)
        fvols = rng.uniform(0.7, 1.6, size=(T, dim))
        wantg = np.asarray(garch_integrals(bounds, fvols, xg, dxg, w3, spec))
        tcols, p_cols = garch_day_columns(fvols, xg, spec)
        gotg = np.asarray(
            garch_integrals_tcached(
                bounds, tcols, p_cols, xg, dxg, w3, spec, day_batch=2
            )
        )
        np.testing.assert_allclose(gotg, wantg, rtol=1e-12)
