"""Fused Pallas solver (`ops/pallas_solver.py`, Triton route) vs the f64
XLA engine and a host-driven f64 solve. The kernel runs in interpret mode
here (`interpret=True`); `chip_smoke.py` phase 3 runs it compiled for the
GPU."""

import numpy as np
import pytest

import jax.numpy as jnp

from copula_var.ops.grids import garch_grid, msm_grid
from copula_var.ops.pallas_solver import root_plateau_bound
from copula_var.ops.quadrature import (
    CopulaSpec,
    garch_day_tensors,
    garch_integrals_cached,
    msm_day_tensors,
    msm_integrals_cached,
)

CORR = np.array([[1.0, 0.45], [0.45, 1.0]])
WEIGHTS = np.array([0.5, 0.5])
# bounds chosen off the grid lattice: when a dynamic bound lands exactly
# on a grid point the strict/inclusive mask comparisons legitimately
# differ between the f32 kernel and the f64 reference path
BOUNDS = np.array(
    [(-100.0, -3.0041), (-3.5137, -2.0093), (-7.5, 0.0127), (-2.0061, 1.5029),
     (-100.0, 1.0171), (-1.0087, -0.5113), (-6.0031, -4.0057), (-100.0, 100.0)]
)


def _msm_problem(rng, n=32, q=3, T=16):
    x, dx = msm_grid(n)
    uvols = np.sort(rng.uniform(0.5, 1.5, size=(2, q)), axis=1)
    dens = np.exp(-0.5 * (x[None, None, :] / uvols[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * uvols[:, :, None]
    )
    fbs = rng.uniform(0.1, 1.0, size=(T, 2, q))
    fbs /= fbs.sum(axis=2, keepdims=True)
    fcombos = np.einsum("ti,tj->tij", fbs[:, 0], fbs[:, 1]).reshape(T, -1)
    C = msm_day_tensors(fbs, x, uvols, CopulaSpec("student", (6.0, CORR)))
    return x, dx, dens, fcombos, np.asarray(C)


def _tiny_backtest(family, engine, n_points=24, T=13, weights=WEIGHTS,
                   **kw):
    from copula_var.backtest import GarchAdapter, MsmAdapter, VaRBacktest
    from copula_var.copulas.fit import StudentFit
    from copula_var.data.returns import from_returns
    from copula_var.models.fit import GarchFit, MsmFit

    n_in = 60
    rets = np.random.default_rng(3).multivariate_normal(
        np.zeros(2), CORR, size=n_in + T)
    data = from_returns(rets, ["A", "B"], n_in, np.asarray(weights))
    if family == "garch":
        adapter = GarchAdapter()
        fits = [GarchFit(1, 1, 0.05, np.array([0.08]), np.array([0.88]),
                         0.0, 0.0, np.array([0.05, 0.08, 0.88]))] * 2
    else:
        adapter = MsmAdapter(k=2)
        fits = [
            MsmFit(m_0=0.45, b=3.0, gamma=0.5, sigma=1.0,
                   log_likelihood=0.0),
            MsmFit(m_0=0.55, b=5.0, gamma=0.3, sigma=1.15,
                   log_likelihood=0.0),
        ]
    return VaRBacktest(
        data, adapter, "student", num_points=n_points, engine=engine,
        model_fits_override=fits,
        copula_fit_override=StudentFit(6.0, CORR, 0.0,
                                       np.array([6.0, 0.45])),
        **kw,
    )


def test_pallas_engine_backtest_matches_xla():
    """engine='pallas' end-to-end: the fused f32 kernel drives the whole
    solve; VaR must match the f64 XLA engine within the plateau bound."""
    import jax

    from copula_var.backtest import create_var_backtest
    from copula_var.data import synthetic_dataset

    data = synthetic_dataset(jax.random.PRNGKey(5), 240, 220,
                             spec=("garch", "garch"))
    kwargs = dict(num_points=32, p_max=1, q_max=1)
    bt_x = create_var_backtest(data, "garch", "gaussian", **kwargs)
    var_x = bt_x.calc_var(obj_var=0.05)
    bt_p = create_var_backtest(data, "garch", "gaussian", engine="pallas",
                               interpret=True, **kwargs)
    var_p = bt_p.calc_var(obj_var=0.05)
    assert np.all(np.isfinite(var_p))
    # DERIVED per-config plateau bound, not a hard-coded atol: any kernel
    # change that worsens roots beyond one grid cell turns red
    bound = root_plateau_bound(bt_x.integration_inputs.dx, data.weights)
    np.testing.assert_allclose(var_p, var_x, atol=bound)
    med = root_plateau_bound(
        np.median(np.asarray(bt_x.integration_inputs.dx), keepdims=True),
        data.weights,
    )
    assert np.quantile(np.abs(var_p - var_x), 0.9) <= med


def test_pallas_engine_requires_dim2_or_3():
    """engine='pallas' is dim 2 only: dim 3 and dim 4 raise the documented
    ValueError (dim >= 3 runs on the f64 engines)."""
    import jax

    from copula_var.backtest import create_var_backtest
    from copula_var.data import synthetic_dataset

    for dim in (3, 4):
        data = synthetic_dataset(jax.random.PRNGKey(6), 240, 220,
                                 spec=("garch",) * dim)
        bt = create_var_backtest(data, "garch", "gaussian", engine="pallas",
                                 num_points=16, p_max=1, q_max=1,
                                 interpret=True)
        with pytest.raises(ValueError, match="pallas"):
            bt.compute_integral(
                np.array([[-100.0, -3.0]] * data.out_sample_n))


def test_fused_bisection_solver_matches_host(rng):
    """One-launch fused solve (bracketing + bisection in the kernel) vs a
    host-driven f64 solve with the reference's semantics
    (`calc_var_class.py:95-155,250-309`)."""
    from copula_var.ops.pallas_solver import msm_full_solve_pallas_levels

    x, dx, dens, fcombos, C = _msm_problem(rng)
    T = C.shape[0]
    obj, tol = 0.05, 1e-6
    fg, sg0, sg1, lo_v, hi_v = -3.0, -3.5, -2.0, -7.5, 0.0
    roots, nan_days = msm_full_solve_pallas_levels(
        jnp.asarray(C, jnp.float32), fcombos, x, dx, dens, WEIGHTS, [obj],
        tolerance=tol, interpret=True,
    )
    assert roots.shape == (1, T) and not nan_days.any()

    def sweep(b):
        return np.asarray(
            msm_integrals_cached(b, C, fcombos, x, dx, dens, WEIGHTS))

    F1 = sweep(np.column_stack([np.full(T, -100.0), np.full(T, fg)]))
    new_lo = np.where(F1 >= obj, sg0, fg)
    new_up = np.where(F1 < obj, sg1, fg)
    res = F1 + np.where(new_lo == fg, 1.0, -1.0) * sweep(
        np.column_stack([new_lo, new_up]))
    pu = np.where(new_lo == sg0, sg0, sg1)
    lo, up = np.full(T, lo_v), np.full(T, hi_v)
    for m, a, b in ((res > obj, lo_v, sg0),
                    ((res < obj) & (new_up == fg), sg0, fg),
                    ((res < obj) & (new_up == sg1), sg1, hi_v),
                    ((res > obj) & (new_up == sg1), fg, sg1)):
        lo, up = np.where(m, a, lo), np.where(m, b, up)
    us = ~np.isin(up, [sg0, sg1])
    pr = res
    while np.any(up - lo > tol):
        mid = 0.5 * (lo + up)
        b = np.where(
            us[:, None], np.column_stack([lo, mid]), np.column_stack([mid, up])
        )
        mres = sweep(b)
        res = np.where(b[:, 0] == pu, pr + mres, pr - mres)
        us = res < obj
        lo = np.where(us, mid, lo)
        up = np.where(us, up, mid)
        pr, pu = res, mid
    # derived plateau bound: f32 CDF error can flip one grid cell at most
    np.testing.assert_allclose(
        roots[0], 0.5 * (lo + up), atol=root_plateau_bound(dx, WEIGHTS)
    )


def test_f32_saturated_marginals_stay_finite(rng):
    """f32 CDF desaturation (`ops/quadrature.desaturate_f32`): a day with
    an extreme vol saturates f32 norm_cdf at ~5.3 sigma; without the
    clamp the whole day's tensor NaNs while the f64 engine stays finite
    on the same inputs. The clamp is f32-only — the f64 path keeps the
    reference's NaN-on-saturation parity."""
    n, q, T = 32, 3, 4
    x, dx = msm_grid(n)
    # one tiny vol level: x/vol reaches hundreds of sigma -> u == 1.0 f32
    uvols = np.array([[0.02, 0.5, 1.0], [0.5, 1.0, 1.5]])
    fbs = np.full((T, 2, q), 1.0 / q)
    spec = CopulaSpec("student", (6.0, CORR))
    C32 = msm_day_tensors(
        jnp.asarray(fbs, jnp.float32), jnp.asarray(x, jnp.float32),
        jnp.asarray(uvols, jnp.float32), spec,
    )
    assert np.all(np.isfinite(np.asarray(C32))), "f32 day tensor NaN'd"
    # f64: the same build is untouched by the clamp (parity behavior)
    C64 = msm_day_tensors(fbs, x, uvols, spec)
    assert C64.dtype == jnp.float64


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_weight_tiles_equal_masked_sandwich(rng, family):
    """The kernel's per-day weight tile P = v * (w0^T fc w1) turns one
    masked sandwich sweep into a masked sum: sum(mask * P) equals the XLA
    cached sweep for both families (q = 3 and the q = 1 GARCH case)."""
    from copula_var.ops.pallas_solver import _family_weights, _weight_tiles
    from copula_var.ops.quadrature import halfspace_mask

    T = len(BOUNDS)
    if family == "msm":
        x, dx, dens, fcombos, C = _msm_problem(rng, T=T)
        want = msm_integrals_cached(BOUNDS, C, fcombos, x, dx, dens, WEIGHTS)
    else:
        x, dx = garch_grid(32)
        C = np.asarray(garch_day_tensors(
            rng.uniform(0.7, 1.5, size=(T, 2)), x,
            CopulaSpec("gaussian", (CORR,))))
        dens = fcombos = None  # the q = 1 family
        want = garch_integrals_cached(BOUNDS, C, x, dx, WEIGHTS)
    P, nan_days = _weight_tiles(C, *_family_weights(dx, dens, fcombos, T))
    got = [
        float(np.sum(np.where(
            halfspace_mask(jnp.asarray(x), b[0], b[1],
                           jnp.asarray(WEIGHTS)), P[t], 0.0)))
        for t, b in enumerate(BOUNDS)
    ]
    assert not np.asarray(nan_days).any()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("family", ["msm", "garch"])
def test_pallas_engine_pads_n100_odd_days(family):
    """num_points = 100 pads to a 128 x 128 tile (x = +inf, zero weights
    on the pad) and T = 13 days run one program each: roots match the
    f64 xla engine within the plateau bound, L = 1 and L = 3."""
    from copula_var.ops.pallas_solver import _pow2

    assert _pow2(100) == 128
    bt_x = _tiny_backtest(family, "xla", n_points=100)
    bt_p = _tiny_backtest(family, "pallas", n_points=100, interpret=True)
    bound = root_plateau_bound(bt_x.integration_inputs.dx, WEIGHTS)
    np.testing.assert_allclose(bt_p.calc_var(0.05), bt_x.calc_var(0.05),
                               atol=bound)
    lv = (0.01, 0.05, 0.1)
    np.testing.assert_allclose(bt_p.calc_var_levels(lv),
                               bt_x.calc_var_levels(lv), atol=bound)


def test_kernel_nan_day_isolated(rng):
    """A NaN day tensor NaNs ONLY its own root and is flagged in
    nan_days; every other day's root is bit-identical to the run without
    it."""
    from copula_var.ops.pallas_solver import msm_full_solve_pallas_levels

    x, dx, dens, fcombos, C = _msm_problem(rng, T=8)
    kw = dict(interpret=True, tolerance=1e-6)
    clean, nd0 = msm_full_solve_pallas_levels(C, fcombos, x, dx, dens,
                                              WEIGHTS, [0.01, 0.05], **kw)
    C = C.copy()
    C[3] = np.nan  # reference-parity 0/0-density day
    got, nd = msm_full_solve_pallas_levels(C, fcombos, x, dx, dens, WEIGHTS,
                                           [0.01, 0.05], **kw)
    assert not nd0.any() and nd.tolist() == [i == 3 for i in range(8)]
    assert np.all(np.isnan(got[:, 3]))
    ok = np.arange(8) != 3
    np.testing.assert_array_equal(got[:, ok], clean[:, ok])


def test_pallas_portfolios_within_row_plateau_bound():
    """Portfolio rows (including a short position) ride the kernel's
    level axis: each row matches the f64 xla batch within ITS OWN
    plateau bound (one cell x |weights[0]| of that row)."""
    W = np.array([[0.5, 0.5], [0.9, 0.1], [0.2, 0.8], [1.2, -0.2]])
    want = _tiny_backtest("msm", "xla").calc_var_portfolios(W, 0.05)
    bt_p = _tiny_backtest("msm", "pallas", interpret=True)
    got = bt_p.calc_var_portfolios(W, 0.05)
    dx = bt_p.integration_inputs.dx
    for l in range(len(W)):
        np.testing.assert_allclose(got[l], want[l],
                                   atol=root_plateau_bound(dx, W[l]))


@pytest.mark.parametrize("engine", ["pallas", "sharded_pallas"])
def test_pallas_engines_refuse_cpu_without_interpret(engine):
    """Off the GPU the fused engines never fall back silently: without
    interpret=True they raise instead of running in the interpreter."""
    bt = _tiny_backtest("garch", engine)
    with pytest.raises(ValueError, match="interpret=True"):
        bt.calc_var(0.05)


@pytest.mark.parametrize(
    "n,tile,warps", [(24, 32, 4), (100, 128, 8), (128, 128, 8),
                     (200, 256, 8)]
)
def test_tile_and_warp_choice(n, tile, warps):
    """The wrapper picks the tile (next power of two >= n, Triton block
    sizes are powers of two) and the warps per program from the shapes."""
    from copula_var.ops.pallas_solver import _num_warps, _pow2

    assert _pow2(n) == tile
    assert _num_warps(tile) == warps
