"""Multi-confidence-level VaR solve: `calc_var_levels` and the fused
multi-level Pallas solver vs per-level single solves.

The reference solves one confidence level per `calc_var()` call
(`calc_var_class.py:95`, `obj_var=0.05`); risk desks need the whole
(99%, 97.5%, 95%) ladder. Here all levels share the stage-1 sweep and the
bisections run batched — per-(level, day) semantics must match the
single-level solver to within the bisection tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from copula_var.backtest import create_var_backtest
from copula_var.data import synthetic_dataset
from copula_var.ops.grids import msm_grid
from copula_var.ops.quadrature import CopulaSpec, msm_day_tensors

LEVELS = (0.01, 0.05, 0.1)


@pytest.fixture(scope="module")
def garch_bt():
    data = synthetic_dataset(jax.random.PRNGKey(5), 240, 220,
                             spec=("garch", "garch"))
    return create_var_backtest(data, "garch", "gaussian", num_points=32,
                               p_max=1, q_max=1)


def test_calc_var_levels_matches_single(garch_bt):
    tol = 1e-6
    got = garch_bt.calc_var_levels(LEVELS, tolerance=tol)
    assert got.shape == (len(LEVELS), garch_bt.data.out_sample_n)
    for i, ov in enumerate(LEVELS):
        want = garch_bt.calc_var(obj_var=ov, tolerance=tol)
        # batched levels run to the slowest level's iteration count; the
        # extra halvings keep each midpoint inside the single-level final
        # bracket, so the two agree to the bisection tolerance
        np.testing.assert_allclose(got[i], want, atol=2 * tol)


def test_levels_monotone(garch_bt):
    got = garch_bt.calc_var_levels(LEVELS)
    # deeper quantile (smaller obj_var) -> more negative VaR
    assert np.all(got[0] <= got[1] + 1e-6)
    assert np.all(got[1] <= got[2] + 1e-6)


@pytest.mark.slow
def test_calc_var_levels_msm_student():
    data = synthetic_dataset(jax.random.PRNGKey(9), 230, 210)
    bt = create_var_backtest(data, "msm", "student", num_points=24,
                             k=2, basin_iter=5)
    got = bt.calc_var_levels((0.025, 0.05))
    want0 = bt.calc_var(obj_var=0.025)
    want1 = bt.calc_var(obj_var=0.05)
    np.testing.assert_allclose(got[0], want0, atol=2e-6)
    np.testing.assert_allclose(got[1], want1, atol=2e-6)


def test_pallas_levels_kernel_matches_single(rng):
    """L=2 fused multi-level launch vs two single-level launches: the
    level loop runs inside one program per day with the same f32 ops and
    the same iteration count per level -> exact in interpret mode."""
    from copula_var.ops.pallas_solver import msm_full_solve_pallas_levels

    n, q, T = 32, 3, 16
    x, dx = msm_grid(n)
    corr = np.array([[1.0, 0.45], [0.45, 1.0]])
    w = np.array([0.5, 0.5])
    uvols = np.sort(rng.uniform(0.5, 1.5, size=(2, q)), axis=1)
    dens = np.exp(-0.5 * (x[None, None, :] / uvols[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * uvols[:, :, None]
    )
    fbs = rng.uniform(0.1, 1.0, size=(T, 2, q))
    fbs /= fbs.sum(axis=2, keepdims=True)
    fcombos = np.einsum("ti,tj->tij", fbs[:, 0], fbs[:, 1]).reshape(T, -1)
    spec = CopulaSpec("student", (6.0, corr))
    C = jnp.asarray(msm_day_tensors(fbs, x, uvols, spec), jnp.float32)
    obj_vars = [0.01, 0.05]

    multi, _ = msm_full_solve_pallas_levels(
        C, fcombos, x, dx, dens, w, obj_vars, interpret=True,
    )
    assert multi.shape == (2, T)
    for i, ov in enumerate(obj_vars):
        single, _ = msm_full_solve_pallas_levels(
            C, fcombos, x, dx, dens, w, [ov], interpret=True,
        )
        np.testing.assert_array_equal(multi[i], single[0])


def test_pallas_engine_levels_matches_xla():
    data = synthetic_dataset(jax.random.PRNGKey(5), 240, 220,
                             spec=("garch", "garch"))
    kwargs = dict(num_points=32, p_max=1, q_max=1)
    bt_x = create_var_backtest(data, "garch", "gaussian", **kwargs)
    want = bt_x.calc_var_levels(LEVELS)
    bt_p = create_var_backtest(data, "garch", "gaussian", engine="pallas",
                               interpret=True, **kwargs)
    got = bt_p.calc_var_levels(LEVELS)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_config_obj_levels(garch_bt):
    """`SolverConfig.obj_levels` drives the batched ladder through
    `run_backtest`."""
    from copula_var.config import BacktestConfig, run_backtest

    cfg = BacktestConfig(estimation_type="garch", copula_type="gaussian",
                         num_points=32)
    cfg.garch.p_max = cfg.garch.q_max = 1
    cfg.solver.obj_levels = (0.025, 0.05)
    bt, ladder = run_backtest(garch_bt.data, cfg)
    assert ladder.shape == (2, garch_bt.data.out_sample_n)
    # roundtrip keeps the ladder knob
    back = BacktestConfig.from_dict(cfg.to_dict())
    assert tuple(back.solver.obj_levels) == (0.025, 0.05)


def test_calc_var_grid_outer_product(rng):
    """calc_var_grid: the (P, L, T) outer product equals per-cell
    calc_var of a per-weights backtest at each level (one dispatch)."""
    from copula_var.backtest import GarchAdapter, VaRBacktest
    from copula_var.copulas.fit import GaussianFit
    from copula_var.data import returns as returns_mod
    from copula_var.models.fit import GarchFit

    n_in, T = 140, 20
    rets = rng.standard_normal((n_in + T, 2))
    fits = [
        GarchFit(1, 1, 0.2, np.array([0.1]), np.array([0.7]), 0.0, 0.0,
                 np.array([0.2, 0.1, 0.7]))
        for _ in range(2)
    ]

    def bt(weights):
        return VaRBacktest(
            returns_mod.from_returns(rets, n_insample=n_in,
                                     weights=weights),
            GarchAdapter(p_max=1, q_max=1), "gaussian", num_points=24,
            engine="xla", model_fits_override=fits,
            copula_fit_override=GaussianFit(np.eye(2), 0.0, np.zeros(1)),
        )

    W = np.array([[0.5, 0.5], [0.3, 0.7]])
    alphas = (0.01, 0.05)
    grid = bt([0.5, 0.5]).calc_var_grid(W, alphas)
    assert grid.shape == (2, 2, T)
    for p in range(2):
        solo = bt(list(W[p]))
        for l, a in enumerate(alphas):
            np.testing.assert_allclose(grid[p, l], solo.calc_var(a),
                                       atol=1e-9)
