"""Multi-device tests on the virtual 8-device CPU mesh (conftest forces
XLA_FLAGS=--xla_force_host_platform_device_count=8): day sharding, grid
sharding with psum, and the driver contract in __graft_entry__."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from copula_var.ops.grids import garch_grid, msm_grid
from copula_var.ops.quadrature import (
    CopulaSpec,
    garch_integrals,
    msm_integrals,
)
from copula_var.parallel import (
    grid_sharded_garch_integrals,
    make_mesh,
    sharded_garch_step,
    sharded_msm_step,
)

CORR = np.array([[1.0, 0.45], [0.45, 1.0]])


def _msm_problem(rng, T=16, n=24, q=3):
    uvols = np.sort(rng.uniform(0.5, 1.5, size=(2, q)), axis=1)
    x, dx = msm_grid(n)
    dens = np.exp(-0.5 * (x[None, None, :] / uvols[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * uvols[:, :, None]
    )
    fbs = rng.uniform(0.1, 1.0, size=(T, 2, q))
    fbs /= fbs.sum(axis=2, keepdims=True)
    fcombos = np.einsum("ti,tj->tij", fbs[:, 0], fbs[:, 1]).reshape(T, -1)
    bounds = np.column_stack([np.full(T, -100.0), rng.uniform(-4, -1, T)])
    return bounds, fbs, fcombos, x, dx, dens, uvols


def test_devices_available():
    assert len(jax.devices()) >= 8


def test_sharded_msm_matches_single_device(rng):
    mesh = make_mesh(n_devices=8)
    bounds, fbs, fcombos, x, dx, dens, uvols = _msm_problem(rng)
    w = np.array([0.5, 0.5])
    spec = CopulaSpec("student", (6.0, jnp.asarray(CORR)))
    out, mean_stat = sharded_msm_step(
        mesh, bounds, fbs, fcombos, x, dx, dens, uvols, w, spec
    )
    want = msm_integrals(bounds, fbs, fcombos, x, dx, dens, uvols, w, spec)
    np.testing.assert_allclose(np.asarray(out), np.asarray(want), rtol=1e-10)
    np.testing.assert_allclose(
        float(mean_stat), float(np.mean(np.asarray(want))), rtol=1e-10
    )


def test_sharded_garch_matches_single_device(rng):
    mesh = make_mesh(n_devices=4)
    T = 12
    x, dx = garch_grid(32)
    fv = rng.uniform(0.7, 1.5, size=(T, 2))
    bounds = np.column_stack([np.full(T, -100.0), rng.uniform(-4, -1, T)])
    w = np.array([0.5, 0.5])
    spec = CopulaSpec("gaussian", (jnp.asarray(CORR),))
    out = sharded_garch_step(mesh, bounds, fv, x, dx, w, spec)
    want = garch_integrals(bounds, fv, x, dx, w, spec)
    np.testing.assert_allclose(np.asarray(out), np.asarray(want), rtol=1e-10)


@pytest.mark.parametrize(
    "copula",
    ["gaussian", pytest.param("student", marks=pytest.mark.slow),
     "plackett"],
)
@pytest.mark.slow
def test_grid_sharded_psum_matches_dense(rng, copula):
    mesh = make_mesh(n_devices=8, axis_names=("grid",))
    T = 6
    x, dx = garch_grid(32)  # 32 % 8 == 0
    fv = rng.uniform(0.7, 1.5, size=(T, 2))
    bounds = np.column_stack([np.full(T, -100.0), rng.uniform(-4, -1, T)])
    w = np.array([0.5, 0.5])
    if copula == "gaussian":
        spec = CopulaSpec("gaussian", (jnp.asarray(CORR),))
    elif copula == "student":
        spec = CopulaSpec("student", (6.0, jnp.asarray(CORR)))
    else:
        spec = CopulaSpec("plackett", (3.0,))
    out = grid_sharded_garch_integrals(mesh, bounds, fv, x, dx, w, spec)
    want = garch_integrals(bounds, fv, x, dx, w, spec)
    np.testing.assert_allclose(np.asarray(out), np.asarray(want), rtol=1e-9)


def test_grid_sharding_requires_divisibility(rng):
    mesh = make_mesh(n_devices=8, axis_names=("grid",))
    x, dx = garch_grid(30)  # 30 % 8 != 0
    with pytest.raises(ValueError):
        grid_sharded_garch_integrals(
            mesh, np.zeros((2, 2)), np.ones((2, 2)), x, dx,
            np.array([0.5, 0.5]), CopulaSpec("plackett", (3.0,)),
        )


def test_graft_entry_contract():
    """Quick tier: entry() compiles + a small-mesh dry run (2 devices);
    the full 8-device dry run — the driver's own protocol — lives in the
    slow tier (it compiles many more programs: dim-3 engines, grid mesh)."""
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.all(np.isfinite(np.asarray(out)))
    ge.dryrun_multichip(2)


@pytest.mark.slow
def test_graft_entry_dryrun_full_mesh():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_sharded_cached_step_matches(rng):
    from copula_var.ops.quadrature import (
        garch_day_tensors,
        garch_integrals_cached,
        msm_day_tensors,
        msm_integrals_cached,
    )
    from copula_var.parallel import sharded_cached_step

    mesh = make_mesh(n_devices=8)
    bounds, fbs, fcombos, x, dx, dens, uvols = _msm_problem(rng)
    w = np.array([0.5, 0.5])
    spec = CopulaSpec("student", (6.0, jnp.asarray(CORR)))
    C = msm_day_tensors(fbs, x, uvols, spec)
    want = np.asarray(msm_integrals_cached(bounds, C, fcombos, x, dx, dens, w))
    got = np.asarray(
        sharded_cached_step(mesh, bounds, C, fcombos, x, dx, dens, w)
    )
    np.testing.assert_allclose(got, want, rtol=1e-11)

    # garch family (densities=None)
    xg, dxg = garch_grid(32)
    T = 16
    fv = rng.uniform(0.7, 1.5, size=(T, 2))
    bg = np.column_stack([np.full(T, -100.0), rng.uniform(-4, -1, T)])
    specg = CopulaSpec("gaussian", (jnp.asarray(CORR),))
    V = garch_day_tensors(fv, xg, specg)
    wantg = np.asarray(garch_integrals_cached(bg, V, xg, dxg, w))
    gotg = np.asarray(
        sharded_cached_step(mesh, bg, V, None, xg, dxg, None, w)
    )
    np.testing.assert_allclose(gotg, wantg, rtol=1e-11)


def test_sharded_bisection_solve_matches_host(rng):
    """The day-sharded full on-device bisection (one SPMD while_loop over
    the mesh) vs a host-driven f64 bisection with identical state."""
    from copula_var.ops.quadrature import (
        msm_day_tensors,
        msm_integrals_cached,
    )
    from copula_var.parallel import sharded_bisection_solve

    mesh = make_mesh(n_devices=8)
    bounds, fbs, fcombos, x, dx, dens, uvols = _msm_problem(rng)
    T = bounds.shape[0]
    w = np.array([0.5, 0.5])
    spec = CopulaSpec("student", (6.0, jnp.asarray(CORR)))
    C = msm_day_tensors(fbs, x, uvols, spec)

    lower = np.full(T, -7.5)
    upper = np.full(T, 0.0)
    entry_up = rng.uniform(-4.0, -1.0, size=T)
    prev_res = np.asarray(
        msm_integrals_cached(
            np.column_stack([np.full(T, -100.0), entry_up]),
            C, fcombos, x, dx, dens, w,
        )
    )
    ustack = np.ones(T, dtype=bool)
    tol = 1e-6

    got = np.asarray(
        sharded_bisection_solve(
            mesh, C, fcombos, dens, x, dx, w, lower, upper, prev_res,
            entry_up, ustack, 0.05, tol,
        )
    )

    lo, up = lower.copy(), upper.copy()
    pr, pu, us = prev_res.copy(), entry_up.copy(), ustack.copy()
    while np.any(up - lo > tol):
        mid = 0.5 * (lo + up)
        b = np.where(
            us[:, None], np.column_stack([lo, mid]), np.column_stack([mid, up])
        )
        mres = np.asarray(
            msm_integrals_cached(b, C, fcombos, x, dx, dens, w)
        )
        add = b[:, 0] == pu
        res = np.where(add, pr + mres, pr - mres)
        us = res < 0.05
        lo = np.where(us, mid, lo)
        up = np.where(us, up, mid)
        pr, pu = res, mid
    want = 0.5 * (lo + up)
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize(
    "copula",
    ["gaussian", pytest.param("student", marks=pytest.mark.slow)],
)
def test_grid_sharded_msm_psum_matches_dense(rng, copula):
    """MSM-family grid sharding: partial state sandwiches psum-reduced
    over the 'grid' axis must equal the dense single-device engine."""
    from copula_var.parallel import grid_sharded_msm_integrals

    mesh = make_mesh(n_devices=8, axis_names=("grid",))
    bounds, fbs, fcombos, x, dx, dens, uvols = _msm_problem(rng, T=6, n=32)
    w = np.array([0.6, 0.4])
    params = (6.0, jnp.asarray(CORR)) if copula == "student" else (
        jnp.asarray(CORR),
    )
    spec = CopulaSpec(copula, params)
    got = np.asarray(
        grid_sharded_msm_integrals(
            mesh, bounds, fbs, fcombos, x, dx, dens, uvols, w, spec
        )
    )
    want = np.asarray(
        msm_integrals(bounds, fbs, fcombos, x, dx, dens, uvols, w, spec)
    )
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.slow
def test_grid_sharded_msm_2d_mesh(rng):
    """2-D ('days', 'grid') mesh: days shard over one axis while each
    integral's grid rows shard over the other — the day x grid product
    that scales one backtest across many devices."""
    from copula_var.parallel import grid_sharded_msm_integrals

    mesh = make_mesh(n_devices=8, axis_names=("days", "grid"), shape=(2, 4))
    bounds, fbs, fcombos, x, dx, dens, uvols = _msm_problem(rng, T=6, n=32)
    w = np.array([0.5, 0.5])
    spec = CopulaSpec("student", (6.0, jnp.asarray(CORR)))
    got = np.asarray(
        grid_sharded_msm_integrals(
            mesh, bounds, fbs, fcombos, x, dx, dens, uvols, w, spec,
            grid_axis="grid", day_axis="days",
        )
    )
    want = np.asarray(
        msm_integrals(bounds, fbs, fcombos, x, dx, dens, uvols, w, spec)
    )
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_grid_sharded_msm_requires_divisibility(rng):
    from copula_var.parallel import grid_sharded_msm_integrals

    mesh = make_mesh(n_devices=8, axis_names=("grid",))
    bounds, fbs, fcombos, x, dx, dens, uvols = _msm_problem(rng, T=4, n=20)
    spec = CopulaSpec("gaussian", (jnp.asarray(CORR),))
    with pytest.raises(ValueError, match="divisible"):
        grid_sharded_msm_integrals(
            mesh, bounds, fbs, fcombos, x, dx, dens, uvols,
            np.array([0.5, 0.5]), spec,
        )
