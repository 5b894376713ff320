"""Sharded quadrature: day-parallel pjit and grid-parallel shard_map.

Two sharding strategies for the masked dense quadrature engine
(`ops/quadrature.py`), replacing the reference's joblib process fan-out
(`utils/calc_integral/calc_integral.py:211-223`):

  * **Day sharding** (`sharded_msm_step` / `sharded_garch_step`): the T
    out-of-sample days are placed on the mesh's 'days' axis with
    `NamedSharding`; each device runs the vmapped per-day kernel on its
    shard and XLA inserts no cross-device traffic except the final
    all-gather of the (T,) result and a `psum`-reduced summary statistic
    computed inside `shard_map` (exercises the collective path).
  * **Grid sharding** (`grid_sharded_garch_integrals`): for large
    num_points the outer grid dimension is split across devices inside
    `shard_map`; each device computes a partial masked sandwich over its
    coordinate rows and the scalar partials are `psum`-reduced — the
    pattern that scales a single huge integral across many devices.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from copula_var.ops.quadrature import (
    _HIGHEST,
    CopulaSpec,
    _mm,
    garch_integral_day,
    msm_integral_day,
)
from copula_var.ops.special import norm_cdf, norm_pdf


def _put(mesh, arr, spec):
    return jax.device_put(jnp.asarray(arr), NamedSharding(mesh, spec))


def sharded_msm_step(mesh: Mesh, bounds, fbs, fcombos, x, dx, densities,
                     unique_vols, weights, spec: CopulaSpec):
    """Day-sharded MSM quadrature sweep.

    Returns ((T,) integrals, psum-reduced mean integral). The mean is
    computed inside shard_map with an explicit `psum` over the 'days'
    axis — the convergence statistic a sharded bisection driver consumes
    without gathering the full result.
    """
    bounds_s = _put(mesh, bounds, P("days"))
    fbs_s = _put(mesh, fbs, P("days"))
    fcombos_s = _put(mesh, fcombos, P("days"))
    x, dx = jnp.asarray(x), jnp.asarray(dx)
    densities = jnp.asarray(densities)
    unique_vols = jnp.asarray(unique_vols)
    weights = jnp.asarray(weights)
    T = bounds_s.shape[0]

    @functools.partial(
        jax.jit,
        in_shardings=(
            NamedSharding(mesh, P("days")),
            NamedSharding(mesh, P("days")),
            NamedSharding(mesh, P("days")),
        ),
        out_shardings=(NamedSharding(mesh, P("days")), None),
    )
    def step(b, f, c):
        integrals = jax.vmap(
            lambda bi, fi, ci: msm_integral_day(
                bi, fi, ci, x, dx, densities, unique_vols, weights, spec
            )
        )(b, f, c)

        def local_mean(vals):
            s = jax.lax.psum(jnp.sum(vals), "days")
            return jnp.full((vals.shape[0],), s / T)

        mean = jax.shard_map(
            local_mean,
            mesh=mesh,
            in_specs=P("days"),
            out_specs=P("days"),
        )(integrals)
        return integrals, mean[0]

    return step(bounds_s, fbs_s, fcombos_s)


def sharded_garch_step(mesh: Mesh, bounds, forecast_vols, x, dx, weights,
                       spec: CopulaSpec):
    """Day-sharded GARCH/mean-reverting quadrature sweep -> (T,)."""
    bounds_s = _put(mesh, bounds, P("days"))
    fv_s = _put(mesh, forecast_vols, P("days"))
    x, dx = jnp.asarray(x), jnp.asarray(dx)
    weights = jnp.asarray(weights)

    @functools.partial(
        jax.jit,
        in_shardings=(
            NamedSharding(mesh, P("days")),
            NamedSharding(mesh, P("days")),
        ),
        out_shardings=NamedSharding(mesh, P("days")),
    )
    def step(b, v):
        return jax.vmap(
            lambda bi, vi: garch_integral_day(bi, vi, x, dx, weights, spec)
        )(b, v)

    return step(bounds_s, fv_s)


def sharded_cached_step(mesh: Mesh, bounds, day_tensors, fcombos, x, dx,
                        densities, weights):
    """Day-sharded cached-tensor sweep — the production bisection inner
    step: day tensors live sharded over the 'days' axis (T n^2 floats can
    exceed one device's memory at large T), each device masks + sandwiches
    its shard. densities=None selects the GARCH q=1 family.

    Implementation note: inputs are placed with NamedSharding and the
    MODULE-LEVEL jitted kernels are called directly — XLA's sharding
    propagation keeps the computation day-parallel, and the jit cache is
    shared across calls (a per-call jitted closure would recompile every
    sweep)."""
    from copula_var.ops.quadrature import (
        garch_integrals_cached,
        msm_integrals_cached,
    )

    bounds_s = _put(mesh, bounds, P("days"))
    tensors_s = _put(mesh, day_tensors, P("days"))
    x, dx = jnp.asarray(x), jnp.asarray(dx)
    weights = jnp.asarray(weights)

    if densities is None:
        return garch_integrals_cached(bounds_s, tensors_s, x, dx, weights)

    fcombos_s = _put(mesh, fcombos, P("days"))
    return msm_integrals_cached(
        bounds_s, tensors_s, fcombos_s, x, dx, jnp.asarray(densities), weights
    )


def pad_days(arr, n_dev: int, axis: int = 0):
    """Pad the day axis up to a multiple of n_dev by repeating the final
    day. The padded rows run the same (benign, finite) computation as a
    real day and are sliced off by the caller — this is how a T that does
    not divide the mesh still day-shards evenly (`device_put` with a
    NamedSharding requires divisibility)."""
    arr = jnp.asarray(arr)
    T = arr.shape[axis]
    pad = (-T) % n_dev
    if pad == 0:
        return arr
    last = jnp.take(arr, jnp.full(pad, T - 1), axis=axis)
    return jnp.concatenate([arr, last], axis=axis)


@functools.partial(jax.jit, static_argnames=("is_msm",))
def _solve_levels_jit(state0, tensors, fcombos, densities, x, dx, weights,
                      obj_vars, tolerance, box_min, is_msm):
    """MODULE-LEVEL jitted multi-level SPMD bisection over an (L, T) state.

    Hoisted out of the per-call closure so the while-loop program compiles
    ONCE per (shapes, mesh) and is reused across rolling-window /
    multi-level callers — obj_vars and tolerance are traced operands, not
    baked-in constants. Sharding comes from the operands (GSPMD
    propagation): day-sharded inputs keep every per-iteration mask +
    sandwich day-parallel, and the only cross-device traffic is the
    scalar convergence / early-break all-reduces.

    Per-(level, day) semantics match `VaRBacktest._bisection_device_levels`
    (the reference loop `calc_var_class.py:278-304` level by level,
    including the per-level all-zeros early break)."""
    from copula_var.ops.quadrature import (
        garch_integrals_cached,
        msm_integrals_cached,
    )

    if is_msm:
        def integral(b):
            return msm_integrals_cached(
                b, tensors, fcombos, x, dx, densities, weights, box_min
            )
    else:
        def integral(b):
            return garch_integrals_cached(b, tensors, x, dx, weights, box_min)

    obj = obj_vars[:, None]  # (L, 1)

    def cond(state):
        lower, upper, _, _, _, brk = state
        return jnp.any((upper - lower > tolerance) & ~brk[:, None])

    def body(state):
        lower, upper, prev_res, prev_up, ustack, brk = state
        mid = (lower + upper) / 2.0
        b_lo = jnp.where(ustack, lower, mid)
        b_up = jnp.where(ustack, mid, upper)
        bounds = jnp.stack((b_lo, b_up), axis=-1)  # (L, T, 2)
        mid_result = jax.vmap(integral)(bounds)  # (L, T)
        add = b_lo == prev_up
        result = jnp.where(add, prev_res + mid_result, prev_res - mid_result)
        zero = jnp.all(result == 0.0, axis=1)  # (L,)
        ustack_n = result < obj
        lower_n = jnp.where(~ustack_n, lower, mid)
        upper_n = jnp.where(ustack_n, upper, mid)
        frozen = (zero | brk)[:, None]
        keep = lambda new, old: jnp.where(frozen, old, new)
        return (
            keep(lower_n, lower), keep(upper_n, upper),
            keep(result, prev_res), keep(mid, prev_up),
            keep(ustack_n, ustack), brk | zero,
        )

    state = state0 + (jnp.zeros(state0[0].shape[:1], dtype=bool),)
    lower, upper, *_ = jax.lax.while_loop(cond, body, state)
    return (lower + upper) / 2.0


@functools.partial(
    jax.jit, static_argnames=("is_msm", "quirks", "Tp", "refine")
)
def _full_solve_levels_gspmd_jit(tensors, fcombos, densities, x, dx,
                                 weights, obj, cfg, tolerance, box_min,
                                 is_msm, quirks, Tp, refine=False, h=0.0):
    """ONE GSPMD dispatch for the WHOLE multi-level solve on day-sharded
    cached tensors: stage-1 sweep + per-level branch-free bracketing
    (`ops/solvers.bracket_state_jnp`) + the SPMD while-loop bisection
    (`_solve_levels_jit` semantics). Sharding propagates from the
    operands; the stage sweeps are day-parallel like every bisection
    iteration. Returns (roots (L, Tp), nan_days (L, Tp))."""
    from copula_var.ops.quadrature import (
        garch_integrals_cached,
        msm_integrals_cached,
    )
    from copula_var.ops.solvers import bracket_state_batched

    if is_msm:
        def integral(b):
            return msm_integrals_cached(
                b, tensors, fcombos, x, dx, densities, weights, box_min
            )
    else:
        def integral(b):
            return garch_integrals_cached(b, tensors, x, dx, weights,
                                          box_min)

    dt = jnp.result_type(cfg.dtype, jnp.float32)
    stage1 = jnp.stack(
        [jnp.full((Tp,), -100.0, dt),
         jnp.broadcast_to(cfg[0], (Tp,)).astype(dt)], axis=-1,
    )
    F1 = integral(stage1)
    L = obj.shape[0]
    # all L stage-2 refinements in ONE batched day-parallel sweep
    lo, hi, res, pu, us, nan_days = bracket_state_batched(
        jnp.broadcast_to(F1, (L,) + F1.shape), obj.astype(F1.dtype),
        jax.vmap(integral), cfg, quirks,
    )
    state0 = (lo.astype(dt), hi.astype(dt), res.astype(dt), pu.astype(dt),
              us)
    roots = _solve_levels_jit.__wrapped__(
        state0, tensors, fcombos, densities, x, dx, weights,
        obj.astype(dt), jnp.asarray(tolerance, dt),
        jnp.asarray(box_min, dt), is_msm,
    )
    if refine:
        # second-order trap re-solve rides the same day-sharded tensors
        # (the trap sweeps are pure jnp — GSPMD shards them like any
        # bisection sweep; refine_root on engine='sharded')
        from copula_var.ops.quadrature import (
            garch_integrals_trap,
            msm_integrals_trap,
        )
        from copula_var.ops.solvers import trap_bisect

        if is_msm:
            trap = lambda b: msm_integrals_trap(
                b, tensors, fcombos, x, densities, weights, box_min
            )
        else:
            trap = lambda b: garch_integrals_trap(
                b, tensors, x, weights, box_min
            )
        roots = trap_bisect(
            jax.vmap(trap), roots, obj[:, None].astype(roots.dtype),
            jnp.asarray(h, roots.dtype),
        )
    return roots, nan_days


@functools.partial(
    jax.jit, static_argnames=("is_msm", "quirks", "Tp", "refine")
)
def _full_solve_portfolios_gspmd_jit(tensors, fcombos, densities, x, dx,
                                     weights, obj, cfg, tolerance,
                                     box_min, is_msm, quirks, Tp,
                                     refine=False, h=0.0):
    """Portfolio-batch twin of `_full_solve_levels_gspmd_jit`: row l of
    the (L, dim) weights / (L,) obj batch masks with ITS OWN half-space
    weights against the shared day-sharded tensors. One GSPMD dispatch;
    returns (roots (L, Tp), nan_days (L, Tp))."""
    from copula_var.ops.quadrature import (
        garch_integrals_cached,
        msm_integrals_cached,
    )
    from copula_var.ops.solvers import bracket_state_batched

    if is_msm:
        def integral_w(b, w):
            return msm_integrals_cached(
                b, tensors, fcombos, x, dx, densities, w, box_min
            )
    else:
        def integral_w(b, w):
            return garch_integrals_cached(b, tensors, x, dx, w, box_min)

    dt = jnp.result_type(cfg.dtype, jnp.float32)
    stage1 = jnp.stack(
        [jnp.full((Tp,), -100.0, dt),
         jnp.broadcast_to(cfg[0], (Tp,)).astype(dt)], axis=-1,
    )
    L = obj.shape[0]
    # stage-1 + stage-2 as TWO batched sweeps instead of 2L sequential
    # per-row streams (VERDICT r04 weak #5)
    F1 = jax.vmap(integral_w)(
        jnp.broadcast_to(stage1, (L,) + stage1.shape), weights
    )
    lower, upper, prev_res, prev_up, ustack, nan_days = (
        bracket_state_batched(
            F1, obj.astype(F1.dtype),
            lambda b: jax.vmap(integral_w)(b, weights), cfg, quirks,
        )
    )
    lower, upper = lower.astype(dt), upper.astype(dt)
    prev_res, prev_up = prev_res.astype(dt), prev_up.astype(dt)
    obj2 = obj[:, None].astype(dt)
    tol = jnp.asarray(tolerance, dt)

    def cond(state):
        lo, up, _, _, _, brk = state
        return jnp.any((up - lo > tol) & ~brk[:, None])

    def body(state):
        lo, up, pr, pu, us, brk = state
        mid = (lo + up) / 2.0
        b_lo = jnp.where(us, lo, mid)
        b_up = jnp.where(us, mid, up)
        bounds = jnp.stack((b_lo, b_up), axis=-1)
        mid_result = jax.vmap(integral_w)(bounds, weights)
        add = b_lo == pu
        result = jnp.where(add, pr + mid_result, pr - mid_result)
        zero = jnp.all(result == 0.0, axis=1)
        us_n = result < obj2
        lo_n = jnp.where(~us_n, lo, mid)
        up_n = jnp.where(us_n, up, mid)
        frozen = (zero | brk)[:, None]
        keep = lambda new, old: jnp.where(frozen, old, new)
        return (
            keep(lo_n, lo), keep(up_n, up), keep(result, pr),
            keep(mid, pu), keep(us_n, us), brk | zero,
        )

    state = (lower, upper, prev_res, prev_up, ustack,
             jnp.zeros((L,), dtype=bool))
    lo, up, *_ = jax.lax.while_loop(cond, body, state)
    roots = (lo + up) / 2.0
    if refine:
        from copula_var.ops.quadrature import (
            garch_integrals_trap,
            msm_integrals_trap,
        )
        from copula_var.ops.solvers import trap_bisect

        if is_msm:
            trap_w = lambda b, w: msm_integrals_trap(
                b, tensors, fcombos, x, densities, w, box_min
            )
        else:
            trap_w = lambda b, w: garch_integrals_trap(
                b, tensors, x, w, box_min
            )
        roots = trap_bisect(
            lambda b: jax.vmap(trap_w)(b, weights), roots, obj2,
            jnp.broadcast_to(
                jnp.asarray(h, roots.dtype), (roots.shape[0],)
            )[:, None],
        )
    return roots, nan_days


@functools.partial(jax.jit, static_argnames=("is_msm", "portfolios"))
def trap_refine_gspmd_jit(tensors, fcombos, densities, x, weights, roots,
                          obj, h, box_min, is_msm, portfolios=False):
    """Post-hoc trapezoid refinement over day-sharded cached tensors
    (refine_root on engine='sharded_pallas' at dim 2: the fused Pallas
    kernel returns staircase roots; this second GSPMD dispatch re-solves
    them against the sharded trap sweep — sharding propagates from the
    tensors like any bisection sweep)."""
    from copula_var.ops.quadrature import (
        garch_integrals_trap,
        msm_integrals_trap,
    )
    from copula_var.ops.solvers import trap_bisect

    if portfolios:
        if is_msm:
            trap_w = lambda b, w: msm_integrals_trap(
                b, tensors, fcombos, x, densities, w, box_min
            )
        else:
            trap_w = lambda b, w: garch_integrals_trap(
                b, tensors, x, w, box_min
            )
        sweep = lambda b: jax.vmap(trap_w)(b, weights)
        h2 = jnp.broadcast_to(
            jnp.asarray(h, roots.dtype), (roots.shape[0],)
        )[:, None]
    else:
        if is_msm:
            trap = lambda b: msm_integrals_trap(
                b, tensors, fcombos, x, densities, weights, box_min
            )
        else:
            trap = lambda b: garch_integrals_trap(
                b, tensors, x, weights, box_min
            )
        sweep = jax.vmap(trap)
        h2 = jnp.asarray(h, roots.dtype)
    return trap_bisect(sweep, roots, obj[:, None].astype(roots.dtype), h2)


def sharded_full_solve_portfolios(mesh: Mesh, day_tensors, fcombos,
                                  densities, x, dx, weights_batch,
                                  obj_vars, first_guess, second_guess,
                                  tolerance, min_var_value, max_var_value,
                                  box_min=-5.0, reference_quirks=False,
                                  T=None, refine=False, refine_h=0.0):
    """engine='sharded' (dim 2) portfolio batch in ONE GSPMD dispatch."""
    from copula_var.parallel.multiprocess import fetch, put_global

    d = NamedSharding(mesh, P("days"))
    n_dev = mesh.shape["days"]
    obj_vars = jnp.atleast_1d(jnp.asarray(obj_vars))
    is_msm = densities is not None
    if T is None:
        T = int(
            (jnp.asarray(fcombos) if is_msm else
             jnp.asarray(day_tensors)).shape[0]
        )
    Tp = T + ((-T) % n_dev)
    tensors_s = (
        put_global(day_tensors, d)
        if isinstance(day_tensors, jax.Array) and day_tensors.shape[0] == Tp
        else put_global(pad_days(jnp.asarray(day_tensors), n_dev), d)
    )
    if is_msm:
        fcombos_s = (
            put_global(fcombos, d)
            if isinstance(fcombos, jax.Array) and fcombos.shape[0] == Tp
            else put_global(pad_days(jnp.asarray(fcombos), n_dev), d)
        )
        densities = jnp.asarray(densities)
    else:
        fcombos_s = jnp.zeros(())
        densities = jnp.zeros(())
    cfg = jnp.asarray(
        np.array([first_guess, second_guess[0], second_guess[1],
                  min_var_value, max_var_value], dtype=np.float64)
    )
    roots, nan_days = _full_solve_portfolios_gspmd_jit(
        tensors_s, fcombos_s, densities, jnp.asarray(x), jnp.asarray(dx),
        jnp.asarray(weights_batch), obj_vars, cfg, tolerance, box_min,
        is_msm, bool(reference_quirks), int(Tp),
        refine=bool(refine),
        h=jnp.asarray(refine_h) if refine else 0.0,
    )
    return fetch(roots)[:, :T], fetch(nan_days)[:, :T]


def sharded_full_solve_levels(mesh: Mesh, day_tensors, fcombos, densities,
                              x, dx, weights, obj_vars, first_guess,
                              second_guess, tolerance, min_var_value,
                              max_var_value, box_min=-5.0,
                              reference_quirks=False, T=None,
                              refine=False, refine_h=0.0):
    """engine='sharded' (dim 2) in ONE dispatch: bracketing + bisection
    on the day-sharded cached tensors. `day_tensors`/`fcombos` may be the
    orchestrator's pre-placed padded globals. Returns host
    (roots (L, T), nan_days (L, T))."""
    from copula_var.parallel.multiprocess import fetch, put_global

    d = NamedSharding(mesh, P("days"))
    n_dev = mesh.shape["days"]
    obj_vars = jnp.atleast_1d(jnp.asarray(obj_vars))
    is_msm = densities is not None
    if T is None:
        # NOTE: day_tensors/fcombos may arrive PRE-PADDED (the
        # orchestrator's placed cache) — callers with padded inputs must
        # pass the true T explicitly
        T = int(
            (jnp.asarray(fcombos) if is_msm else
             jnp.asarray(day_tensors)).shape[0]
        )
    Tp = T + ((-T) % n_dev)
    tensors_s = (
        put_global(day_tensors, d)
        if isinstance(day_tensors, jax.Array) and day_tensors.shape[0] == Tp
        else put_global(pad_days(jnp.asarray(day_tensors), n_dev), d)
    )
    if is_msm:
        fcombos_s = (
            put_global(fcombos, d)
            if isinstance(fcombos, jax.Array) and fcombos.shape[0] == Tp
            else put_global(pad_days(jnp.asarray(fcombos), n_dev), d)
        )
        densities = jnp.asarray(densities)
    else:
        fcombos_s = jnp.zeros(())
        densities = jnp.zeros(())
    # un-padded T semantics: padded rows mirror the last real day, so the
    # bracket masks, the all-zeros break, and the convergence test see
    # the same values the unpadded program would
    cfg = jnp.asarray(
        np.array([first_guess, second_guess[0], second_guess[1],
                  min_var_value, max_var_value], dtype=np.float64)
    )
    roots, nan_days = _full_solve_levels_gspmd_jit(
        tensors_s, fcombos_s, densities, jnp.asarray(x), jnp.asarray(dx),
        jnp.asarray(weights), obj_vars, cfg, tolerance, box_min,
        is_msm, bool(reference_quirks), int(Tp),
        refine=bool(refine), h=float(refine_h),
    )
    roots, nan_days = fetch(roots), fetch(nan_days)
    return roots[:, :T], nan_days[:, :T]


def sharded_bisection_solve_levels(mesh: Mesh, day_tensors, fcombos,
                                   densities, x, dx, weights, lower, upper,
                                   prev_result, prev_upper, upper_stack,
                                   obj_vars, tolerance, box_min=-5.0):
    """Multi-level production VaR bisection day-sharded over the mesh.

    All arrays carry a leading level axis: lower/upper/prev_result/
    prev_upper/upper_stack are (L, T), obj_vars is (L,). The (T, n, n) day
    tensors are placed sharded on the mesh's 'days' axis (at large T
    they exceed one device's memory) and ONE SPMD while-loop solves every
    (level, day) cell; each level's day tensor reads are shared. Returns
    (L, T) roots, day-sharded on the trailing axis.

    densities=None selects the GARCH/mean-reverting (q=1) family; else the
    MSM family with (dim, q, n) densities and (T, q^dim) fcombos.
    """
    from copula_var.parallel.multiprocess import fetch, put_global

    d = NamedSharding(mesh, P("days"))
    ld = NamedSharding(mesh, P(None, "days"))
    n_dev = mesh.shape["days"]
    T = jnp.asarray(lower).shape[1]
    tensors_s = put_global(pad_days(jnp.asarray(day_tensors), n_dev), d)
    is_msm = densities is not None
    if is_msm:
        densities = jnp.asarray(densities)
        fcombos_s = put_global(pad_days(jnp.asarray(fcombos), n_dev), d)
    else:
        densities = jnp.zeros(())
        fcombos_s = jnp.zeros(())

    dt = jnp.zeros(()).dtype
    state0 = tuple(
        put_global(pad_days(jnp.asarray(a, dtype=dt), n_dev, axis=1), ld)
        for a in (lower, upper, prev_result, prev_upper)
    ) + (
        put_global(
            pad_days(jnp.asarray(upper_stack, dtype=bool), n_dev, axis=1), ld
        ),
    )

    roots = _solve_levels_jit(
        state0, tensors_s, fcombos_s, densities, jnp.asarray(x),
        jnp.asarray(dx), jnp.asarray(weights),
        jnp.asarray(obj_vars, dtype=dt), jnp.asarray(tolerance, dtype=dt),
        jnp.asarray(box_min, dtype=dt), is_msm,
    )
    if jax.process_count() > 1:
        # cross-process: the padded day axis spans other processes'
        # devices — one DCN all-gather replicates the roots to every
        # host (an eager slice on the global array would be rejected)
        return fetch(roots)[:, :T]
    return roots[:, :T]


def sharded_bisection_solve(mesh: Mesh, day_tensors, fcombos, densities,
                            x, dx, weights, lower, upper, prev_result,
                            prev_upper, upper_stack, obj_var, tolerance,
                            box_min=-5.0):
    """The FULL production VaR bisection day-sharded over the mesh.

    The single-chip solver (`VaRBacktest._bisection_device`) runs the
    whole bisection as one `lax.while_loop`; at large T the (T, n, n)
    day tensors exceed one device's memory, so here they are placed sharded on
    the 'days' axis and the SAME while-loop program runs SPMD: each device
    masks + sandwiches its day shard per iteration, and the only
    cross-device traffic is the scalar convergence reduction
    (`jnp.any(gap > tol)` -> an all-reduce) plus the all-zeros
    early-break reduction. Returns the (T,) roots, day-sharded.

    densities=None selects the GARCH/mean-reverting (q=1) family; else the
    MSM family with (dim, q, n) densities and (T, q^dim) fcombos.

    Thin L=1 wrapper over `sharded_bisection_solve_levels` — one shared,
    cached while-loop program serves both entry points."""
    roots = sharded_bisection_solve_levels(
        mesh, day_tensors, fcombos, densities, x, dx, weights,
        jnp.asarray(lower)[None], jnp.asarray(upper)[None],
        jnp.asarray(prev_result)[None], jnp.asarray(prev_upper)[None],
        jnp.asarray(upper_stack)[None], jnp.asarray([obj_var]), tolerance,
        box_min,
    )
    return roots[0]


def grid_sharded_garch_integrals(mesh: Mesh, bounds, forecast_vols, x, dx,
                                 weights, spec: CopulaSpec, axis: str = "grid"):
    """One integral per day with the OUTER grid dimension sharded.

    Each device holds n/D outer coordinates, computes its slice of the
    masked copula-density sandwich, and the per-day scalars are
    `psum`-reduced. dim == 2 only (the reference's supported
    case). Requires n % mesh.shape[axis] == 0.
    """
    n = x.shape[0]
    n_dev = mesh.shape[axis]
    if n % n_dev:
        raise ValueError(f"num_points {n} not divisible by {n_dev} devices")
    x = jnp.asarray(x)
    dx = jnp.asarray(dx)
    bounds = jnp.asarray(bounds)
    forecast_vols = jnp.asarray(forecast_vols)
    weights = jnp.asarray(weights)

    # Per-coordinate transforms are computed ONCE outside shard_map (the
    # ppf's internal while_loop does not trace under manual sharding with
    # mixed varying axes, and hoisting it is cheaper anyway: dim * n
    # transforms per day instead of per chunk).
    t0, p0, t1, p1 = grid_sharded_garch_transforms(forecast_vols, x, spec)
    return grid_sharded_garch_sweep(
        mesh, bounds, t0, p0, t1, p1, x, dx, weights, spec, grid_axis=axis
    )


def grid_sharded_garch_transforms(forecast_vols, x, spec: CopulaSpec):
    """Bounds-invariant prep for the grid-sharded GARCH/MR sweep: the
    per-day CDF copula pre-transforms and pdf columns (build once per
    backtest; every sweep of a solve reuses them)."""
    x = jnp.asarray(x)
    forecast_vols = jnp.asarray(forecast_vols)
    u0 = norm_cdf(x[None, :] / forecast_vols[:, 0:1])  # (T, n)
    u1 = norm_cdf(x[None, :] / forecast_vols[:, 1:2])
    p0 = norm_pdf(x[None, :] / forecast_vols[:, 0:1]) / forecast_vols[:, 0:1]
    p1 = norm_pdf(x[None, :] / forecast_vols[:, 1:2]) / forecast_vols[:, 1:2]
    return _transform_columns(u0, spec), p0, _transform_columns(u1, spec), p1


def grid_sharded_garch_sweep(mesh, bounds, t0, p0, t1, p1, x, dx, weights,
                             spec: CopulaSpec, grid_axis="grid",
                             box_min=-5.0):
    """(T,) GARCH/MR integrals from prebuilt transforms, outer grid
    dimension sharded over `mesh`. Traceable (usable inside a jitted
    while-loop bisection)."""
    bounds = jnp.asarray(bounds)
    x = jnp.asarray(x)
    dx = jnp.asarray(dx)
    weights = jnp.asarray(weights)

    def shard_fn(b, t0_chunk, p0_chunk, t1_full, p1_full, x0_chunk, dx0_chunk):
        def partial_day(bi, c0, pc0, c1, pc1):
            C = _chunk_copula_from_transformed(c0, c1, spec)
            V = jnp.nan_to_num(C * (pc0[:, None] * pc1[None, :]))
            dyn_up = (bi[1] - x0_chunk * weights[1]) / weights[0]
            dyn_lo = jnp.maximum(
                (bi[0] - x0_chunk * weights[1]) / weights[0], box_min
            )
            M = (x[None, :] > dyn_lo[:, None]) & (x[None, :] <= dyn_up[:, None])
            V = jnp.where(M, V, 0.0)
            return jnp.einsum("i,ij,j->", dx0_chunk, V, dx,
                              precision=_HIGHEST)

        part = jax.vmap(partial_day)(b, t0_chunk, p0_chunk, t1_full, p1_full)
        return jax.lax.psum(part, grid_axis)

    f = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(),
            P(None, grid_axis),
            P(None, grid_axis),
            P(),
            P(),
            P(grid_axis),
            P(grid_axis),
        ),
        out_specs=P(),
        check_vma=False,
    )
    return f(bounds, t0, p0, t1, p1, x, dx)


def grid_sharded_msm_integrals(mesh: Mesh, bounds, fbs, fcombos, x, dx,
                               densities, unique_vols, weights,
                               spec: CopulaSpec, grid_axis: str = "grid",
                               day_axis=None):
    """MSM-family integrals with the OUTER grid dimension sharded.

    Each device holds n/D outer coordinates and its slice of the
    state-weight matrix W0 = densities[1] dx, computes the partial
    (q, q) state sandwich over its rows, and the partials are
    `psum`-reduced before the per-day combo contraction
    (`calc_integral.py:63-109` semantics at dim 2). With `day_axis` set
    (a 2-D ('days', 'grid') mesh), the T days shard over the other mesh
    axis simultaneously — the day x grid product grid that scales one
    backtest across many devices.

    Requires n % mesh.shape[grid_axis] == 0 (and T % mesh.shape[day_axis]
    == 0 when day_axis is given). dim == 2.
    """
    n = x.shape[0]
    n_dev = mesh.shape[grid_axis]
    if n % n_dev:
        raise ValueError(f"num_points {n} not divisible by {n_dev} devices")
    x = jnp.asarray(x)
    dx = jnp.asarray(dx)
    bounds = jnp.asarray(bounds)
    fbs = jnp.asarray(fbs)
    fcombos = jnp.asarray(fcombos)
    densities = jnp.asarray(densities)
    unique_vols = jnp.asarray(unique_vols)
    weights = jnp.asarray(weights)
    if day_axis is not None and bounds.shape[0] % mesh.shape[day_axis]:
        raise ValueError(
            f"T {bounds.shape[0]} not divisible by {mesh.shape[day_axis]}"
        )

    # per-day mixture CDFs and copula pre-transforms (the t_ppf work)
    # hoisted OUTSIDE shard_map, per dim: (T, n)
    t0, t1, w0, w1 = grid_sharded_msm_transforms(
        fbs, x, dx, densities, unique_vols, spec
    )
    return grid_sharded_msm_sweep(
        mesh, bounds, t0, t1, w0, w1, fcombos, x, weights, spec,
        grid_axis=grid_axis, day_axis=day_axis,
    )


def grid_sharded_msm_transforms(fbs, x, dx, densities, unique_vols,
                                spec: CopulaSpec):
    """Bounds-invariant prep for the grid-sharded MSM sweep: per-day
    mixture-CDF copula pre-transforms (ALL the t_ppf work) and the
    rotated state-weight rows. Build once per backtest; every sweep of a
    VaR solve reuses them (`VaRBacktest(engine='grid_sharded')`)."""
    x = jnp.asarray(x)
    dx = jnp.asarray(dx)
    fbs = jnp.asarray(fbs)
    densities = jnp.asarray(densities)
    unique_vols = jnp.asarray(unique_vols)
    u0 = jnp.sum(
        fbs[:, 0, :, None] * norm_cdf(x[None, None, :] / unique_vols[0][:, None]),
        axis=1,
    )
    u1 = jnp.sum(
        fbs[:, 1, :, None] * norm_cdf(x[None, None, :] / unique_vols[1][:, None]),
        axis=1,
    )
    t0 = _transform_columns(u0, spec)
    t1 = _transform_columns(u1, spec)
    # rotated density rows (`create_grids.py:121,143`)
    w0 = densities[1] * dx[None, :]  # (q, n) -> outer dim, column-sharded
    w1 = densities[0] * dx[None, :]  # (q, n) -> inner dim, replicated
    return t0, t1, w0, w1


def grid_sharded_msm_sweep(mesh, bounds, t0, t1, w0, w1, fcombos, x,
                           weights, spec: CopulaSpec, grid_axis="grid",
                           day_axis=None, box_min=-5.0):
    """(T,) MSM integrals from prebuilt transforms, outer grid dimension
    sharded over `mesh` (optionally days over `day_axis` too). Traceable:
    callable inside a jitted while-loop bisection."""
    bounds = jnp.asarray(bounds)
    x = jnp.asarray(x)
    weights = jnp.asarray(weights)
    dspec = day_axis if day_axis is not None else None

    def shard_fn(b, t0_chunk, t1_full, x0_chunk, w0_chunk, fc):
        def partial_day(bi, c0, c1, fci):
            C = _chunk_copula_from_transformed(c0, c1, spec)
            dyn_up = (bi[1] - x0_chunk * weights[1]) / weights[0]
            dyn_lo = jnp.maximum(
                (bi[0] - x0_chunk * weights[1]) / weights[0], box_min
            )
            M = (x[None, :] > dyn_lo[:, None]) & (x[None, :] <= dyn_up[:, None])
            V = jnp.where(M, C, 0.0)
            S_part = w0_chunk @ V @ w1.T  # (q, q) partial over grid rows
            S = jax.lax.psum(S_part, grid_axis)
            return jnp.sum(S.reshape(-1) * fci)

        return jax.vmap(partial_day)(b, t0_chunk, t1_full, fc)

    f = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(dspec),
            P(dspec, grid_axis),
            P(dspec),
            P(grid_axis),
            P(None, grid_axis),
            P(dspec),
        ),
        out_specs=P(dspec),
        check_vma=False,
    )
    return f(bounds, t0, t1, x, w0, jnp.asarray(fcombos))


def _transform_columns(u, spec: CopulaSpec):
    """Per-coordinate copula pre-transforms on a (T, n) marginal-CDF array
    — everything ppf-shaped runs here, outside shard_map. Delegates to the
    quadrature engine's (shape-agnostic, elementwise) transform."""
    from copula_var.ops.quadrature import transform_u_columns

    return transform_u_columns(u, spec)


def _trap_scale(x):
    """tw / dx: converts dx-scaled contraction rows (the staircase
    sweeps' precomputed w0/w1) to trapezoid-weighted rows without
    re-deriving the densities."""
    from copula_var.ops.quadrature import trap_weights

    x = jnp.asarray(x)
    dx = jnp.diff(x, prepend=x[:1])
    dx = dx.at[0].set(dx[1])
    tw = trap_weights(x)
    return tw, tw / dx


def grid_sharded_msm_trap_sweep(mesh, bounds, t0, t1, w0, w1, fcombos, x,
                                weights, spec: CopulaSpec,
                                grid_axis="grid", day_axis=None,
                                box_min=-5.0):
    """Second-order (trapezoid + fractional inner cell) twin of
    `grid_sharded_msm_sweep` (refine_root on engine='grid_sharded',
    dim 2). Same sharding layout; the dx-scaled state rows rescale to
    trapezoid weights via tw/dx. Traceable."""
    bounds = jnp.asarray(bounds)
    x = jnp.asarray(x)
    weights = jnp.asarray(weights)
    tw, scale = _trap_scale(x)
    w0t = w0 * scale[None, :]
    w1t = w1 * scale[None, :]
    dspec = day_axis if day_axis is not None else None

    def shard_fn(b, t0_chunk, t1_full, x0_chunk, w0_chunk, fc):
        def partial_day(bi, c0, c1, fci):
            from copula_var.ops.quadrature import halfspace_frac_cols

            C = _chunk_copula_from_transformed(c0, c1, spec)
            A = halfspace_frac_cols([x0_chunk, x], tw, bi[0], bi[1],
                                    weights, box_min)
            V = jnp.where(A > 0.0, C, 0.0) * A
            S_part = _mm(_mm(w0_chunk, V), w1t.T)
            S = jax.lax.psum(S_part, grid_axis)
            return jnp.sum(S.reshape(-1) * fci)

        return jax.vmap(partial_day)(b, t0_chunk, t1_full, fc)

    f = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(dspec), P(dspec, grid_axis), P(dspec), P(grid_axis),
            P(None, grid_axis), P(dspec),
        ),
        out_specs=P(dspec),
        check_vma=False,
    )
    return f(bounds, t0, t1, x, w0t, jnp.asarray(fcombos))


def grid_sharded_garch_trap_sweep(mesh, bounds, t0, p0, t1, p1, x,
                                  weights, spec: CopulaSpec,
                                  grid_axis="grid", box_min=-5.0):
    """Trap twin of `grid_sharded_garch_sweep` (refine_root,
    engine='grid_sharded', dim 2)."""
    bounds = jnp.asarray(bounds)
    x = jnp.asarray(x)
    weights = jnp.asarray(weights)
    tw, _ = _trap_scale(x)

    def shard_fn(b, t0_chunk, p0_chunk, t1_full, p1_full, x0_chunk,
                 tw0_chunk):
        def partial_day(bi, c0, pc0, c1, pc1):
            from copula_var.ops.quadrature import halfspace_frac_cols

            C = _chunk_copula_from_transformed(c0, c1, spec)
            V = jnp.nan_to_num(C * (pc0[:, None] * pc1[None, :]))
            A = halfspace_frac_cols([x0_chunk, x], tw, bi[0], bi[1],
                                    weights, box_min)
            V = jnp.where(A > 0.0, V, 0.0) * A
            return jnp.einsum("i,ij,j->", tw0_chunk, V, tw,
                              precision=_HIGHEST)

        part = jax.vmap(partial_day)(b, t0_chunk, p0_chunk, t1_full,
                                     p1_full)
        return jax.lax.psum(part, grid_axis)

    f = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(), P(None, grid_axis), P(None, grid_axis), P(), P(),
            P(grid_axis), P(grid_axis),
        ),
        out_specs=P(),
        check_vma=False,
    )
    return f(bounds, t0, p0, t1, p1, x, tw)


def grid_sharded_tcached_trap_sweep(mesh, bounds, cols0, cols_rest, p0,
                                    p_rest, fcombos, x, densities, weights,
                                    kind, params, family, day_batch,
                                    box_min=-5.0, grid_axis="grid"):
    """Trap twin of `grid_sharded_tcached_sweep` (refine_root,
    engine='grid_sharded', dim >= 3): trapezoid contraction weights +
    fractional inner cell on the chunked ragged-column rebuild."""
    from copula_var.ops.quadrature import (
        CopulaSpec as _Spec,
        _contract_states,
        copula_density_cols,
        trap_weights,
    )

    spec = _Spec(kind, params)
    is_msm = family == "msm"
    dim = int(jnp.asarray(weights).shape[0])
    x = jnp.asarray(x)
    tw = trap_weights(x)
    weights = jnp.asarray(weights)
    if is_msm:
        w0_full = densities[(0 - 1) % dim] * tw[None, :]
        w_rest = [densities[(d - 1) % dim] * tw[None, :]
                  for d in range(1, dim)]
    else:
        w0_full = tw[None, :]
        w_rest = None

    def shard_fn(b, c0, cr, p0c, prc, fc, x0_chunk, w0_chunk, tw0_chunk):
        def one_day(args):
            b_i, c0_i, cr_i, p0_i, pr_i, fc_i = args
            col_list = [c0_i] + [
                tuple(l[d - 1] for l in cr_i) for d in range(1, dim)
            ]
            from copula_var.ops.quadrature import (
                halfspace_frac_cols,
            )

            C = copula_density_cols(col_list, spec)
            lens = [x0_chunk.shape[0]] + [x.shape[0]] * (dim - 1)
            A = halfspace_frac_cols(
                [x0_chunk] + [x] * (dim - 1), tw, b_i[0], b_i[1],
                weights, box_min,
            )
            if is_msm:
                V = jnp.where(A > 0.0, C, 0.0) * A
                w_cols = [w0_chunk] + w_rest
                S = _contract_states(V, w_cols).reshape(-1)
                return jnp.sum(S * fc_i)
            pdf = jnp.ones((1,) * dim)
            cols_p = [p0_i] + [pr_i[d - 1] for d in range(1, dim)]
            for d in range(dim):
                shape = [1] * dim
                shape[d] = lens[d]
                pdf = pdf * cols_p[d].reshape(shape)
            V = jnp.nan_to_num(C * pdf)
            V = jnp.where(A > 0.0, V, 0.0) * A
            w_cols = [tw0_chunk[None, :]] + [tw[None, :]] * (dim - 1)
            return _contract_states(V, w_cols).reshape(())

        part = jax.lax.map(
            one_day, (b, c0, cr, p0c, prc, fc), batch_size=day_batch
        )
        return jax.lax.psum(part, grid_axis)

    T = jnp.asarray(bounds).shape[0]
    if fcombos is None:
        fcombos = jnp.zeros((T, 0))
    if p0 is None:
        p0 = jnp.zeros((T, 0))
        p_rest = jnp.zeros((T, 0, 0))
    f = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(), P(None, grid_axis), P(), P(None, grid_axis), P(), P(),
            P(grid_axis), P(None, grid_axis), P(grid_axis),
        ),
        out_specs=P(),
        check_vma=False,
    )
    return f(jnp.asarray(bounds), cols0, cols_rest, jnp.asarray(p0),
             jnp.asarray(p_rest), jnp.asarray(fcombos), x, w0_full, tw)


def grid_sharded_tcached_sweep(mesh, bounds, cols0, cols_rest, p0, p_rest,
                               fcombos, x, dx, densities, weights, kind,
                               params, family, day_batch, box_min=-5.0,
                               grid_axis="grid"):
    """(T,) integrals at dim >= 3 with the OUTERMOST grid coordinate
    sharded over `mesh` (VERDICT r04 next #4 — the one genuinely useful
    grid_sharded hole: a single huge dim-3 integral across a slice).

    Each device holds n/D rows of every day's density slab: the tcached
    rebuild (`ops/quadrature._msm_tcached` semantics, ragged-column form
    via `copula_density_cols`) runs on the (n/D, n, ..., n) chunk, the
    per-day partial contracts locally, and ONE `psum` reduces
    the (T,) partials (the combo contraction is linear, so the psum
    commutes past it). cols0/p0 are the dim-0 transform/pdf columns
    (T, n) — sharded on their grid axis; cols_rest/p_rest hold dims
    1..dim-1 replicated. Traceable (usable inside the jitted while-loop
    solvers). Ref workload: `create_grids.py:127-143` outer-dim
    recursion."""
    from copula_var.ops.quadrature import (
        CopulaSpec as _Spec,
        _contract_states,
        copula_density_cols,
        halfspace_mask_cols,
    )

    spec = _Spec(kind, params)
    is_msm = family == "msm"
    dim = int(jnp.asarray(weights).shape[0])  # static (shape, not value)
    x = jnp.asarray(x)
    dx = jnp.asarray(dx)
    weights = jnp.asarray(weights)
    if is_msm:
        # rotated density rows (`create_grids.py:121,143`): grid dim d
        # uses densities[(d-1) % dim]; dim 0's row is column-sharded
        w0_full = densities[(0 - 1) % dim] * dx[None, :]
        w_rest = [densities[(d - 1) % dim] * dx[None, :]
                  for d in range(1, dim)]
    else:
        w0_full = dx[None, :]  # q = 1
        w_rest = None

    def shard_fn(b, c0, cr, p0c, prc, fc, x0_chunk, w0_chunk):
        def one_day(args):
            b_i, c0_i, cr_i, p0_i, pr_i, fc_i = args
            col_list = [c0_i] + [
                tuple(l[d - 1] for l in cr_i) for d in range(1, dim)
            ]
            C = copula_density_cols(col_list, spec)
            M = halfspace_mask_cols(
                [x0_chunk] + [x] * (dim - 1), b_i[0], b_i[1], weights,
                box_min,
            )
            if is_msm:
                V = jnp.where(M, C, 0.0)
                w_cols = [w0_chunk] + w_rest
                S = _contract_states(V, w_cols).reshape(-1)
                return jnp.sum(S * fc_i)
            lens = [x0_chunk.shape[0]] + [x.shape[0]] * (dim - 1)
            pdf = jnp.ones((1,) * dim)
            cols_p = [p0_i] + [pr_i[d - 1] for d in range(1, dim)]
            for d in range(dim):
                shape = [1] * dim
                shape[d] = lens[d]
                pdf = pdf * cols_p[d].reshape(shape)
            V = jnp.where(M, jnp.nan_to_num(C * pdf), 0.0)
            w_cols = [w0_chunk] + [dx[None, :]] * (dim - 1)
            return _contract_states(V, w_cols).reshape(())

        part = jax.lax.map(
            one_day, (b, c0, cr, p0c, prc, fc), batch_size=day_batch
        )
        return jax.lax.psum(part, grid_axis)

    T = jnp.asarray(bounds).shape[0]
    if fcombos is None:
        fcombos = jnp.zeros((T, 0))
    if p0 is None:
        p0 = jnp.zeros((T, 0))
        p_rest = jnp.zeros((T, 0, 0))
    f = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(), P(None, grid_axis), P(), P(None, grid_axis), P(), P(),
            P(grid_axis), P(None, grid_axis),
        ),
        out_specs=P(),
        check_vma=False,
    )
    return f(jnp.asarray(bounds), cols0, cols_rest, jnp.asarray(p0),
             jnp.asarray(p_rest), jnp.asarray(fcombos), x, w0_full)


def _chunk_copula_from_transformed(c0, c1, spec: CopulaSpec):
    """Copula density on the (chunk, n) coordinate product from
    pre-transformed columns — the two-column specialization of
    `grid_copula_density` with different lengths per dimension."""
    from jax.scipy.special import gammaln

    if spec.kind == "plackett":
        (theta,) = spec.params
        (u0,), (u1,) = c0, c1
        a, b = u0[:, None], u1[None, :]
        tm1 = theta - 1.0
        num = theta * (1.0 + tm1 * (a + b - 2.0 * a * b))
        den = ((1.0 + tm1 * (a + b)) * (1.0 + tm1 * (1.0 - a - b))) ** 2
        return num / den

    if spec.kind == "gaussian":
        (corr,) = spec.params
        rho = corr[0, 1]
        (z0,), (z1,) = c0, c1
        det = 1.0 - rho**2
        quad = (
            (z0[:, None] ** 2 + z1[None, :] ** 2) * (1.0 / det - 1.0)
            - 2.0 * rho / det * z0[:, None] * z1[None, :]
        )
        return jnp.exp(-0.5 * (jnp.log(det) + quad))

    if spec.kind == "student":
        nu, corr = spec.params
        nu = jnp.asarray(nu, dtype=c0[0].dtype)
        rho = corr[0, 1]
        det = 1.0 - rho**2
        z0, f0, lu0 = c0
        z1, f1, lu1 = c1
        quad = (
            z0[:, None] ** 2 + z1[None, :] ** 2
            - 2.0 * rho * z0[:, None] * z1[None, :]
        ) / det
        log_mvt = (
            gammaln((nu + 2.0) / 2.0)
            - gammaln(nu / 2.0)
            - jnp.log(nu * jnp.pi)
            - 0.5 * jnp.log(det)
            - ((nu + 2.0) / 2.0) * jnp.log1p(quad / nu)
        )
        ratio = jnp.exp(log_mvt - lu0[:, None] - lu1[None, :])
        finite = f0[:, None] & f1[None, :]
        return jnp.where(finite, ratio, jnp.nan)

    raise ValueError(f"unknown copula kind: {spec.kind}")


# ---------------------------------------------------------------------------
# dim >= 3: day-sharded transform-column (tcached) engine
#
# The dim-2 sharded engines cache (T, n, n) copula-density day tensors; at
# dim >= 3 those would be (T, n^dim) — so the sharded dim-3 path mirrors
# the single-chip tcached engine instead: each device holds its day
# shard's TRANSFORM COLUMNS (the ppf work, (T/D, dim, n)) and rebuilds the
# n^dim density in bounded day chunks (`ops/quadrature.py::_msm_tcached`)
# inside `jax.shard_map`. Days are independent, so the quadrature needs no
# collectives; the bisection's convergence test and all-zeros early break
# are global scalar reductions (pmax/pmin) — the only
# cross-device traffic per iteration (VERDICT r03 task #3).
# ---------------------------------------------------------------------------


def _tcached_integral_fn(family, kind, day_batch, box_min, cols, fcombos,
                         densities, x, dx, weights, params):
    from copula_var.ops.quadrature import _garch_tcached, _msm_tcached

    if family == "msm":
        return lambda b: _msm_tcached(
            b, cols, fcombos, x, dx, densities, weights, box_min, kind,
            params, day_batch,
        )
    tcols, p_cols = cols
    return lambda b: _garch_tcached(
        b, tcols, p_cols, x, dx, weights, box_min, kind, params, day_batch,
    )


def _tcached_trap_fn(family, kind, day_batch, box_min, cols, fcombos,
                     densities, x, weights, params):
    """Second-order refinement twin of `_tcached_integral_fn`
    (refine_root on the day-sharded dim >= 3 engine)."""
    from copula_var.ops.quadrature import (
        _garch_tcached_trap,
        _msm_tcached_trap,
    )

    if family == "msm":
        return lambda b: _msm_tcached_trap(
            b, cols, fcombos, x, densities, weights, box_min, kind,
            params, day_batch,
        )
    tcols, p_cols = cols
    return lambda b: _garch_tcached_trap(
        b, tcols, p_cols, x, weights, box_min, kind, params, day_batch,
    )


@functools.lru_cache(maxsize=32)
def _tcached_sweep_program(mesh, family, kind, day_batch, box_min):
    """One day-sharded transform-column quadrature sweep (the bracketing
    stages' `compute_integral`), stable-identity per config."""

    def local(bounds, cols, fcombos, densities, x, dx, weights, params):
        fn = _tcached_integral_fn(family, kind, day_batch, box_min, cols,
                                  fcombos, densities, x, dx, weights,
                                  params)
        return fn(bounds)

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("days"), P("days"), P("days"), P(), P(), P(), P(), P()),
        out_specs=P("days"),
        check_vma=False,
    ))


def _spmd_bisection_levels(integral, state0, obj, tol):
    """Multi-level bisection body shared by the day-sharded dim >= 3
    programs, with GLOBAL convergence + all-zeros-break reductions
    (pmax/pmin over the 'days' mesh axis).

    Exact trip-count parity with the single-device solver
    (`backtest._device_bisection_levels_jit`): the loop carries a global
    `done` flag computed with the SAME convergence predicate (reduced
    over shards with pmax), so a shard whose days converged early keeps
    lockstep with the others without perturbing its frozen state."""

    def gany(flag):  # global any() across day shards -> scalar bool
        return jax.lax.pmax(flag.astype(jnp.int32), "days") > 0

    def gall(v):  # global all() along days, per level -> (L,) bool
        return jax.lax.pmin(v.astype(jnp.int32), "days") > 0

    obj2 = obj[:, None]

    def live(st):
        lo, up, _, _, _, brk = st
        return gany(jnp.any((up - lo > tol) & ~brk[:, None]))

    def body_once(st):
        lo, up, pr, pu, us, brk = st
        mid = (lo + up) / 2.0
        b_lo = jnp.where(us, lo, mid)
        b_up = jnp.where(us, mid, up)
        bounds = jnp.stack((b_lo, b_up), axis=-1)  # (L, T_loc, 2)
        mid_result = jax.vmap(integral)(bounds)
        add = b_lo == pu
        result = jnp.where(add, pr + mid_result, pr - mid_result)
        zero = gall(jnp.all(result == 0.0, axis=1))  # (L,) global
        us_n = result < obj2
        lo_n = jnp.where(~us_n, lo, mid)
        up_n = jnp.where(us_n, up, mid)
        frozen = (zero | brk)[:, None]
        keep = lambda new, old: jnp.where(frozen, old, new)
        return (
            keep(lo_n, lo), keep(up_n, up), keep(result, pr),
            keep(mid, pu), keep(us_n, us), brk | zero,
        )

    L = state0[0].shape[0]
    st0 = state0 + (jnp.zeros((L,), dtype=bool),)
    carry0 = (st0, ~live(st0))

    def cond(c):
        return ~c[1]

    def body(c):
        st, _ = c
        st_n = body_once(st)
        return st_n, ~live(st_n)

    st, _ = jax.lax.while_loop(cond, body, carry0)
    return (st[0] + st[1]) / 2.0


@functools.lru_cache(maxsize=32)
def _tcached_solve_program(mesh, family, kind, day_batch, box_min):
    """Day-sharded multi-level bisection over transform columns (f64
    parity engine for dim >= 3)."""

    def local(state0, cols, fcombos, densities, x, dx, weights, params,
              obj, tol):
        integral = _tcached_integral_fn(family, kind, day_batch, box_min,
                                        cols, fcombos, densities, x, dx,
                                        weights, params)
        return _spmd_bisection_levels(integral, state0, obj, tol)

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "days"), P("days"), P("days"), P(), P(), P(),
                  P(), P(), P(), P()),
        out_specs=P(None, "days"),
        check_vma=False,
    ))


def _spmd_full_solve_levels(integral, obj, cfg, tol, T_loc, quirks):
    """Per-shard stage-1 sweep + branch-free bracketing, then the
    global-reduction bisection (`_spmd_bisection_levels`). The
    bracketing is purely per-day, so it adds no collectives. Returns
    (roots (L, T_loc), nan_days (L, T_loc))."""
    from copula_var.ops.solvers import bracket_state_batched

    dt = jnp.result_type(cfg.dtype, jnp.float32)
    stage1 = jnp.stack(
        [jnp.full((T_loc,), -100.0, dt),
         jnp.broadcast_to(cfg[0], (T_loc,)).astype(dt)], axis=-1,
    )
    F1 = integral(stage1)
    L = obj.shape[0]
    # all L stage-2 refinements in ONE batched sweep (r04 weak #5)
    lo, hi, res, pu, us, nan_days = bracket_state_batched(
        jnp.broadcast_to(F1, (L,) + F1.shape), obj.astype(F1.dtype),
        jax.vmap(integral), cfg, quirks,
    )
    state0 = (lo.astype(dt), hi.astype(dt), res.astype(dt), pu.astype(dt),
              us)
    roots = _spmd_bisection_levels(integral, state0, obj.astype(dt),
                                   jnp.asarray(tol, dt))
    return roots, nan_days


def _spmd_full_solve_portfolios(integral_w, obj, weights, cfg, tol,
                                T_loc, quirks):
    """Per-shard portfolio-batch solve: like `_spmd_full_solve_levels`
    but row l masks with weights[l] (`integral_w(bounds, w)`)."""
    from copula_var.ops.solvers import bracket_state_batched

    dt = jnp.result_type(cfg.dtype, jnp.float32)
    stage1 = jnp.stack(
        [jnp.full((T_loc,), -100.0, dt),
         jnp.broadcast_to(cfg[0], (T_loc,)).astype(dt)], axis=-1,
    )
    L = obj.shape[0]
    # two batched sweeps, not 2L sequential streams (r04 weak #5)
    F1 = jax.vmap(integral_w)(
        jnp.broadcast_to(stage1, (L,) + stage1.shape), weights
    )
    lo, hi, res, pu, us, nan_days = bracket_state_batched(
        F1, obj.astype(F1.dtype),
        lambda b: jax.vmap(integral_w)(b, weights), cfg, quirks,
    )
    state0 = (lo.astype(dt), hi.astype(dt), res.astype(dt), pu.astype(dt),
              us)

    def gany(flag):
        return jax.lax.pmax(flag.astype(jnp.int32), "days") > 0

    def gall(v):
        return jax.lax.pmin(v.astype(jnp.int32), "days") > 0

    obj2 = obj[:, None].astype(dt)
    tolv = jnp.asarray(tol, dt)

    def live(st):
        lo, up, _, _, _, brk = st
        return gany(jnp.any((up - lo > tolv) & ~brk[:, None]))

    def body_once(st):
        lo, up, pr, pu, us, brk = st
        mid = (lo + up) / 2.0
        b_lo = jnp.where(us, lo, mid)
        b_up = jnp.where(us, mid, up)
        bounds = jnp.stack((b_lo, b_up), axis=-1)
        mid_result = jax.vmap(integral_w)(bounds, weights)
        add = b_lo == pu
        result = jnp.where(add, pr + mid_result, pr - mid_result)
        zero = gall(jnp.all(result == 0.0, axis=1))
        us_n = result < obj2
        lo_n = jnp.where(~us_n, lo, mid)
        up_n = jnp.where(us_n, up, mid)
        frozen = (zero | brk)[:, None]
        keep = lambda new, old: jnp.where(frozen, old, new)
        return (
            keep(lo_n, lo), keep(up_n, up), keep(result, pr),
            keep(mid, pu), keep(us_n, us), brk | zero,
        )

    L = state0[0].shape[0]
    st0 = state0 + (jnp.zeros((L,), dtype=bool),)

    def loop_body(c):
        st_n = body_once(c[0])
        return st_n, ~live(st_n)

    st, _ = jax.lax.while_loop(lambda c: ~c[1], loop_body,
                               (st0, ~live(st0)))
    return (st[0] + st[1]) / 2.0, nan_days


@functools.lru_cache(maxsize=32)
def _tcached_full_program(mesh, family, kind, day_batch, box_min, quirks,
                          portfolios=False, refine=False):
    """ONE-dispatch transform-column solve: shard_map of (stage sweeps +
    bracketing + bisection) over 'days'. With portfolios=True the
    replicated `weights` arg is a (L, dim) batch and row l masks with
    its own weights (the transform columns are weight-independent).
    refine=True appends the second-order trap re-solve (refine_root) —
    per-shard, zero extra collectives."""
    from copula_var.ops.solvers import trap_bisect

    def local(cols, fcombos, densities, x, dx, weights, params, obj, cfg,
              tol, h):
        T_loc = jnp.asarray(fcombos).shape[0]
        if portfolios:
            def integral_w(b, w):
                return _tcached_integral_fn(
                    family, kind, day_batch, box_min, cols, fcombos,
                    densities, x, dx, w, params,
                )(b)

            roots, nan_days = _spmd_full_solve_portfolios(
                integral_w, obj, weights, cfg, tol, T_loc, quirks
            )
            if refine:
                def trap_w(b, w):
                    return _tcached_trap_fn(
                        family, kind, day_batch, box_min, cols, fcombos,
                        densities, x, w, params,
                    )(b)

                roots = trap_bisect(
                    lambda b: jax.vmap(trap_w)(b, weights), roots,
                    obj[:, None].astype(roots.dtype),
                    jnp.broadcast_to(
                        jnp.asarray(h, roots.dtype), (roots.shape[0],)
                    )[:, None],
                )
            return roots, nan_days
        integral = _tcached_integral_fn(family, kind, day_batch, box_min,
                                        cols, fcombos, densities, x, dx,
                                        weights, params)
        roots, nan_days = _spmd_full_solve_levels(integral, obj, cfg, tol,
                                                  T_loc, quirks)
        if refine:
            trap = _tcached_trap_fn(family, kind, day_batch, box_min,
                                    cols, fcombos, densities, x, weights,
                                    params)
            roots = trap_bisect(
                jax.vmap(trap), roots, obj[:, None].astype(roots.dtype),
                jnp.asarray(h, roots.dtype),
            )
        return roots, nan_days

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("days"), P("days"), P(), P(), P(), P(), P(), P(), P(),
                  P(), P()),
        out_specs=(P(None, "days"), P(None, "days")),
        check_vma=False,
    ))


def sharded_tcached_full_solve_levels(
    mesh, cols_s, fcombos_s, densities, x, dx, weights, obj_vars,
    first_guess, second_guess, tolerance, min_var_value, max_var_value,
    spec: CopulaSpec, family, day_batch, box_min=-5.0,
    reference_quirks=False, T=None, portfolios=False, refine=False,
    refine_h=0.0,
):
    """engine='sharded' at dim >= 3 in ONE dispatch. cols_s/fcombos_s
    pre-placed via `_tcached_place`; T = unpadded day count.
    portfolios=True: `weights` is a (L, dim) batch, one row per level."""
    from copula_var.parallel.multiprocess import fetch

    obj_vars = jnp.atleast_1d(jnp.asarray(obj_vars))
    if T is None:
        T = fcombos_s.shape[0]
    cfg = jnp.asarray(
        np.array([first_guess, second_guess[0], second_guess[1],
                  min_var_value, max_var_value], dtype=np.float64)
    )
    dens = jnp.zeros(()) if densities is None else jnp.asarray(densities)
    f = _tcached_full_program(mesh, family, spec.kind, int(day_batch),
                              float(box_min), bool(reference_quirks),
                              bool(portfolios), bool(refine))
    roots, nan_days = f(
        cols_s, fcombos_s, dens, jnp.asarray(x), jnp.asarray(dx),
        jnp.asarray(weights), spec.params, obj_vars, cfg,
        jnp.asarray(tolerance), jnp.asarray(refine_h),
    )
    return fetch(roots)[:, :T], fetch(nan_days)[:, :T]


def _tcached_place(mesh, cols, fcombos, family, T):
    """Pad + day-shard the transform columns (pytree leaves, axis 0) and
    the combo weights; returns (cols_s, fcombos_s, Tp)."""
    from copula_var.parallel.multiprocess import put_global

    d = NamedSharding(mesh, P("days"))
    n_dev = mesh.shape["days"]
    Tp = T + ((-T) % n_dev)
    pad = lambda a: pad_days(a, n_dev)
    cols_s = jax.tree.map(lambda a: put_global(pad(a), d), cols)
    if fcombos is None:  # garch family: unused placeholder, still sharded
        fcombos_s = put_global(jnp.zeros((Tp, 1)), d)
    else:
        fcombos_s = put_global(pad(jnp.asarray(fcombos)), d)
    return cols_s, fcombos_s, Tp


def sharded_tcached_integrals(mesh, bounds, cols_s, fcombos_s, densities,
                              x, dx, weights, spec: CopulaSpec, family,
                              day_batch, box_min=-5.0):
    """(T,) transform-column integrals with the day axis sharded over
    `mesh` (cols_s/fcombos_s already placed via `_tcached_place`)."""
    from copula_var.parallel.multiprocess import fetch, put_global

    d = NamedSharding(mesh, P("days"))
    n_dev = mesh.shape["days"]
    T = jnp.asarray(bounds).shape[0]
    b_s = put_global(pad_days(jnp.asarray(bounds), n_dev), d)
    dens = jnp.zeros(()) if densities is None else jnp.asarray(densities)
    f = _tcached_sweep_program(mesh, family, spec.kind, int(day_batch),
                               float(box_min))
    out = f(b_s, cols_s, fcombos_s, dens, jnp.asarray(x), jnp.asarray(dx),
            jnp.asarray(weights), spec.params)
    return fetch(out)[:T]


def sharded_tcached_bisection_solve_levels(
    mesh, cols_s, fcombos_s, densities, x, dx, weights, lower, upper,
    prev_result, prev_upper, upper_stack, obj_vars, tolerance,
    spec: CopulaSpec, family, day_batch, box_min=-5.0,
):
    """(L, T) production bisection, day-sharded, dim >= 3 (transform
    columns). State arrays are (L, T); returns host (L, T) roots."""
    from copula_var.parallel.multiprocess import fetch, put_global

    ld = NamedSharding(mesh, P(None, "days"))
    n_dev = mesh.shape["days"]
    lower = jnp.atleast_2d(jnp.asarray(lower))
    T = lower.shape[1]
    dt = jnp.zeros(()).dtype
    state0 = tuple(
        put_global(pad_days(jnp.asarray(a, dtype=dt), n_dev, axis=1), ld)
        for a in (lower, upper, prev_result, prev_upper)
    ) + (
        put_global(
            pad_days(jnp.asarray(upper_stack, dtype=bool), n_dev, axis=1),
            ld,
        ),
    )
    dens = jnp.zeros(()) if densities is None else jnp.asarray(densities)
    f = _tcached_solve_program(mesh, family, spec.kind, int(day_batch),
                               float(box_min))
    roots = f(
        state0, cols_s, fcombos_s, dens, jnp.asarray(x), jnp.asarray(dx),
        jnp.asarray(weights), spec.params,
        jnp.asarray(obj_vars, dtype=dt), jnp.asarray(tolerance, dtype=dt),
    )
    return fetch(roots)[:, :T]
