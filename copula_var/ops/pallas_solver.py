"""Pallas kernel (Triton route): the whole per-day VaR solve in one launch.

The reference's bisection (`utils/calc_var_class.py:95-155,250-309`) — and
the on-device `lax.while_loop` twin in `backtest.py` — evaluates one
quadrature sweep per iteration, so the (T, n, n) cached day tensors stream
from device memory ~25 times per solve (2 bracketing sweeps + ~23 bisection
iterations), times L for L confidence levels or portfolios. Every day's
solve is independent of every other day's, so this kernel runs one program
per day: it loads the day's tile once (n = 100 pads to a 128 x 128 f32
tile, 64 KB, which stays in registers) and runs the stage-1 sweep, the
stage-2 refinement sweep, the bracket-state logic and the fixed-count
bisection for every level against that tile. Device-memory traffic per
solve drops from ~25 L T n^2 to T n^2.

The per-iteration contraction is precomputed. One sweep of the reference
is the masked sandwich `sum_{s,k} fc[s,k] sum_{r,j} w0[s,r] m[r,j] v[r,j]
w1[k,j]`; its bounds-invariant part folds into one (n, n) weight tile per
day, `P = v * (w0^T fc w1)`, so each iteration is a masked sum of P with no
product. That only reassociates f32 sums.

Semantics vs the reference bisection (both deviations are bounded by the
solver tolerance and asserted in tests):
  * a fixed iteration count `ceil(log2((max_var - min_var) / tol))` instead
    of `while any(upper - lower > tol)` — every day still converges to
    `upper - lower <= tol`, already-converged days just keep halving;
  * no global all-zeros early break (`calc_var_class.py:292-294`): that
    break couples days and only fires in degenerate no-mass
    configurations. The f64 engines keep it; this kernel does not.

f32 accuracy: the masked-grid CDF is a STEP function of the VaR bound —
every v inside one grid cell's half-space band yields the same integral,
so any root on that plateau is equally consistent with the discretized
CDF. The f64 XLA engine and this f32 kernel can therefore resolve a root
to different edges of the same (or an adjacent) plateau when
|F - obj_var| at the step is below f32 resolution. Root disagreement is
bounded by one grid cell width times |weights[0]| (`root_plateau_bound`);
cross-engine tests use that bound, not the bisection tolerance.

Padded grid points carry x = +inf and a zero weight tile, so their mask is
false. A day whose tensor holds NaN (reference-parity 0/0 densities) gets
NaN roots; its tile is zeroed before the kernel.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

_HIGHEST = jax.lax.Precision.HIGHEST

# cfg vector layout (traced, so new bracket values do not recompile)
_FG, _SG0, _SG1, _MIN_V, _MAX_V, _BOX_MIN, _QUIRKS = range(7)
_CFG_LEN = 8


def root_plateau_bound(dx, weights, n_cells=1):
    """Derived cross-engine accuracy contract of the f32 fused engines.

    The masked-grid CDF is a STEP function of the VaR bound v: the mask's
    inner-coordinate cut moves by one grid cell when v moves by
    cell_width x weights[0], so when |F - obj_var| at a step is below f32
    resolution the f32 kernel may resolve the root to a different edge of
    the same (or an adjacent) plateau than the f64 engine. The worst-case
    disagreement is therefore `n_cells x max(dx) x |weights[0]|`. Typical
    disagreement is set by the cell widths NEAR the root (the fine
    interior region of the non-uniform grid) — use `np.median(dx)` for a
    sensitivity check.
    """
    return float(
        n_cells * np.max(np.asarray(dx)) * abs(float(np.asarray(weights)[0]))
    )


def _pow2(n, floor=16):
    return max(floor, 1 << (int(n) - 1).bit_length())


def _num_warps(np_):
    """Warps per program for an (np_, np_) tile: ~64 tile elements per
    thread, between 4 and 8 warps (8 at n = 100 -> 128)."""
    return int(min(8, max(4, np_ * np_ // 2048)))


def require_kernel_backend(interpret):
    """The kernel is compiled for a GPU. Anywhere else it runs only in the
    Pallas interpreter, and only when the caller asked for that."""
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the fused Pallas solver is compiled for a GPU, and the default "
            f"JAX backend is {jax.default_backend()!r}; pass interpret=True "
            "to run it in the Pallas interpreter (tests, CPU rehearsal)"
        )


def _solve_kernel(n_iters, n_levels, cfg_ref, w_in_ref, w_out_ref, obj_ref,
                  x_ref, p_ref, out_ref):
    """One program = one day: every level's bracketing + bisection against
    the day's (NP, NP) weight tile, read once."""
    x = x_ref[...]  # (NP,) grid, +inf where padded
    p = p_ref[...]  # (NP, NP) masked-sum weights P[r, j]
    cfg = cfg_ref[...]
    w_in_v, w_out_v, obj_v = w_in_ref[...], w_out_ref[...], obj_ref[...]
    cfg_i = jnp.arange(cfg.shape[0], dtype=jnp.int32)
    lev_i = jnp.arange(obj_v.shape[0], dtype=jnp.int32)

    def pick(vec, idx, i):  # vec[i] as a masked sum (full-block ops only)
        return jnp.sum(jnp.where(idx == i, vec, 0.0))

    fg, sg0, sg1 = pick(cfg, cfg_i, _FG), pick(cfg, cfg_i, _SG0), pick(
        cfg, cfg_i, _SG1)
    min_v, max_v = pick(cfg, cfg_i, _MIN_V), pick(cfg, cfg_i, _MAX_V)
    box_min = pick(cfg, cfg_i, _BOX_MIN)
    # DEFECT-FIXED add-group anchor unless quirks (see VaRBacktest._bracket)
    anchor = jnp.where(pick(cfg, cfg_i, _QUIRKS) != 0.0, fg, sg1)
    x_outer = x[:, None]  # (NP, 1): row coordinate
    x_inner = x[None, :]  # (1, NP): column coordinate

    def sweep(lo, up, w_in, w_out):
        # masked slab integral: row r keeps the inner coordinates inside
        # its half-space band (`create_grids.py:102-110`)
        xwo = x_outer * w_out
        dyn_up = (up - xwo) / w_in
        dyn_lo = jnp.maximum((lo - xwo) / w_in, box_min)
        mask = (x_inner > dyn_lo) & (x_inner <= dyn_up)
        return jnp.sum(jnp.where(mask, p, 0.0))

    def level(l, roots):
        w_in, w_out = pick(w_in_v, lev_i, l), pick(w_out_v, lev_i, l)
        obj = pick(obj_v, lev_i, l)
        # stage 1: slab [-100, first_guess] (`calc_var_class.py:116-121`)
        F1 = sweep(-100.0, fg, w_in, w_out)
        # stage 2: refinement slab + incremental bookkeeping (`:125-143`)
        new_lower = jnp.where(F1 >= obj, sg0, fg)
        new_upper = jnp.where(F1 < obj, sg1, fg)
        I2 = sweep(new_lower, new_upper, w_in, w_out)
        res = jnp.where(new_lower == fg, F1 + I2, F1 - I2)
        prev_up = jnp.where(new_lower == sg0, sg0, anchor)
        # bracket-state masks in the reference's order (`:144-155`);
        # default = full bracket so ties and NaN keep a defined state
        lo, hi = min_v, max_v
        m = res > obj
        lo, hi = jnp.where(m, min_v, lo), jnp.where(m, sg0, hi)
        m = (res < obj) & (new_upper == fg)
        lo, hi = jnp.where(m, sg0, lo), jnp.where(m, fg, hi)
        m = (res < obj) & (new_upper == sg1)
        lo, hi = jnp.where(m, sg1, lo), jnp.where(m, max_v, hi)
        m = (res > obj) & (new_upper == sg1)
        lo, hi = jnp.where(m, fg, lo), jnp.where(m, sg1, hi)
        ustack = ~((hi == sg0) | (hi == sg1))

        def bisect(_, carry):  # `calc_var_class.py:250-309`
            lo, up, pr, pu, us = carry
            mid = 0.5 * (lo + up)
            b_lo = jnp.where(us, lo, mid)
            b_up = jnp.where(us, mid, up)
            integ = sweep(b_lo, b_up, w_in, w_out)
            res = jnp.where(b_lo == pu, pr + integ, pr - integ)
            us_n = res < obj
            return (jnp.where(us_n, mid, lo), jnp.where(us_n, up, mid),
                    res, mid, us_n)

        lo, hi, _, _, _ = jax.lax.fori_loop(
            0, n_iters, bisect, (lo, hi, res, prev_up, ustack)
        )
        return jnp.where(lev_i == l, 0.5 * (lo + hi), roots)

    out_ref[...] = jax.lax.fori_loop(
        0, n_levels, level, jnp.zeros(obj_v.shape, jnp.float32)
    )


def _weight_tiles(day_tensors, w0, w1, fcombos):
    """(T, n, n) f32 masked-sum weights P = v * (w0^T fc w1) with NaN days
    zeroed, and the (T,) NaN-day mask."""
    f32 = jnp.float32
    T, n, _ = day_tensors.shape
    raw = jnp.asarray(day_tensors, f32)
    nan_days = jnp.any(~jnp.isfinite(raw), axis=(1, 2))
    v = jnp.nan_to_num(raw, nan=0.0, posinf=0.0, neginf=0.0)
    w0 = jnp.asarray(w0, f32)
    w1 = jnp.asarray(w1, f32)
    q = w0.shape[0]
    fc = jnp.nan_to_num(jnp.asarray(fcombos, f32)).reshape(T, q, q)
    g = jnp.einsum("sr,tsk,kj->trj", w0, fc, w1, precision=_HIGHEST)
    return v * jnp.nan_to_num(g), nan_days


def _family_weights(dx, densities, fcombos, T):
    """(w0, w1, fcombos): state-weight rows with dx folded in. MSM: the
    rotated density rows (`create_grids.py:121,143`). GARCH/mean-reverting
    (densities None): the single-state case q = 1, w0 = w1 = dx, unit
    combo weight."""
    dx = jnp.asarray(dx)
    if densities is None:
        return dx[None, :], dx[None, :], jnp.ones((T, 1), dx.dtype)
    densities = jnp.asarray(densities)
    return densities[1] * dx[None, :], densities[0] * dx[None, :], fcombos


@functools.partial(
    jax.jit, static_argnames=("n_iters", "n_levels", "interpret")
)
def _full_solve(cfg, obj_vars, weights, x, dx, densities, fcombos,
                day_tensors, n_iters, n_levels, interpret):
    """ONE device program = the ENTIRE `calc_var` after prep. cfg =
    [first_guess, sg0, sg1, min_var, max_var, box_min, quirks] (traced);
    obj_vars (L,); weights (2,) or (L, 2) — distinct rows turn the level
    axis into a PORTFOLIO batch (the day tensors are weight-independent,
    so L portfolios share one read of each tile); densities and fcombos
    are None for the GARCH family. Returns (roots (T, L) f32, nan_days
    (T,) bool)."""
    f32 = jnp.float32
    T, n, _ = day_tensors.shape
    NP, LP = _pow2(n), _pow2(n_levels)
    p, nan_days = _weight_tiles(
        day_tensors, *_family_weights(dx, densities, fcombos, T)
    )
    p = jnp.pad(p, ((0, 0), (0, NP - n), (0, NP - n)))
    xp = jnp.pad(jnp.asarray(x, f32), (0, NP - n), constant_values=jnp.inf)
    wf = jnp.broadcast_to(jnp.atleast_2d(jnp.asarray(weights, f32)),
                          (n_levels, 2))
    lev = lambda a, fill: jnp.pad(a, (0, LP - n_levels), constant_values=fill)
    vec = lambda size: pl.BlockSpec((size,), lambda t: (0,))
    roots = pl.pallas_call(
        functools.partial(_solve_kernel, n_iters, n_levels),
        grid=(T,),
        in_specs=[vec(_CFG_LEN), vec(LP), vec(LP), vec(LP), vec(NP),
                  pl.BlockSpec((None, NP, NP), lambda t: (t, 0, 0))],
        out_specs=pl.BlockSpec((None, LP), lambda t: (t, 0)),
        out_shape=jax.ShapeDtypeStruct((T, LP), f32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=_num_warps(NP), num_stages=1
        ),
        interpret=interpret,
        name="var_full_solve",
    )(
        jnp.pad(jnp.asarray(cfg, f32), (0, _CFG_LEN - cfg.shape[0])),
        lev(wf[:, 0], 1.0), lev(wf[:, 1], 0.0),
        lev(jnp.asarray(obj_vars, f32), 0.5), xp, p,
    )[:, :n_levels]
    return jnp.where(nan_days[:, None], jnp.nan, roots), nan_days


def _full_iters(tolerance, min_var_value, max_var_value):
    span = max(float(max_var_value) - float(min_var_value), float(tolerance))
    return max(1, int(math.ceil(math.log2(span / float(tolerance)))))


def _cfg(first_guess, second_guess, min_var_value, max_var_value, box_min,
         reference_quirks):
    return np.array(
        [first_guess, second_guess[0], second_guess[1], min_var_value,
         max_var_value, box_min, float(bool(reference_quirks))],
        dtype=np.float64,
    )


def _solve_levels(day_tensors, x, dx, densities, fcombos, weights, obj_vars,
                  first_guess=-3.0, second_guess=(-3.5, -2.0), tolerance=1e-6,
                  min_var_value=-7.5, max_var_value=0.0, box_min=-5.0, *,
                  interpret=False, reference_quirks=False):
    """The ENTIRE multi-level VaR solve in ONE device dispatch: takes the
    user-facing solver config and performs the stage-1/stage-2 bracketing
    in-kernel. Returns (roots (L, T) f32, nan_days (T,) bool)."""
    require_kernel_backend(interpret)
    obj_vars = np.atleast_1d(np.asarray(obj_vars, dtype=np.float64))
    roots, nan_days = _full_solve(
        _cfg(first_guess, second_guess, min_var_value, max_var_value,
             box_min, reference_quirks),
        obj_vars, np.asarray(weights, np.float64), x, dx, densities,
        fcombos, day_tensors,
        n_iters=_full_iters(tolerance, min_var_value, max_var_value),
        n_levels=obj_vars.shape[0], interpret=bool(interpret),
    )
    roots, nan_days = jax.device_get((roots, nan_days))
    return np.asarray(roots).T, np.asarray(nan_days)


def msm_full_solve_pallas_levels(day_tensors, forecast_combos, x, dx,
                                 densities, weights, obj_vars, **kw):
    """Fully fused multi-level solve, MSM family: ONE dispatch.
    day_tensors (T, n, n); forecast_combos (T, q*q); densities (2, q, n);
    weights (2,) or (L, 2); obj_vars (L,)."""
    return _solve_levels(day_tensors, x, dx, densities, forecast_combos,
                         weights, obj_vars, **kw)


def garch_full_solve_pallas_levels(day_tensors, x, dx, weights, obj_vars,
                                   **kw):
    """Fully fused multi-level solve, GARCH/mean-reverting family."""
    return _solve_levels(day_tensors, x, dx, None, None, weights, obj_vars,
                         **kw)


# ---------------------------------------------------------------------------
# Day-sharded fused solve: shard_map of the same program over the mesh
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _sharded_full_program(mesh, n_iters, n_levels, interpret):
    """Stable-identity jitted shard_map of `_full_solve`: every device
    runs the bracketing AND the bisection on its own day shard — both are
    purely per-day, so the whole multi-level solve has ZERO collectives.
    Keyed on config only (the iteration schedule derives from the solver
    config, not the data), so the cache stays tiny."""
    from jax.sharding import PartitionSpec as P

    def local(cfg, obj, wts, x, dx, dens, fc_l, v_l):
        return _full_solve(
            cfg, obj, wts, x, dx, dens, fc_l, v_l,
            n_iters=n_iters, n_levels=n_levels, interpret=interpret,
        )

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P("days"), P("days")),
        out_specs=(P("days"), P("days")),
        check_vma=False,
    ))


def _solve_levels_sharded(
    mesh, day_tensors, x, dx, densities, fcombos, weights, obj_vars, T,
    first_guess=-3.0, second_guess=(-3.5, -2.0), tolerance=1e-6,
    min_var_value=-7.5, max_var_value=0.0, box_min=-5.0, *,
    interpret=False, reference_quirks=False,
):
    """The ENTIRE multi-level VaR solve, day-sharded over `mesh`, in ONE
    dispatch: `jax.shard_map` of `_full_solve` with zero cross-device
    collectives. Returns (roots (L, T), nan_days (T,)).

    `day_tensors` may be raw (T, n, n) or the orchestrator's pre-placed
    padded global ((Tp, n, n), Tp a mesh-size multiple); T is the unpadded
    day count."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from copula_var.parallel.multiprocess import fetch, put_global

    require_kernel_backend(interpret)
    obj_vars = np.atleast_1d(np.asarray(obj_vars, dtype=np.float64))
    n_dev = mesh.shape["days"]
    Tp = T + ((-T) % n_dev)

    def pad_np(a):  # repeat the final day; outputs sliced off below
        if Tp == a.shape[0]:
            return a
        return np.concatenate([a, np.repeat(a[-1:], Tp - a.shape[0], axis=0)])

    d = NamedSharding(mesh, P("days"))
    place = (
        (lambda a: put_global(a, d)) if jax.process_count() > 1
        else (lambda a: a)
    )
    fc_s = None if fcombos is None else place(
        pad_np(np.asarray(fcombos, dtype=np.float32))
    )
    if isinstance(day_tensors, jax.Array) and day_tensors.shape[0] == Tp:
        v_s = put_global(day_tensors, d)  # pre-placed cache: passthrough
    elif day_tensors.shape[0] == T:
        v_s = place(pad_np(np.asarray(day_tensors, np.float32)))
    elif day_tensors.shape[0] == Tp:
        v_s = place(np.asarray(day_tensors, np.float32))
    else:
        raise ValueError(
            f"day_tensors has {day_tensors.shape[0]} days; expected T={T} "
            f"or padded Tp={Tp} for the {n_dev}-device mesh"
        )
    f = _sharded_full_program(
        mesh, _full_iters(tolerance, min_var_value, max_var_value),
        obj_vars.shape[0], bool(interpret),
    )
    roots, nan_days = f(
        _cfg(first_guess, second_guess, min_var_value, max_var_value,
             box_min, reference_quirks),
        obj_vars, np.asarray(weights, np.float64), x, dx, densities, fc_s,
        v_s,
    )  # (Tp, L), (Tp,)
    return fetch(roots)[:T].T, fetch(nan_days)[:T]


def msm_full_solve_pallas_levels_sharded(mesh, day_tensors, forecast_combos,
                                         x, dx, densities, weights, obj_vars,
                                         **kw):
    """Day-sharded fully fused multi-level solve, MSM family."""
    T = np.asarray(forecast_combos).shape[0]
    return _solve_levels_sharded(mesh, day_tensors, x, dx, densities,
                                 forecast_combos, weights, obj_vars, T, **kw)


def garch_full_solve_pallas_levels_sharded(mesh, day_tensors, x, dx, weights,
                                           obj_vars, T=None, **kw):
    """Day-sharded fully fused multi-level solve, GARCH/MR family.
    `T` = unpadded day count (required when day_tensors is the padded
    cache; defaults to day_tensors.shape[0])."""
    if T is None:
        T = day_tensors.shape[0]
    return _solve_levels_sharded(mesh, day_tensors, x, dx, None, None,
                                 weights, obj_vars, T, **kw)
