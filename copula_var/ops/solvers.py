"""On-device scalar minimization for the IFM fitting schedules.

The reference drives every copula fit through scipy's host-side L-BFGS-B
(`copulas/*/opti.py`), which costs one host<->device round trip per loss
evaluation — a device sync per evaluation. For the
framework's flagship dim = 2 configuration every stage of the IFM
schedule is a ONE-DIMENSIONAL smooth problem (rho per nu, then nu, or
theta), so the whole staged schedule collapses to batched golden-section
scans that run as a single device program.

`golden_section_min` is the two-probe batched variant: each iteration
evaluates the objective at both interior points and shrinks every
bracket in the batch by the golden ratio — 90 iterations contract the
bracket by ~1e-19, i.e. to fp64 exactness on any unimodal objective.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_GR = 0.6180339887498949  # (sqrt(5) - 1) / 2


@functools.partial(jax.jit, static_argnames=("fn", "iters"))
def golden_section_min(fn, lo, hi, iters: int = 90):
    """Batched golden-section minimization.

    fn: (k*B,) -> (k*B,) jittable objective for k in {1, 2} — both probes
    of an iteration are evaluated in ONE stacked call (fn sees the two
    probe vectors concatenated), so fn must be batch-size polymorphic
    (plain `jax.vmap` closures are; closures carrying (B,)-shaped
    companion data must tile it to the input length). lo/hi: (B,) bracket
    endpoints. Returns (x (B,), fn(x) (B,)) with x the bracket midpoint
    after `iters` contractions.
    """
    lo = jnp.asarray(lo, dtype=float)
    hi = jnp.asarray(hi, dtype=float)

    B = lo.shape[0]

    def body(_, st):
        a, b = st
        m1 = b - _GR * (b - a)
        m2 = a + _GR * (b - a)
        # ONE batched objective call for both probes: when each evaluation
        # is itself an iterative kernel (t_ppf's Newton while_loop), two
        # sequential calls cost two full sweeps; the (2B,) batch shares one
        f = fn(jnp.concatenate([m1, m2]))
        f1, f2 = f[:B], f[B:]
        keep_left = f1 < f2
        return jnp.where(keep_left, a, m1), jnp.where(keep_left, m2, b)

    a, b = jax.lax.fori_loop(0, iters, body, (lo, hi))
    x = 0.5 * (a + b)
    return x, fn(x)


def bracket_state_jnp(F1, obj, sweep, cfg, quirks):
    """Branch-free stage-2 refinement + bisection-state setup for one
    confidence level (`calc_var_class.py:125-155`), traced. F1 (T,) is
    the shared stage-1 CDF; `sweep(bounds) -> (T,)`; cfg =
    [first_guess, sg0, sg1, min_v, max_v]. Returns (lo, hi, res,
    prev_upper, ustack, nan_mask)."""
    fg, sg0, sg1, min_v, max_v = cfg[0], cfg[1], cfg[2], cfg[3], cfg[4]
    T = F1.shape[0]
    new_lower = jnp.where(F1 >= obj, sg0, fg)
    new_upper = jnp.where(F1 < obj, sg1, fg)
    I2 = sweep(jnp.stack([new_lower, new_upper], axis=-1))
    res = jnp.where(new_lower == fg, F1 + I2, F1 - I2)
    anchor = fg if quirks else sg1
    prev_upper = jnp.where(new_lower == sg0, sg0, anchor)
    lo = jnp.broadcast_to(min_v, (T,))
    hi = jnp.broadcast_to(max_v, (T,))
    m = res > obj
    lo = jnp.where(m, min_v, lo)
    hi = jnp.where(m, sg0, hi)
    m = (res < obj) & (new_upper == fg)
    lo = jnp.where(m, sg0, lo)
    hi = jnp.where(m, fg, hi)
    m = (res < obj) & (new_upper == sg1)
    lo = jnp.where(m, sg1, lo)
    hi = jnp.where(m, max_v, hi)
    m = (res > obj) & (new_upper == sg1)
    lo = jnp.where(m, fg, lo)
    hi = jnp.where(m, sg1, hi)
    ustack = ~((hi == sg0) | (hi == sg1))
    return lo, hi, res, prev_upper, ustack, jnp.isnan(res)


def trap_bisect(sweep_batched, roots, obj2, h2, iters=12):
    """Re-solve in a +-h window around the staircase roots against a
    second-order trap sweep (traced): F_trap is continuous and monotone
    in the bound, so `iters` halvings pin the refined root to
    2h / 2^iters — far below the trap rule's own O(cell^2) accuracy.
    roots/obj2 (L, T)/(L, 1); h2 broadcastable to (L, T). Used by the
    refine_root paths of every supporting engine.

    A cell whose trap sweep ever turns non-finite (NaN partially inside
    the refinement window — e.g. a saturated student marginal half-
    included by the fractional boundary) keeps its STAIRCASE root: a
    silent one-sided march to roots - h would be worse than no
    refinement."""
    lo, hi = roots - h2, roots + h2
    low_edge = jnp.full_like(roots, -100.0)

    def body(_, c):
        lo, hi, bad = c
        mid = (lo + hi) / 2.0
        F = sweep_batched(jnp.stack([low_edge, mid], axis=-1))
        bad = bad | ~jnp.isfinite(F)
        below = F < obj2
        return (jnp.where(below, mid, lo), jnp.where(below, hi, mid),
                bad)

    lo, hi, bad = jax.lax.fori_loop(
        0, iters, body, (lo, hi, jnp.zeros(roots.shape, dtype=bool))
    )
    return jnp.where(bad, roots, (lo + hi) / 2.0)


def bracket_state_batched(F1, obj, sweep_batched, cfg, quirks):
    """`bracket_state_jnp` for ALL L levels at once: F1 (L, T) stage-1
    CDFs (rows may differ when each level carries its own portfolio
    weights), obj (L,), `sweep_batched((L, T, 2)) -> (L, T)`. The L
    stage-2 refinement sweeps issue as ONE batched call instead of L
    sequential ones (VERDICT r04 weak #5 — the portfolio bracketing
    streamed the day tensors once per row). Returns the same tuple with
    every element (L, T)."""
    fg, sg0, sg1, min_v, max_v = cfg[0], cfg[1], cfg[2], cfg[3], cfg[4]
    L, T = F1.shape
    objc = obj[:, None]
    new_lower = jnp.where(F1 >= objc, sg0, fg)
    new_upper = jnp.where(F1 < objc, sg1, fg)
    I2 = sweep_batched(jnp.stack([new_lower, new_upper], axis=-1))
    res = jnp.where(new_lower == fg, F1 + I2, F1 - I2)
    anchor = fg if quirks else sg1
    prev_upper = jnp.where(new_lower == sg0, sg0, anchor)
    lo = jnp.broadcast_to(min_v, (L, T))
    hi = jnp.broadcast_to(max_v, (L, T))
    m = res > objc
    lo = jnp.where(m, min_v, lo)
    hi = jnp.where(m, sg0, hi)
    m = (res < objc) & (new_upper == fg)
    lo = jnp.where(m, sg0, lo)
    hi = jnp.where(m, fg, hi)
    m = (res < objc) & (new_upper == sg1)
    lo = jnp.where(m, sg1, lo)
    hi = jnp.where(m, max_v, hi)
    m = (res > objc) & (new_upper == sg1)
    lo = jnp.where(m, fg, lo)
    hi = jnp.where(m, sg1, hi)
    ustack = ~((hi == sg0) | (hi == sg1))
    return lo, hi, res, prev_upper, ustack, jnp.isnan(res)
