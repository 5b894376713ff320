"""Batched box-constrained L-BFGS as ONE device program.

The reference polishes/fits with per-start scipy L-BFGS-B loops
(`markov_switching_multifractal/opti.py:112-139`, `student/opti.py:
116-147`) — on an accelerator every host-side function evaluation is a
host<->device round trip. This utility runs B independent bounded solves lockstep on
the device: optax L-BFGS with zoom linesearch, a smooth tanh
reparameterization onto the open box (lo, hi), and the convention that a
non-finite loss maps to a large PENALTY plateau (zero gradient — the
linesearch backs off exactly like scipy's 1e10-penalty convention).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

PENALTY = 1e10


def _to_box(s, lo, hi):
    c = 0.5 * (lo + hi)
    r = 0.5 * (hi - lo)
    return c + r * jnp.tanh(s)


def _from_box(x, lo, hi, margin=1e-6):
    c = 0.5 * (lo + hi)
    r = 0.5 * (hi - lo)
    z = jnp.clip((x - c) / r, -1.0 + margin, 1.0 - margin)
    return jnp.arctanh(z)


@functools.partial(
    jax.jit, static_argnames=("loss_fn", "max_iter", "fwd_grad")
)
def box_lbfgs_batch(loss_fn, lo, hi, x0, *args, batched_args=(),
                    max_iter=200, tol=1e-8, fwd_grad=False):
    """Minimize `loss_fn(x, *args, *row_args)` (x (d,) -> scalar) from
    each row of x0 (B, d) subject to lo < x < hi. Returns
    (x_star (B, d), f_star (B,)).

    One dispatch for the whole batch; each solve is an optax L-BFGS
    while_loop, vmapped over B. `loss_fn` is a STATIC jit key — pass a
    module-level (stable-identity) function and thread data through
    `*args` (shared across rows) / `batched_args` (a tuple of arrays
    vmapped along axis 0, one slice per solve — e.g. per-nu transforms),
    or every call re-traces and re-compiles. Non-finite losses map to a
    PENALTY plateau (zero gradient; the linesearch backs off) and
    non-finite gradients are zeroed.

    fwd_grad=True computes gradients in FORWARD mode (d JVPs for a
    d-dim solve — the natural mode at d <= ~4). Reverse mode through a
    long `lax.scan` stores per-step residuals; for the 2^k-state MSM
    filter those residuals are large enough to run out of memory at k = 12
    (`models/msm.kron_transition_matvec` memory note), while forward
    tangents ride the primal with zero storage.
    """
    import optax
    import optax.tree_utils as otu

    lo = jnp.asarray(lo, dtype=x0.dtype)
    hi = jnp.asarray(hi, dtype=x0.dtype)

    # Value-stall stop alongside the gradient test: under f32 (x64 off)
    # a 1e-8 gradient norm is unreachable
    # (gradient noise ~ |f| * eps), so a pure gradient criterion burns
    # every solve to max_iter x linesearch evals — measured 18.5 s per
    # MSM polish. Three consecutive iterations with no value change
    # beyond ~10 eps |f| means converged at this precision.
    eps = jnp.finfo(jnp.asarray(x0).dtype).eps

    def solve_one(x0_row, row_args):
        def wrapped(s):
            v = loss_fn(_to_box(s, lo, hi), *args, *row_args)
            return jnp.where(jnp.isfinite(v), v, PENALTY)

        opt = optax.lbfgs()
        if fwd_grad:
            def vg(s, state=None):
                return wrapped(s), jax.jacfwd(wrapped)(s)
        else:
            vg = optax.value_and_grad_from_state(wrapped)

        def step(carry):
            s, state, f_prev, stall = carry
            value, grad = vg(s, state=state)
            grad = jnp.where(jnp.isfinite(grad), grad, 0.0)
            updates, state = opt.update(
                grad, state, s, value=value, grad=grad, value_fn=wrapped
            )
            stall = jnp.where(
                jnp.abs(value - f_prev)
                <= 10.0 * eps * jnp.maximum(1.0, jnp.abs(value)),
                stall + 1,
                0,
            )
            return optax.apply_updates(s, updates), state, value, stall

        def cont(carry):
            _, state, _, stall = carry
            it = otu.tree_get(state, "count")
            err = otu.tree_norm(otu.tree_get(state, "grad"))
            return (it == 0) | (
                (it < max_iter) & (err >= tol) & (stall < 3)
            )

        s0 = _from_box(x0_row, lo, hi)
        s_fin, _, _, _ = jax.lax.while_loop(
            cont, step,
            (s0, opt.init(s0), jnp.asarray(jnp.inf, dtype=x0.dtype),
             jnp.asarray(0, dtype=jnp.int32)),
        )
        return _to_box(s_fin, lo, hi), wrapped(s_fin)

    return jax.vmap(solve_one, in_axes=(0, 0))(
        jnp.asarray(x0), tuple(batched_args)
    )
