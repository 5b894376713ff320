"""GARCH(p, q) volatility model as JAX scan kernels.

Covers the capability surface of the reference `garch/` package:
variance recursion + Gaussian log-likelihood (`garch/estimation.py:40-125`),
standardized residuals (`estimation.py:76-89`), one-step forecast
(`garch/forecast.py:5-18`), and the synthetic-data simulator
(`garch/generate_data.py:34-69`) — re-expressed as `lax.scan` programs that
jit once and `vmap` over assets, rolling windows, and parameter candidates
(replacing the reference's per-call numba kernels).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

EPS_VAR_FLOOR = 1e-7  # reference `estimation.py:17` variance floor


class GarchParams(NamedTuple):
    """omega > 0, alpha (p,) > 0, beta (q,) > 0, sum(alpha)+sum(beta) < 1."""

    omega: jax.Array
    alpha: jax.Array
    beta: jax.Array


def validate_params(omega, alpha, beta) -> None:
    """Host-side parameter checks (reference `estimation.py:22-38`)."""
    import numpy as np

    alpha = np.asarray(alpha)
    beta = np.asarray(beta)
    if not np.all(alpha > 0):
        raise ValueError("All elements of alpha must be positive.")
    if not np.all(beta > 0):
        raise ValueError("All elements of beta must be positive.")
    if not omega > 0:
        raise ValueError("omega must be positive.")
    if alpha.sum() + beta.sum() >= 1:
        raise ValueError("sum(alpha) + sum(beta) must be < 1.")


@jax.jit
def conditional_variances(returns, omega, alpha, beta):
    """sigma^2_t path; matches `estimation.py:40-65` exactly.

    sigma2[0] = omega / (1 - sum(alpha) - sum(beta)) (no floor at t=0);
    sigma2[t>=1] = max(omega + sum_i alpha_i r^2_{t-1-i}
                       + sum_j beta_j sigma^2_{t-1-j}, 1e-7)
    with zero-padded pre-sample history (the reference's `min(p, t)` loop
    bounds are equivalent to zero padding).
    """
    returns = jnp.asarray(returns)
    alpha = jnp.atleast_1d(jnp.asarray(alpha))
    beta = jnp.atleast_1d(jnp.asarray(beta))
    p, q = alpha.shape[0], beta.shape[0]
    s2_0 = omega / (1.0 - jnp.sum(alpha) - jnp.sum(beta))

    def step(carry, r_prev):
        r2h, s2h = carry
        r2h = jnp.concatenate([(r_prev * r_prev)[None], r2h[:-1]])
        s2 = jnp.maximum(omega + r2h @ alpha + s2h @ beta, EPS_VAR_FLOOR)
        s2h = jnp.concatenate([s2[None], s2h[:-1]])
        return (r2h, s2h), s2

    init = (
        jnp.zeros((p,), returns.dtype),
        jnp.zeros((q,), returns.dtype).at[0].set(s2_0),
    )
    _, s2_rest = jax.lax.scan(step, init, returns[:-1])
    return jnp.concatenate([jnp.reshape(s2_0, (1,)), s2_rest])


@jax.jit
def log_likelihood(returns, omega, alpha, beta):
    """Gaussian log-likelihood with the first max(p, q) observations
    chopped (`estimation.py:91-125`)."""
    alpha = jnp.atleast_1d(jnp.asarray(alpha))
    beta = jnp.atleast_1d(jnp.asarray(beta))
    extra = max(alpha.shape[0], beta.shape[0])
    s2 = conditional_variances(returns, omega, alpha, beta)
    r = jnp.asarray(returns)[extra:]
    s2 = s2[extra:]
    return -0.5 * jnp.sum(jnp.log(2.0 * jnp.pi * s2) + (r * r) / s2)


@jax.jit
def standardized_residuals(returns, omega, alpha, beta):
    """eps_t = r_t / sigma_t (`estimation.py:76-89`)."""
    s2 = conditional_variances(returns, omega, alpha, beta)
    return jnp.asarray(returns) / jnp.sqrt(s2)


@jax.jit
def forecast_vol(returns, omega, alpha, beta):
    """One-step-ahead sigma forecast (`garch/forecast.py:5-18`).

    NOTE (reproduced quirk): the reference pairs alpha[i] with
    returns[-p + i] — i.e. alpha[0] multiplies the *oldest* of the last p
    returns, the reverse of the recursion's convention. Identical for the
    default p = q = 1; kept for output parity at p, q > 1.
    """
    returns = jnp.asarray(returns)
    alpha = jnp.atleast_1d(jnp.asarray(alpha))
    beta = jnp.atleast_1d(jnp.asarray(beta))
    p, q = alpha.shape[0], beta.shape[0]
    s2 = conditional_variances(returns, omega, alpha, beta)
    f = omega + jnp.sum(alpha * returns[-p:] ** 2) + jnp.sum(beta * s2[-q:])
    return jnp.sqrt(f)


@jax.jit
def forecast_vol_padded(returns, omega, alpha, beta, p, q):
    """`forecast_vol` for end-zero-padded coefficient rows with traced
    true lag counts (p, q) — the shape-stable form that lets the
    one-dispatch asset batch vmap over fits with different selected
    (p, q) (`backtest._garch_forecast_windows_assets`).

    Preserves the reference's pairing quirk (`garch/forecast.py:5-18`):
    alpha[i] multiplies returns[-p + i] (oldest-first), which end-padding
    alone would shift — so the last p returns are gathered at their true
    offsets instead of slicing the padded tail.
    """
    returns = jnp.asarray(returns)
    alpha = jnp.atleast_1d(jnp.asarray(alpha))
    beta = jnp.atleast_1d(jnp.asarray(beta))
    pm, qm = alpha.shape[0], beta.shape[0]
    n = returns.shape[0]
    s2 = conditional_variances(returns, omega, alpha, beta)
    i = jnp.arange(pm)
    r_tail = jnp.where(
        i < p, returns[jnp.clip(n - p + i, 0, n - 1)], 0.0
    )
    j = jnp.arange(qm)
    s_tail = jnp.where(j < q, s2[jnp.clip(n - q + j, 0, n - 1)], 0.0)
    f = omega + jnp.sum(alpha * r_tail * r_tail) + jnp.sum(beta * s_tail)
    return jnp.sqrt(f)


@functools.partial(jax.jit, static_argnames=("n",))
def simulate(key, omega, alpha, beta, n):
    """Simulate a GARCH(p, q) series (`garch/generate_data.py:34-69`).

    Burn-in of max(p, q) steps is generated and discarded. Returns
    (y, sigma2, eps), each shape (n,).
    """
    alpha = jnp.atleast_1d(jnp.asarray(alpha))
    beta = jnp.atleast_1d(jnp.asarray(beta))
    p, q = alpha.shape[0], beta.shape[0]
    extra = max(p, q)
    total = n + extra
    draws = jax.random.normal(key, (total - 1,))
    return simulate_from_draws(draws, omega, alpha, beta, n)


@functools.partial(jax.jit, static_argnames=("n",))
def simulate_from_draws(draws, omega, alpha, beta, n):
    """Core GARCH simulator driven by explicit N(0,1) draws.

    `draws` has shape (n + max(p, q) - 1,): one innovation per generated
    step t = 1..n+extra-1 of the reference loop (`generate_data.py:55-69`,
    which leaves y[0] = 0 and sigma2[0] at the unconditional variance).
    """
    draws = jnp.asarray(draws)
    alpha = jnp.atleast_1d(jnp.asarray(alpha))
    beta = jnp.atleast_1d(jnp.asarray(beta))
    p, q = alpha.shape[0], beta.shape[0]
    extra = max(p, q)
    s2_0 = omega / (1.0 - jnp.sum(alpha) - jnp.sum(beta))

    def step(carry, z):
        y2h, s2h = carry
        s2 = omega + y2h @ alpha + s2h @ beta
        y = z * jnp.sqrt(s2)
        y2h = jnp.concatenate([(y * y)[None], y2h[:-1]])
        s2h = jnp.concatenate([s2[None], s2h[:-1]])
        return (y2h, s2h), (y, s2, z)

    init = (
        jnp.zeros((p,), draws.dtype),
        jnp.zeros((q,), draws.dtype).at[0].set(s2_0),
    )
    _, (y, s2, eps) = jax.lax.scan(step, init, draws)
    zero = jnp.zeros((1,), draws.dtype)
    y = jnp.concatenate([zero, y])[extra:]
    s2 = jnp.concatenate([jnp.reshape(s2_0, (1,)), s2])[extra:]
    eps = jnp.concatenate([zero, eps])[extra:]
    return y, s2, eps


# Batched conveniences -------------------------------------------------------

#: log-likelihood vmapped over a leading batch of parameter candidates.
log_likelihood_batch = jax.jit(
    jax.vmap(log_likelihood, in_axes=(None, 0, 0, 0))
)

#: forecast vmapped over a leading batch of rolling windows.
forecast_vol_windows = jax.jit(
    jax.vmap(forecast_vol, in_axes=(0, None, None, None))
)
