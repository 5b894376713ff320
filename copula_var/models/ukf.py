"""Unscented-Kalman-filter mean-reverting log-vol model as a JAX scan kernel.

Capability surface of the reference `kalman_mean_reverting/` package
(Zoeter/Ypma/Heskes-style non-Gaussian measurement update): the full filter
(`estimate.py:230-281` and its 10 njit helpers), one-step forecast
(`forecast.py:5-12`), and the OU simulator (`generate.py:18-32`) — one
`lax.scan` over time with a scalar carry, vmappable over assets / rolling
windows / parameter candidates.

Model: log-vol x_t = a (x_{t-1} - l) + l + q w_t,  r_t = e^{x_t} v_t.
UKF constants: L = 2 (augmented state+noise), lambda = alpha^2 (L+kappa) - L,
alpha = 1.6, beta = 2, kappa = 1.75 (`estimate.py:16-18,230-241`).

Because the augmented covariance is diag(var, 1), the 5 sigma points and the
2x2 Cholesky collapse to closed scalar forms — the reference's generic
`custom_cholesky` (`estimate.py:53-78`) reduces to sqrt(var) with the same
+1e-8 regularization when var <= 0.

The measurement update is the reference's likelihood-weighted sigma-point
update (`vectorized_update_step`, `estimate.py:196-228`): weights
h(x) = phi(r e^{-x}) |r e^{-x}|, normalizer Z accumulates log-likelihood,
and the degenerate-Z branch (Z < 1e-10) maps to an in-band invalid flag
(the scan analog of the reference's NaN / -1e10 sentinel).
"""

from __future__ import annotations

from typing import NamedTuple

import functools

import jax
import jax.numpy as jnp

ALPHA = 1.6
BETA = 2.0
KAPPA = 1.75
_L = 2
_CHOL_EPS = 1e-8
_Z_FLOOR = 1e-10
FAIL_LL = -1e10  # reference sentinel (`estimate.py:219-220,270-271`)

_INV_SQRT_2PI = 0.3989422804014327


class UkfParams(NamedTuple):
    """a: mean-reversion speed, l: long-run mean, q: process vol."""

    a: jax.Array
    l: jax.Array
    q: jax.Array


def _weights(alpha=ALPHA, beta=BETA, kappa=KAPPA):
    lam = alpha**2 * (_L + kappa) - _L
    w_rest = 1.0 / (2.0 * (_L + lam))
    wm0 = lam / (_L + lam)
    wc0 = wm0 + (1.0 - alpha**2 + beta)
    phi = jnp.sqrt(_L + lam)
    # wm2: length L+1 = 3 measurement weights (`calc_weights_2`,
    # `estimate.py:111-116`). Note sum(wm2) != 1 — a reference quirk kept
    # for parity.
    return wm0, wc0, w_rest, phi


@jax.jit
def filter_series(returns, a, l, q, init_log_vol=None, init_var=None):
    """Run the UKF over `returns`.

    Defaults init_log_vol = l, init_var = q, matching every reference call
    site (`forecast.py:10`, `optimize.py:31`).

    Returns (state_mean (N,), state_var (N,), log_lik scalar,
    forecast scalar, valid scalar bool). `forecast` is the final
    prediction-step prior mean X_mean — the reference's `forecasts` output
    (`estimate.py:243,281`). On failure the reference returns LL = -1e10
    with None arrays; here `valid` is False and LL == -1e10.
    """
    returns = jnp.asarray(returns)
    a = jnp.asarray(a, dtype=returns.dtype)
    l = jnp.asarray(l, dtype=returns.dtype)
    q = jnp.asarray(q, dtype=returns.dtype)
    if init_log_vol is None:
        init_log_vol = l
    if init_var is None:
        init_var = q
    wm0, wc0, w_rest, phi = _weights()

    def step(carry, r):
        mean, var, ll, ok = carry

        # --- prediction: 5 augmented sigma points, diag(var, 1) cov ---
        # custom_cholesky regularization: +1e-8 only when var <= 0
        sv = jnp.sqrt(jnp.where(var > 0.0, var, var + _CHOL_EPS))
        # X1 rows: [m,0], [m+phi sv,0], [m,phi], [m-phi sv,0], [m,-phi]
        x1 = jnp.array([mean, mean + phi * sv, mean, mean - phi * sv, mean])
        x2 = jnp.array([0.0, 0.0, phi, 0.0, -phi], dtype=returns.dtype)
        X = a * (x1 - l) + l + q * x2
        wm = jnp.array([wm0, w_rest, w_rest, w_rest, w_rest], dtype=X.dtype)
        wc = jnp.array([wc0, w_rest, w_rest, w_rest, w_rest], dtype=X.dtype)
        x_mean = X @ wm
        d = X - x_mean
        P = jnp.sum(wc * d * d)

        # --- update: 3 sigma points on the predicted scalar state ---
        sP = jnp.sqrt(P)
        X2 = jnp.array([x_mean, x_mean + phi * sP, x_mean - phi * sP])
        wm2 = jnp.array([wm0, w_rest, w_rest], dtype=X2.dtype)
        eta = r / jnp.exp(X2)
        h = _INV_SQRT_2PI * jnp.exp(-0.5 * eta * eta) * jnp.abs(eta)
        Z = jnp.sum(wm2 * h)
        step_ok = Z >= _Z_FLOOR  # reference: Z <= 0 or Z < 1e-10 fails
        Zs = jnp.where(step_ok, Z, 1.0)
        post_mean = jnp.sum(wm2 * X2 * h) / Zs
        post_var = jnp.sum(wm2 * (h / Zs) * (X2 - post_mean) ** 2)

        ok_new = ok & step_ok
        mean_n = jnp.where(step_ok, post_mean, mean)
        var_n = jnp.where(step_ok, post_var, var)
        ll_n = ll + jnp.where(step_ok, jnp.log(jnp.abs(Zs)), 0.0)
        return (mean_n, var_n, ll_n, ok_new), (mean_n, var_n, x_mean)

    init = (
        jnp.asarray(init_log_vol, dtype=returns.dtype),
        jnp.asarray(init_var, dtype=returns.dtype),
        jnp.zeros((), dtype=returns.dtype),
        jnp.asarray(True),
    )
    (_, _, ll, valid), (means, variances, priors) = jax.lax.scan(
        step, init, returns
    )
    ll = jnp.where(valid, ll, FAIL_LL)
    return means, variances, ll, priors[-1], valid


@jax.jit
def log_likelihood(returns, a, l, q):
    """Filter log-likelihood Sum log|Z_t| (`estimate.py:276`)."""
    _, _, ll, _, _ = filter_series(returns, a, l, q)
    return ll


@jax.jit
def vol_path(returns, a, l, q):
    """exp(filtered state) (`sto_vol_estimation`, `estimate.py:46-48`)."""
    means, _, _, _, _ = filter_series(returns, a, l, q)
    return jnp.exp(means)


@jax.jit
def standardized_residuals(returns, a, l, q):
    """eps_t = r_t / exp(x_t) (`calc_eps_t`, `estimate.py:50-51`)."""
    return jnp.asarray(returns) / vol_path(returns, a, l, q)


@jax.jit
def forecast_vol(returns, a, l, q):
    """One-step vol forecast exp(last prior mean) (`forecast.py:5-12`)."""
    _, _, _, fc, _ = filter_series(returns, a, l, q)
    return jnp.exp(fc)


@functools.partial(jax.jit, static_argnames=("n",))
def simulate(key, a, l, q, n):
    """OU log-vol simulator (`generate.py:18-32`): X_0 = l,
    X_t = a (X_{t-1} - l) + l + q N(0,1); vol = e^X; r = vol * N(0,1).
    Returns (X (n,), vol (n,), returns (n,))."""
    k_x, k_r = jax.random.split(key)
    dw = jax.random.normal(k_x, (n - 1,))

    def step(x, w):
        x = a * (x - l) + l + q * w
        return x, x

    x0 = jnp.asarray(l, dtype=dw.dtype)
    _, xs = jax.lax.scan(step, x0, dw)
    X = jnp.concatenate([x0[None], xs])
    vol = jnp.exp(X)
    r = vol * jax.random.normal(k_r, (n,))
    return X, vol, r


# Batched conveniences -------------------------------------------------------

#: likelihood vmapped over (a, l, q) candidates.
log_likelihood_batch = jax.jit(
    jax.vmap(log_likelihood, in_axes=(None, 0, 0, 0))
)

#: forecast vmapped over rolling windows (T, N).
forecast_vol_windows = jax.jit(
    jax.vmap(forecast_vol, in_axes=(0, None, None, None))
)
