"""Scalar/distribution special functions as vectorized JAX ops.

Device-native replacements for the reference's distribution math:
  * normal pdf/cdf        — reference `utils/utils.py:4-42` (erf-based cdf)
    and the njit pdf loops (`copulas/gaussian/gaussian.py:64-84`).
  * normal ppf            — reference uses `scipy.stats.norm.ppf`
    (`copulas/gaussian/gaussian.py:43-44`).
  * Student-t pdf/cdf/ppf — the reference's dominant scalar hot spot is an
    elementwise `scipy.stats.t.ppf` double loop
    (`copulas/student/student.py:96-104`). Here the ppf is a fully
    vectorized safeguarded Newton solve in log-survival space built on
    `betainc`, which jits/fuses on the device and is accurate to ~1e-14 in f64.

All functions are dtype-polymorphic (f32 on-device by default, f64 when
x64 is enabled for parity testing) and safe under jit/vmap/grad.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import betainc, betaln, gammaln, ndtr, ndtri

_SQRT_2PI = 0.9189385332046727417803297364056176  # log(sqrt(2*pi))


def norm_pdf(x, mean=0.0, std=1.0):
    """Normal pdf, elementwise. Matches `utils/utils.py:24-42`."""
    x = jnp.asarray(x)
    z = (x - mean) / std
    return jnp.exp(-0.5 * z * z - _SQRT_2PI) / std


def norm_logpdf(x, mean=0.0, std=1.0):
    x = jnp.asarray(x)
    z = (x - mean) / std
    return -0.5 * z * z - _SQRT_2PI - jnp.log(std)


def norm_cdf(x, mean=0.0, std=1.0):
    """Normal cdf, elementwise. Matches `utils/utils.py:4-22` (erf form)."""
    x = jnp.asarray(x)
    z = (x - mean) / std
    return ndtr(z)


def norm_ppf(p):
    """Inverse normal cdf (`scipy.stats.norm.ppf` equivalent)."""
    return ndtri(jnp.asarray(p))


# ---------------------------------------------------------------------------
# Student-t distribution
# ---------------------------------------------------------------------------


def t_logpdf(x, nu):
    x = jnp.asarray(x)
    nu = jnp.asarray(nu, dtype=jnp.result_type(x, jnp.float32))
    lognorm = (
        gammaln((nu + 1.0) / 2.0)
        - gammaln(nu / 2.0)
        - 0.5 * jnp.log(nu * jnp.pi)
    )
    return lognorm - 0.5 * (nu + 1.0) * jnp.log1p(x * x / nu)


def t_pdf(x, nu):
    """Student-t pdf. Finite inputs only (see `student.py:146-174` for the
    reference's non-finite guard, applied at the copula layer here)."""
    return jnp.exp(t_logpdf(x, nu))


_SMALL_Z = 1e-8  # below this, jax betainc loses accuracy/underflows (~1e-30)


def _log_betainc_small(a, b, z):
    """log I_z(a, b) for small z via
      I_z(a,b) = z^a (1-z)^b / (a B(a,b)) * 2F1(1, a+b; a+1; z),
    truncating the hypergeometric series at z^3 (relative error ~z^4).
    jax's betainc flushes to zero near z ~ 1e-30; this stays exact in
    log-space arbitrarily deep into the tail."""
    zc = jnp.minimum(z, _SMALL_Z)  # keep the unused branch finite
    c1 = (a + b) / (a + 1.0)
    c2 = c1 * (a + b + 1.0) / (a + 2.0)
    c3 = c2 * (a + b + 2.0) / (a + 3.0)
    series = 1.0 + zc * (c1 + zc * (c2 + zc * c3))
    return (
        a * jnp.log(zc)
        + b * jnp.log1p(-zc)
        - jnp.log(a)
        - betaln(a, b)
        + jnp.log(series)
    )


def t_sf(x, nu):
    """Student-t survival function P(T > x), elementwise.

    Uses the regularized incomplete beta identity
      P(|T| > x) = I_{nu/(nu+x^2)}(nu/2, 1/2)   for x >= 0,
    with a small-z log-series branch so deep tails (|x| ~ 1e100+) keep full
    relative accuracy instead of underflowing.
    """
    x = jnp.asarray(x)
    nu = jnp.asarray(nu, dtype=jnp.result_type(x, jnp.float32))
    z = nu / (nu + x * x)
    body = betainc(nu / 2.0, 0.5, z)
    deep = jnp.exp(_log_betainc_small(nu / 2.0, 0.5, z))
    tail = 0.5 * jnp.where(z < _SMALL_Z, deep, body)  # P(T > |x|)
    return jnp.where(x >= 0, tail, 1.0 - tail)


def t_cdf(x, nu):
    """Student-t cdf (`scipy.stats.t.cdf` equivalent).

    Computed as t_sf(-x, nu) by symmetry: the lower tail keeps full
    relative accuracy instead of cancelling against 1.
    """
    return t_sf(-jnp.asarray(x), nu)


def _log_t_sf(x_pos, nu):
    """log P(T > x) for x >= 0; accurate arbitrarily deep into the tail."""
    z = nu / (nu + x_pos * x_pos)
    ib = jnp.maximum(betainc(nu / 2.0, 0.5, z), jnp.finfo(z.dtype).tiny)
    log_body = jnp.log(ib)
    log_deep = _log_betainc_small(nu / 2.0, 0.5, z)
    return jnp.log(0.5) + jnp.where(z < _SMALL_Z, log_deep, log_body)


def _central_cut(dtype) -> float:
    """Central-branch cutoff on 0.5 - q (see t_ppf): f64 keeps the tight
    3e-4 window (series truncation ~1e-18 there); f32 widens to 4e-3,
    where the series is still exact to ~1e-10 but betainc-based Newton is
    noise-limited to ~1e-5 absolute."""
    return 3e-4 if dtype == jnp.float64 else 4e-3


def t_ppf(p, nu, *, iters: int = 64):
    """Inverse Student-t cdf, fully vectorized (replaces the reference's
    elementwise `scipy.stats.t.ppf` python loop, `student.py:82-104`).

    Solves log Q(x) = log q (Q the survival function) with a bisection-
    safeguarded Newton iteration; log-space makes the tail well-conditioned.
    `iters` is a static bound; convergence is typically < 40 iterations to
    f64 roundoff. Returns ±inf at p ∈ {0, 1} and NaN outside [0, 1].
    """
    p = jnp.asarray(p)
    dtype = jnp.result_type(p, jnp.float32)
    p = p.astype(dtype)
    nu = jnp.asarray(nu, dtype=dtype)

    # Work on the upper tail: solve Q(x) = q with q <= 1/2, x >= 0.
    q = jnp.where(p > 0.5, 1.0 - p, p)
    sign = jnp.where(p > 0.5, 1.0, -1.0)
    # Degenerate q handled by final where; keep iteration finite meanwhile.
    q_safe = jnp.clip(q, jnp.finfo(dtype).tiny, 0.5)
    log_q = jnp.log(q_safe)

    # Initial guesses: normal quantile for the body, power-law for the tail
    #   Q(x) ~ C * x^{-nu},  C = nu^{nu/2 - 1} / B(nu/2, 1/2)
    u = -ndtri(q_safe)  # >= 0
    log_c = (0.5 * nu - 1.0) * jnp.log(nu) - betaln(nu / 2.0, 0.5)
    x_tail = jnp.exp((log_c - log_q) / nu)
    x0 = jnp.maximum(u, x_tail)
    # Keep x^2 finite: quantiles this large only arise for p within ~1e-300
    # of 0 or 1.
    x0 = jnp.clip(x0, 0.0, jnp.sqrt(jnp.finfo(dtype).max) * 0.1)

    # Bracket: Q(0) = 0.5 >= q, so lo = 0 always valid. Grow hi until
    # Q(hi) <= q (a handful of doublings suffices from the tail guess).
    def grow(carry, _):
        hi = carry
        ok = _log_t_sf(hi, nu) <= log_q
        return jnp.where(ok, hi, 2.0 * hi + 1.0), None

    hi0, _ = jax.lax.scan(grow, x0 + 1.0, None, length=8)
    lo0 = jnp.zeros_like(x0)

    # Early-exit safeguarded Newton: `iters` bounds the loop, but the
    # bracket [lo, hi] contracts to relative roundoff in ~10-25 iterations
    # from the body/tail initial guesses, and the while_loop stops there —
    # a fixed-length scan would pay the full 64 betainc sweeps on every
    # call (t_ppf dominates IFM-fit and quadrature prep device time).
    # Safe: nothing differentiates through t_ppf (betainc has no parameter
    # derivative in JAX; the fit schedules precompute transforms outside
    # the differentiated losses).
    # Convergence gate: the proposed Newton step |g/dg| is a first-order
    # estimate of the remaining error in x; iterating once it falls below
    # ~500 eps * scale only produces a bisection dance against betainc's
    # own noise floor (measured: ~58 of the 64 bounded iterations were
    # spent there). Newton's quadratic phase reaches the gate in ~10-20
    # iterations. The 0.1 scale floor keeps small-|x| lanes achievable:
    # their absolute accuracy is noise-limited at ~eps * O(1) regardless
    # (|d log Q/dx| ~ O(1) there), and the central Taylor branch below
    # covers the region where that matters. Frozen (converged) lanes keep
    # their x: a lane at its root can have x_newton == hi (float-equal),
    # which would bisect it AWAY from the root while other lanes finish —
    # and the global exit could land on that jump iteration.
    eps_d = jnp.finfo(dtype).eps
    newton_lane = (0.5 - q_safe) >= _central_cut(dtype)

    def _tol_x(x):
        # absolute term 500 eps: betainc's noise makes the Newton step
        # jitter at ~50-250 eps absolute for body lanes (|d log Q/dx| ~ 1)
        return 500.0 * eps_d * (jnp.abs(x) + 1.0)

    def w_cond(carry):
        x, step_mag, _, _, it = carry
        return (it < iters) & jnp.any((step_mag > _tol_x(x)) & newton_lane)

    def w_body(carry):
        x, _, lo, hi, it = carry
        g = _log_t_sf(x, nu) - log_q
        # d/dx log Q = -pdf/Q;  log Q = log q + g  =>  Q = q * exp(g)
        log_sf = log_q + g
        dg = -jnp.exp(t_logpdf(x, nu) - log_sf)
        step = g / dg
        # Maintain bracket: Q decreasing, so g > 0 (Q too big) => x too small.
        lo = jnp.where(g > 0, x, lo)
        hi = jnp.where(g <= 0, x, hi)
        x_newton = x - step
        inside = (x_newton > lo) & (x_newton < hi)
        x_next = jnp.where(inside, x_newton, 0.5 * (lo + hi))
        step_mag = jnp.abs(step)
        x_next = jnp.where(step_mag <= _tol_x(x), x, x_next)  # freeze
        return (x_next, step_mag, lo, hi, it + 1)

    x, _, _, _, _ = jax.lax.while_loop(
        w_cond, w_body,
        (x0, jnp.full_like(x0, jnp.inf), lo0, hi0, jnp.zeros((), jnp.int32)),
    )

    # Central branch: betainc is ill-conditioned near z = 1 (x -> 0), so for
    # |p - 1/2| small invert the odd Taylor series of the cdf instead:
    #   F(x) = 1/2 + f(0) (x - (nu+1)/(6 nu) x^3 + O(x^5))
    # The cutoff is dtype-dependent: in f32 betainc noise dominates out to
    # |x| ~ 1e-2, while the (noise-free) series truncation error at the
    # wider cutoff is ~y^5 ~ 1e-10 — far below f32 resolution.
    f0 = jnp.exp(gammaln((nu + 1.0) / 2.0) - gammaln(nu / 2.0)) / jnp.sqrt(
        nu * jnp.pi
    )
    y = (0.5 - q_safe) / f0
    x_central = y + (nu + 1.0) / (6.0 * nu) * y**3
    x = jnp.where(0.5 - q_safe < _central_cut(dtype), x_central, x)

    out = sign * x
    out = jnp.where(p == 0.5, jnp.zeros_like(out), out)
    out = jnp.where(p <= 0.0, -jnp.inf, out)
    out = jnp.where(p >= 1.0, jnp.inf, out)
    out = jnp.where((p < 0.0) | (p > 1.0), jnp.nan, out)
    return out
