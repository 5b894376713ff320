"""Masked dense tensor-product quadrature — the computational heart.

Device-first re-architecture of the reference's recursive ragged-grid engine
(`utils/calc_integral/create_grids.py`, `integration_algo.py`, and the two
integrands under `integration_functions/`). The reference builds, per
bounds pair, a ragged grid whose innermost dimension is filtered by the
portfolio half-space cut, then evaluates the copula density point-by-point
(`create_grids.py:102-143`, `calc_integral.py:63-109`). Here:

  * The grid is the FULL tensor product of the shared non-uniform x-grid
    (static shape n^dim), and the half-space cut is a mask
    `dyn_lower < x_inner <= dyn_upper` — same point set, fixed shapes,
    no recursion (`create_grids.py:102-110` semantics: strict lower,
    inclusive upper, lower clamped to the box, upper unclamped).
  * Everything per-day is SEPARABLE per dimension until the copula's joint
    term: marginal CDFs, ppf transforms, and state densities are evaluated
    per coordinate (dim x n values), not per grid point — this removes the
    reference's dominant cost (elementwise `t.ppf` over every grid point,
    `student/student.py:96-104`).
  * The state-combination reduction is a matrix sandwich
    `W_0 (C .* M) W_1^T` of small matmuls (at HIGHEST precision, so f32
    inputs never drop to TF32 on a GPU), and
    the whole thing vmaps over the T out-of-sample days (replacing the
    joblib process pool, `calc_integral.py:211-223`).

Parity quirks reproduced exactly:
  * rotated density rows: grid dimension d weights with
    `densities[(d-1) mod dim]` (`create_grids.py:121,143`);
  * the outer box is inclusive on both ends (`create_grids.py:127`),
    the inner cut is strict-lower/inclusive-upper with the lower bound
    clamped to the box and the upper bound unclamped;
  * GARCH-family integrand applies nan_to_num to (copula * pdf-product)
    before the step weights (`garch_integration_function.py:43-51`);
    the MSM integrand applies no nan handling
    (`msm_integration_function.py:38-47`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from copula_var.ops.special import norm_cdf, norm_pdf, norm_ppf, t_ppf

# every f32-capable contraction asks for full f32 (no TF32 on the GPU)
_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HIGHEST)

BOX_MIN = -5.0
BOX_MAX = 5.0


class CopulaSpec(NamedTuple):
    """Static copula selector + parameter pytree for the quadrature kernels.

    kind: 'gaussian' | 'student' | 'plackett' (static under jit).
    For gaussian: params = corr (d, d). For student: (nu, corr).
    For plackett: theta scalar.
    """

    kind: str
    params: tuple


def halfspace_mask(x, lower, upper, weights, box_min=BOX_MIN):
    """Mask over the full tensor-product grid for the portfolio cut
    {x : lower < w.x <= upper} resolved on the innermost dimension.

    x: (n,) shared 1-D grid. weights: (dim,) with weights[0] paired to the
    innermost (last) grid dimension and weights[1:] to the outer dims in
    order (`integration_algo.py:5-20`). Returns a bool array of shape
    (n,) * dim. The inner cut is `x > dyn_lower (clamped to box_min)` and
    `x <= dyn_upper (unclamped)` (`create_grids.py:102-110`). Thin
    adapter over the ragged-column mask (`halfspace_mask_cols`)."""
    weights = jnp.asarray(weights)
    dim = weights.shape[0]
    return halfspace_mask_cols([x] * dim, lower, upper, weights, box_min)


def _all_pairs_quad(z_cols, sigma_inv):
    """Quadratic form z^T Sigma^-1 z over the tensor-product grid, built
    from per-dimension coordinate vectors z_cols[d] of shape (n_d,) —
    lengths may differ per dim (the grid-sharded engine chunks the
    outermost coordinate). Returns an array of shape (n_0, ..., n_{dim-1})."""
    dim = len(z_cols)
    out = jnp.zeros((1,) * dim)
    for d in range(dim):
        shape = [1] * dim
        shape[d] = z_cols[d].shape[0]
        out = out + sigma_inv[d, d] * (z_cols[d] ** 2).reshape(shape)
        for e in range(d + 1, dim):
            shape_e = [1] * dim
            shape_e[e] = z_cols[e].shape[0]
            out = out + (2.0 * sigma_inv[d, e]) * (
                z_cols[d].reshape(shape) * z_cols[e].reshape(shape_e)
            )
    return out


def _chol_inv_logdet(corr):
    L = jnp.linalg.cholesky(corr)
    inv_L = jax.scipy.linalg.solve_triangular(
        L, jnp.eye(corr.shape[-1], dtype=corr.dtype), lower=True
    )
    sigma_inv = _mm(inv_L.T, inv_L)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    return sigma_inv, logdet


def desaturate_f32(u):
    """Keep f32 marginal CDFs strictly inside (0, 1).

    In f32, norm_cdf saturates to exactly 1.0 beyond ~5.3 sigma (f64
    only beyond ~8.3), so a day with an extreme fitted vol feeds
    ppf(1.0) = inf into the copula transform and the whole day NaNs —
    purely an f32 artifact: the f64 engine, and the reference, stay
    finite on the same inputs (observed on the flagship run: the f32
    engines produced NaN days the CPU f64 record solves). The f64
    path is NOT clamped: a true u in {0, 1} keeps the reference's
    NaN-on-saturation parity (`student.py:128-131`)."""
    u = jnp.asarray(u)
    if u.dtype != jnp.float32:
        return u
    eps = jnp.finfo(jnp.float32).eps
    return jnp.clip(u, 1e-37, 1.0 - eps)


def transform_u_columns(u_cols, spec: CopulaSpec):
    """Per-coordinate copula pre-transforms on (dim, n) marginal-CDF
    columns. Everything ppf-shaped — the reference's dominant scalar cost
    (`student/student.py:96-104`) — happens HERE, on dim*n values, and is
    bounds-invariant, so cached engines hoist it out of the solver loop.

    f32 inputs are desaturated (see `desaturate_f32`) — every cached/
    tcached/grid-sharded engine funnels through this transform, so the
    clamp covers them all; f64 passes through untouched (parity).

    Returns a tuple of (dim, n) arrays:
      plackett -> (u,);   gaussian -> (z,) with z = norm_ppf(u);
      student  -> (z, finite, log_uni) with z = where(finite, t_ppf(u), 0)
                  and log_uni the log univariate-t pdf at z.
    """
    u_cols = desaturate_f32(jnp.asarray(u_cols))
    if spec.kind == "plackett":
        return (u_cols,)
    if spec.kind == "gaussian":
        return (norm_ppf(u_cols),)
    if spec.kind == "student":
        nu, _ = spec.params
        nu = jnp.asarray(nu, dtype=u_cols.dtype)
        z_raw = t_ppf(u_cols, nu)
        fin = jnp.isfinite(z_raw)
        z = jnp.where(fin, z_raw, 0.0)
        log_uni = (
            gammaln((nu + 1.0) / 2.0)
            - gammaln(nu / 2.0)
            - 0.5 * jnp.log(nu * jnp.pi)
            - ((nu + 1.0) / 2.0) * jnp.log1p(z * z / nu)
        )
        return (z, fin, log_uni)
    raise ValueError(f"unknown copula kind: {spec.kind}")


def copula_density_from_transformed(cols, spec: CopulaSpec):
    """Copula density over the full tensor-product grid from pre-transformed
    per-dimension columns (output of `transform_u_columns`). Returns shape
    (n,) * dim. Numerically identical to `grid_copula_density`. Thin
    adapter over the ragged-column builder (`copula_density_cols`) — one
    copy of the density formulas serves the sharded and unsharded
    engines alike."""
    dim = cols[0].shape[0]
    col_list = [tuple(leaf[d] for leaf in cols) for d in range(dim)]
    return copula_density_cols(col_list, spec)


def copula_density_cols(col_list, spec: CopulaSpec):
    """`copula_density_from_transformed` for RAGGED per-dimension columns:
    col_list[d] is the transform tuple for grid dim d with its own length
    n_d (e.g. a device's chunk of the outermost coordinate under the
    grid-sharded engine). Returns shape (n_0, ..., n_{dim-1})."""
    dim = len(col_list)
    lens = [c[0].shape[0] for c in col_list]

    def expand(v, d):
        shape = [1] * dim
        shape[d] = lens[d]
        return v.reshape(shape)

    if spec.kind == "plackett":
        (theta,) = spec.params
        if dim != 2:
            raise ValueError("Plackett copula requires dim == 2")
        a = col_list[0][0][:, None]
        b = col_list[1][0][None, :]
        tm1 = theta - 1.0
        num = theta * (1.0 + tm1 * (a + b - 2.0 * a * b))
        den = ((1.0 + tm1 * (a + b)) * (1.0 + tm1 * (1.0 - a - b))) ** 2
        return num / den

    if spec.kind == "gaussian":
        (corr,) = spec.params
        z_cols = [c[0] for c in col_list]
        sigma_inv, logdet = _chol_inv_logdet(corr)
        quad = _all_pairs_quad(z_cols, sigma_inv)
        sum_z2 = jnp.zeros((1,) * dim)
        for d in range(dim):
            sum_z2 = sum_z2 + expand(z_cols[d] ** 2, d)
        return jnp.exp(-0.5 * (logdet + quad - sum_z2))

    if spec.kind == "student":
        nu, corr = spec.params
        nu = jnp.asarray(nu, dtype=col_list[0][0].dtype)
        z_cols = [c[0] for c in col_list]
        sigma_inv, logdet = _chol_inv_logdet(corr)
        quad = _all_pairs_quad(z_cols, sigma_inv)
        log_mvt = (
            gammaln((nu + dim) / 2.0)
            - gammaln(nu / 2.0)
            - (dim / 2.0) * jnp.log(nu * jnp.pi)
            - 0.5 * logdet
            - ((nu + dim) / 2.0) * jnp.log1p(quad / nu)
        )
        log_uni_sum = jnp.zeros((1,) * dim)
        finite = jnp.ones((1,) * dim, dtype=bool)
        for d in range(dim):
            log_uni_sum = log_uni_sum + expand(col_list[d][2], d)
            finite = finite & expand(col_list[d][1], d)
        ratio = jnp.exp(log_mvt - log_uni_sum)
        return jnp.where(finite, ratio, jnp.nan)

    raise ValueError(f"unknown copula kind: {spec.kind}")


def halfspace_mask_cols(x_cols, lower, upper, weights, box_min=BOX_MIN):
    """`halfspace_mask` for RAGGED per-dimension coordinate vectors
    x_cols[d] of length n_d (the grid-sharded chunk of the outermost
    dim). Same cut semantics: inner strict-lower/inclusive-upper, outer
    dims unmasked."""
    weights = jnp.asarray(weights)
    dim = weights.shape[0]
    lens = [c.shape[0] for c in x_cols]
    if dim == 1:
        prev = jnp.zeros(())
    else:
        prev = jnp.zeros((1,) * (dim - 1))
        for d in range(dim - 1):
            shape = [1] * (dim - 1)
            shape[d] = lens[d]
            prev = prev + x_cols[d].reshape(shape) * weights[1 + d]
    dyn_upper = (upper - prev) / weights[0]
    dyn_lower = jnp.maximum((lower - prev) / weights[0], box_min)
    xs = x_cols[-1].reshape((1,) * (dim - 1) + (lens[-1],))
    return (xs > dyn_lower[..., None]) & (xs <= dyn_upper[..., None])


def grid_copula_density(u_cols, spec: CopulaSpec):
    """Copula density over the full tensor-product grid from per-dimension
    marginal-CDF columns u_cols (dim, n). Returns shape (n,) * dim.

    Exactly the reference densities (`gaussian.py:47-61`, `student.py:49-79`,
    `plackett.py:45-71`) evaluated with per-coordinate transforms: the ppf
    runs on dim*n values instead of n^dim grid points.
    """
    return copula_density_from_transformed(
        transform_u_columns(u_cols, spec), spec
    )


def _contract_states(V, w_cols):
    """Contract the grid tensor V ((n,)*dim) against per-dim state-weight
    matrices w_cols[d] of shape (q_d, n). Returns (q_0, ..., q_{dim-1}).
    For dim == 2 this is the sandwich W0 @ V @ W1^T."""
    dim = len(w_cols)
    if dim == 2:
        return _mm(_mm(w_cols[0], V), w_cols[1].T)
    out = V
    for d in range(dim):
        # contract grid axis d (now leading) with w_cols[d]
        out = jnp.tensordot(w_cols[d], out, axes=([1], [d]),
                            precision=_HIGHEST)
        # state axis lands in front; after all dims, axes are reversed
    # tensordot loop above leaves state axes in reverse order; fix.
    return jnp.transpose(out, tuple(range(dim - 1, -1, -1)))


def state_weight_matrices(densities, dx):
    """Per-dimension quadrature weight matrices with the reference's rotated
    density-row indexing: grid dim d uses `densities[(d-1) mod dim]`
    (`create_grids.py:121,143`). densities: (dim, q, n); dx: (n,).
    Returns list of dim arrays (q, n)."""
    densities = jnp.asarray(densities)
    dim = densities.shape[0]
    return [densities[(d - 1) % dim] * dx[None, :] for d in range(dim)]


# ---------------------------------------------------------------------------
# MSM-family integrand (`msm_integration_function.py:27-47`)
# ---------------------------------------------------------------------------


def msm_integral_day(
    bounds,
    forecasts_by_states,
    forecast_combos,
    x,
    dx,
    densities,
    unique_vols,
    weights,
    spec: CopulaSpec,
    box_min=BOX_MIN,
):
    """One out-of-sample day's integral, MSM mixture variant.

    bounds: (2,) [lower, upper]; forecasts_by_states: (dim, q) collapsed
    state-forecast probabilities; forecast_combos: (q^dim,) joint combo
    probabilities (ij order, matching `create_vol_combinations`);
    densities: (dim, q, n) per-(dim,state) normal densities on x;
    unique_vols: (dim, q).
    """
    dim, q = unique_vols.shape
    # per-dim mixture CDF at each coordinate: (dim, n)
    u_cols = jnp.sum(
        forecasts_by_states[:, :, None]
        * norm_cdf(x[None, None, :] / unique_vols[:, :, None]),
        axis=1,
    )
    C = grid_copula_density(u_cols, spec)
    M = halfspace_mask(x, bounds[0], bounds[1], weights, box_min)
    V = jnp.where(M, C, 0.0)
    w_cols = state_weight_matrices(densities, dx)
    per_combo = _contract_states(V, w_cols).reshape(-1)  # (q^dim,) ij order
    return jnp.sum(per_combo * forecast_combos)


# ---------------------------------------------------------------------------
# GARCH / mean-reverting integrand (`garch_integration_function.py:27-52`)
# ---------------------------------------------------------------------------


def garch_integral_day(bounds, forecast_vols, x, dx, weights, spec: CopulaSpec,
                      box_min=BOX_MIN):
    """One day's integral, single-forecast-vol variant.

    forecast_vols: (dim,) one sigma per asset. The explicit pdf product
    `prod_d phi(x_d / sigma_d) / sigma_d` is separable per dimension; the
    nan_to_num is applied to (copula * pdf-product) before the step
    weights, exactly as `garch_integration_function.py:43-51`.
    """
    dim = forecast_vols.shape[0]
    n = x.shape[0]
    u_cols = norm_cdf(x[None, :] / forecast_vols[:, None])  # (dim, n)
    p_cols = norm_pdf(x[None, :] / forecast_vols[:, None]) / forecast_vols[:, None]
    C = grid_copula_density(u_cols, spec)
    pdf_prod = jnp.ones((1,) * dim)
    for d in range(dim):
        shape = [1] * dim
        shape[d] = n
        pdf_prod = pdf_prod * p_cols[d].reshape(shape)
    V = jnp.nan_to_num(C * pdf_prod)
    M = halfspace_mask(x, bounds[0], bounds[1], weights, box_min)
    V = jnp.where(M, V, 0.0)
    w_cols = [dx[None, :]] * dim  # densities are ones at grid build
    return _contract_states(V, w_cols).reshape(())


# ---------------------------------------------------------------------------
# Batched engines (vmap over the T out-of-sample days)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("kind",))
def _msm_batch(bounds, fbs, fcombos, x, dx, densities, unique_vols, weights,
               box_min, kind, params):
    spec = CopulaSpec(kind, params)
    f = jax.vmap(
        lambda b, s, c: msm_integral_day(
            b, s, c, x, dx, densities, unique_vols, weights, spec, box_min
        )
    )
    return f(bounds, fbs, fcombos)


def msm_integrals(bounds, forecasts_by_states, forecast_combos, x, dx,
                  densities, unique_vols, weights, spec: CopulaSpec,
                  box_min=BOX_MIN):
    """(T,) integrals: vmap of `msm_integral_day` over days — the device
    replacement for the joblib fan-out (`calc_integral.py:211-223`)."""
    return _msm_batch(
        bounds, forecasts_by_states, forecast_combos, x, dx, densities,
        unique_vols, weights, box_min, spec.kind, spec.params,
    )


@functools.partial(jax.jit, static_argnames=("kind",))
def _garch_batch(bounds, fvols, x, dx, weights, box_min, kind, params):
    spec = CopulaSpec(kind, params)
    f = jax.vmap(
        lambda b, v: garch_integral_day(b, v, x, dx, weights, spec, box_min)
    )
    return f(bounds, fvols)


def garch_integrals(bounds, forecast_vols, x, dx, weights, spec: CopulaSpec,
                    box_min=BOX_MIN):
    """(T,) integrals for the GARCH / mean-reverting families."""
    return _garch_batch(
        bounds, forecast_vols, x, dx, weights, box_min, spec.kind, spec.params
    )


# ---------------------------------------------------------------------------
# Cached-density fast path for the bisection loop
# ---------------------------------------------------------------------------
#
# The VaR solver evaluates ~24 bound sweeps per backtest
# (`calc_var_class.py:111-169,278-309`) and only the half-space mask depends
# on the bounds: the per-day copula-density grid — including every ppf
# transform, the dominant cost — is bounds-INVARIANT. Precomputing the
# (T, n, n) day tensors once turns each bisection iteration into a masked
# sandwich (mask + two small matmuls), removing all special-function
# work from the hot loop. Numerically identical to the direct engine up to
# summation reassociation.


@functools.partial(jax.jit, static_argnames=("kind",))
def _msm_day_tensors(fbs, x, unique_vols, kind, params):
    spec = CopulaSpec(kind, params)

    def one_day(f):
        u_cols = jnp.sum(
            f[:, :, None] * norm_cdf(x[None, None, :] / unique_vols[:, :, None]),
            axis=1,
        )
        return grid_copula_density(u_cols, spec)

    return jax.vmap(one_day)(fbs)


def msm_day_tensors(forecasts_by_states, x, unique_vols, spec: CopulaSpec):
    """(T, n, n) copula-density grids, one per out-of-sample day."""
    return _msm_day_tensors(
        jnp.asarray(forecasts_by_states), jnp.asarray(x),
        jnp.asarray(unique_vols), spec.kind, spec.params,
    )


@functools.partial(jax.jit, static_argnames=())
def msm_integrals_cached(bounds, C, forecast_combos, x, dx, densities, weights,
                         box_min=BOX_MIN):
    """(T,) integrals from precomputed day tensors (dim == 2)."""
    w_cols = state_weight_matrices(densities, jnp.asarray(dx))

    def one_day(b, c, fc):
        M = halfspace_mask(x, b[0], b[1], weights, box_min)
        V = jnp.where(M, c, 0.0)
        per_combo = _mm(_mm(w_cols[0], V), w_cols[1].T).reshape(-1)
        return jnp.sum(per_combo * fc)

    return jax.vmap(one_day)(bounds, C, forecast_combos)


@functools.partial(jax.jit, static_argnames=("kind",))
def _garch_day_tensors(fvols, x, kind, params):
    spec = CopulaSpec(kind, params)
    n = x.shape[0]
    dim = fvols.shape[1]

    def one_day(fv):
        u_cols = norm_cdf(x[None, :] / fv[:, None])
        p_cols = norm_pdf(x[None, :] / fv[:, None]) / fv[:, None]
        C = grid_copula_density(u_cols, spec)
        pdf_prod = jnp.ones((1,) * dim)
        for d in range(dim):
            shape = [1] * dim
            shape[d] = n
            pdf_prod = pdf_prod * p_cols[d].reshape(shape)
        return jnp.nan_to_num(C * pdf_prod)

    return jax.vmap(one_day)(fvols)


def garch_day_tensors(forecast_vols, x, spec: CopulaSpec):
    """(T, n, n) nan_to_num(copula * pdf-product) grids per day."""
    return _garch_day_tensors(
        jnp.asarray(forecast_vols), jnp.asarray(x), spec.kind, spec.params
    )


@functools.partial(jax.jit, static_argnames=())
def garch_integrals_cached(bounds, V, x, dx, weights, box_min=BOX_MIN):
    """(T,) integrals from precomputed GARCH-family day tensors."""

    def one_day(b, v):
        M = halfspace_mask(x, b[0], b[1], weights, box_min)
        vm = jnp.where(M, v, 0.0)
        return _mm(_mm(dx, vm), dx)

    return jax.vmap(one_day)(bounds, V)


# ---------------------------------------------------------------------------
# Transform-cached engines (any dim)
# ---------------------------------------------------------------------------
#
# The (T, n, n) day-tensor cache above is dim == 2 only: for dim >= 3 the
# full density grids would be (T, n^dim) — 4 GB at T=500, n=100, dim=3.
# The transform cache keeps the middle ground: the per-day per-coordinate
# copula pre-transforms (ppf and friends, (T, dim, n) — the reference's
# dominant cost) are computed ONCE, and each solver sweep recombines them
# into the n^dim density, masks, and contracts. Days are evaluated in
# fixed-size chunks (`lax.map` batch_size) so peak memory is
# day_batch * n^dim regardless of T.


# One day's density grid may transiently materialize n^dim f64 elements;
# beyond this budget even a 1-day chunk is an HBM-OOM hazard (n=100,
# dim=4 -> 1e8 elements = 800 MB, and several such transients coexist in
# one sweep program). Fail loudly instead of letting the scheduler
# discover it (the reference's engine is likewise fragile above dim 2 —
# `create_grids.py:135-137` — but fails silently/wrong). 2^26 elements =
# 512 MB f64 keeps previously-working dim-3 configs (e.g. n=257) legal.
MAX_GRID_ELEMENTS_PER_DAY = 1 << 26


def _day_batch(n: int, dim: int, T: int) -> int:
    """Chunk size bounding transient density-grid memory to ~2^21 f64
    elements (16 MB) per chunk; raises if even one day exceeds the
    per-day transient budget."""
    if n**dim > MAX_GRID_ELEMENTS_PER_DAY:
        raise ValueError(
            f"quadrature grid of num_points={n}^dim={dim} = {n**dim:.2e} "
            f"points per day exceeds the "
            f"{MAX_GRID_ELEMENTS_PER_DAY:.2e}-element transient budget "
            f"(~{MAX_GRID_ELEMENTS_PER_DAY * 8 >> 20} MB f64). Reduce "
            f"num_points (e.g. <= {int(MAX_GRID_ELEMENTS_PER_DAY ** (1 / dim))} "
            f"at dim={dim}) or the portfolio dimension."
        )
    return max(1, min(T, (1 << 21) // max(1, n**dim)))


@functools.partial(jax.jit, static_argnames=("kind",))
def _msm_day_columns(fbs, x, unique_vols, kind, params):
    spec = CopulaSpec(kind, params)

    def one_day(f):
        u_cols = jnp.sum(
            f[:, :, None] * norm_cdf(x[None, None, :] / unique_vols[:, :, None]),
            axis=1,
        )
        return transform_u_columns(u_cols, spec)

    return jax.vmap(one_day)(fbs)


def msm_day_columns(forecasts_by_states, x, unique_vols, spec: CopulaSpec):
    """Per-day cached copula pre-transform columns (pytree, leading T)."""
    return _msm_day_columns(
        jnp.asarray(forecasts_by_states), jnp.asarray(x),
        jnp.asarray(unique_vols), spec.kind, spec.params,
    )


@functools.partial(jax.jit, static_argnames=("kind", "day_batch"))
def _msm_tcached(bounds, cols, fcombos, x, dx, densities, weights, box_min,
                 kind, params, day_batch):
    spec = CopulaSpec(kind, params)
    w_cols = state_weight_matrices(densities, jnp.asarray(dx))

    def one_day(args):
        b, c, fc = args
        C = copula_density_from_transformed(c, spec)
        M = halfspace_mask(x, b[0], b[1], weights, box_min)
        V = jnp.where(M, C, 0.0)
        per_combo = _contract_states(V, w_cols).reshape(-1)
        return jnp.sum(per_combo * fc)

    return jax.lax.map(
        one_day, (bounds, cols, fcombos), batch_size=day_batch
    )


def msm_integrals_tcached(bounds, cols, forecast_combos, x, dx, densities,
                          weights, spec: CopulaSpec, box_min=BOX_MIN,
                          day_batch=None):
    """(T,) MSM-family integrals from cached transform columns (any dim)."""
    bounds = jnp.asarray(bounds)
    x = jnp.asarray(x)
    densities = jnp.asarray(densities)
    dim = densities.shape[0]
    T = bounds.shape[0]
    if day_batch is None:
        day_batch = _day_batch(x.shape[0], dim, T)
    return _msm_tcached(
        bounds, cols, jnp.asarray(forecast_combos), x, jnp.asarray(dx),
        densities, jnp.asarray(weights), box_min, spec.kind, spec.params,
        day_batch,
    )


@functools.partial(jax.jit, static_argnames=("kind",))
def _garch_day_columns(fvols, x, kind, params):
    spec = CopulaSpec(kind, params)

    def one_day(fv):
        u_cols = norm_cdf(x[None, :] / fv[:, None])
        p_cols = norm_pdf(x[None, :] / fv[:, None]) / fv[:, None]
        return transform_u_columns(u_cols, spec), p_cols

    return jax.vmap(one_day)(fvols)


def garch_day_columns(forecast_vols, x, spec: CopulaSpec):
    """Cached (transform columns, pdf columns) for the GARCH/MR family."""
    return _garch_day_columns(
        jnp.asarray(forecast_vols), jnp.asarray(x), spec.kind, spec.params
    )


@functools.partial(jax.jit, static_argnames=("kind", "day_batch"))
def _garch_tcached(bounds, cols, p_cols, x, dx, weights, box_min, kind,
                   params, day_batch):
    spec = CopulaSpec(kind, params)
    dim = p_cols.shape[1]
    n = x.shape[0]

    def one_day(args):
        b, c, p = args
        C = copula_density_from_transformed(c, spec)
        pdf_prod = jnp.ones((1,) * dim)
        for d in range(dim):
            shape = [1] * dim
            shape[d] = n
            pdf_prod = pdf_prod * p[d].reshape(shape)
        V = jnp.nan_to_num(C * pdf_prod)
        M = halfspace_mask(x, b[0], b[1], weights, box_min)
        V = jnp.where(M, V, 0.0)
        w_cols = [dx[None, :]] * dim
        return _contract_states(V, w_cols).reshape(())

    return jax.lax.map(
        one_day, (bounds, cols, p_cols), batch_size=day_batch
    )


def garch_integrals_tcached(bounds, cols, p_cols, x, dx, weights,
                            spec: CopulaSpec, box_min=BOX_MIN,
                            day_batch=None):
    """(T,) GARCH/MR integrals from cached transform columns (any dim)."""
    bounds = jnp.asarray(bounds)
    x = jnp.asarray(x)
    p_cols = jnp.asarray(p_cols)
    T, dim = bounds.shape[0], p_cols.shape[1]
    if day_batch is None:
        day_batch = _day_batch(x.shape[0], dim, T)
    return _garch_tcached(
        bounds, cols, p_cols, x, jnp.asarray(dx), jnp.asarray(weights),
        box_min, spec.kind, spec.params, day_batch,
    )


# ---------------------------------------------------------------------------
# Trapezoid refinement sweeps (refine_root — VERDICT r04 next #3)
# ---------------------------------------------------------------------------
#
# The production masked sweeps reproduce the reference's right-rectangle
# rule with a HARD inner cut (`create_grids.py:102-110`): the CDF is a
# staircase in the VaR bound and the rule is first-order, so the solved
# root carries an O(cell) systematic bias vs the continuous quantile
# (measured: mean -1.5e-2 at n=100 on the closed-form Gaussian check —
# bias, not plateau rounding, dominates). The refinement pass re-solves
# in a +-cell window around the staircase root against a SECOND-ORDER
# estimate of the same integrand: trapezoid node weights (each node owns
# [x_k - tw_k/2, x_k + tw_k/2]) and FRACTIONAL inclusion of the boundary
# cell, which makes F continuous and piecewise-linear in the bound.
# Opt-in (`VaRBacktest.refine_root`); the default path is untouched, so
# reference parity is preserved.


def trap_weights(x):
    """Second-order (trapezoid) node weights for the non-uniform grid:
    interior node k owns (x_{k+1} - x_{k-1}) / 2; the end nodes own one
    full adjacent step (their cells extend past the box edge, matching
    the reference's duplicated first step)."""
    x = jnp.asarray(x)
    return jnp.concatenate([
        (x[1] - x[0])[None], (x[2:] - x[:-2]) / 2.0, (x[-1] - x[-2])[None],
    ])


def halfspace_frac_cols(x_cols, tw_inner, lower, upper, weights,
                        box_min=BOX_MIN):
    """Fractional-cell analog of `halfspace_mask_cols` (RAGGED per-dim
    coordinate vectors): the inner-dimension boundary node is included in
    proportion to how much of its owned cell
    [x_k - tw_k/2, x_k + tw_k/2] lies inside {lower < w.x <= upper}.
    Returns a float array (n_0, ..., n_{dim-1}), continuous in the
    bounds. The single copy of the boundary-fraction math — the fixed-
    length `halfspace_frac` and every grid-sharded trap sweep delegate
    here."""
    weights = jnp.asarray(weights)
    dim = weights.shape[0]
    lens = [c.shape[0] for c in x_cols]
    if dim == 1:
        prev = jnp.zeros(())
    else:
        prev = jnp.zeros((1,) * (dim - 1))
        for d in range(dim - 1):
            shape = [1] * (dim - 1)
            shape[d] = lens[d]
            prev = prev + x_cols[d].reshape(shape) * weights[1 + d]
    dyn_upper = (upper - prev) / weights[0]
    dyn_lower = jnp.maximum((lower - prev) / weights[0], box_min)
    x_in = x_cols[-1]
    cell_lo = (x_in - tw_inner / 2.0).reshape(
        (1,) * (dim - 1) + (lens[-1],)
    )
    tws = tw_inner.reshape((1,) * (dim - 1) + (lens[-1],))
    a_up = jnp.clip((dyn_upper[..., None] - cell_lo) / tws, 0.0, 1.0)
    a_lo = jnp.clip((dyn_lower[..., None] - cell_lo) / tws, 0.0, 1.0)
    return jnp.maximum(a_up - a_lo, 0.0)


def halfspace_frac(x, tw, lower, upper, weights, box_min=BOX_MIN):
    """Fractional-cell analog of `halfspace_mask` (shared 1-D grid on
    every dim). Thin adapter over `halfspace_frac_cols`."""
    weights = jnp.asarray(weights)
    dim = weights.shape[0]
    return halfspace_frac_cols([x] * dim, tw, lower, upper, weights,
                               box_min)


def msm_integrals_trap(bounds, C, forecast_combos, x, densities, weights,
                       box_min=BOX_MIN):
    """(T,) trapezoid/fractional-cell integrals from the dim-2 MSM day
    tensors (refinement twin of `msm_integrals_cached`)."""
    x = jnp.asarray(x)
    tw = trap_weights(x)
    w_cols = state_weight_matrices(densities, tw)

    def one_day(b, c, fc):
        A = halfspace_frac(x, tw, b[0], b[1], weights, box_min)
        # NaN cells OUTSIDE the slab must contribute 0 exactly like the
        # staircase's where-mask (C * A alone poisons the day with NaN
        # from excluded saturated-marginal cells); NaN INSIDE the slab
        # still surfaces, matching the staircase kernels
        V = jnp.where(A > 0.0, c, 0.0) * A
        per_combo = _mm(_mm(w_cols[0], V), w_cols[1].T).reshape(-1)
        return jnp.sum(per_combo * fc)

    return jax.vmap(one_day)(bounds, C, forecast_combos)


def garch_integrals_trap(bounds, V, x, weights, box_min=BOX_MIN):
    """(T,) trapezoid/fractional-cell integrals from the dim-2 GARCH/MR
    day tensors (refinement twin of `garch_integrals_cached`)."""
    x = jnp.asarray(x)
    tw = trap_weights(x)

    def one_day(b, v):
        A = halfspace_frac(x, tw, b[0], b[1], weights, box_min)
        # where-mask before scaling (see msm_integrals_trap): the
        # production garch tensors are nan_to_num'd at build, but the
        # trap twin must not be the one path that poisons on raw NaN
        return _mm(_mm(tw, jnp.where(A > 0.0, v, 0.0) * A), tw)

    return jax.vmap(one_day)(bounds, V)


@functools.partial(jax.jit, static_argnames=("kind", "day_batch"))
def _msm_tcached_trap(bounds, cols, fcombos, x, densities, weights, box_min,
                      kind, params, day_batch):
    spec = CopulaSpec(kind, params)
    tw = trap_weights(x)
    w_cols = state_weight_matrices(densities, tw)

    def one_day(args):
        b, c, fc = args
        C = copula_density_from_transformed(c, spec)
        A = halfspace_frac(x, tw, b[0], b[1], weights, box_min)
        # where-mask before scaling: see msm_integrals_trap
        V = jnp.where(A > 0.0, C, 0.0) * A
        per_combo = _contract_states(V, w_cols).reshape(-1)
        return jnp.sum(per_combo * fc)

    return jax.lax.map(
        one_day, (bounds, cols, fcombos), batch_size=day_batch
    )


@functools.partial(jax.jit, static_argnames=("kind", "day_batch"))
def _garch_tcached_trap(bounds, cols, p_cols, x, weights, box_min, kind,
                        params, day_batch):
    spec = CopulaSpec(kind, params)
    dim = p_cols.shape[1]
    n = x.shape[0]
    tw = trap_weights(x)

    def one_day(args):
        b, c, p = args
        C = copula_density_from_transformed(c, spec)
        pdf_prod = jnp.ones((1,) * dim)
        for d in range(dim):
            shape = [1] * dim
            shape[d] = n
            pdf_prod = pdf_prod * p[d].reshape(shape)
        V = jnp.nan_to_num(C * pdf_prod)  # garch family nan_to_num parity
        A = halfspace_frac(x, tw, b[0], b[1], weights, box_min)
        w_cols = [tw[None, :]] * dim
        return _contract_states(V * A, w_cols).reshape(())

    return jax.lax.map(
        one_day, (bounds, cols, p_cols), batch_size=day_batch
    )
