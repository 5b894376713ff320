"""Student-t copula: density and IFM log-likelihood as fused XLA ops.

Capability surface of the reference `copulas/student/`:
  c(u) = MVT_pdf(T_nu^-1(u); Sigma, nu) / prod_i t_pdf(T_nu^-1(u_i))
(`student/student.py:49-174`). The reference's dominant scalar hot spot —
the elementwise `scipy.stats.t.ppf` double loop (`student.py:96-104`) — is
replaced by the fully vectorized `ops.special.t_ppf`, so the whole density
is one fused tensor program.

Non-finite guard parity: the reference zeroes both the MVT pdf and the
univariate pdfs when any transformed coordinate is non-finite
(`student.py:128-131,165-168`), making the ratio NaN (0/0). We reproduce
exactly that NaN so downstream `nan_to_num` handling
(`garch_integration_function.py:43-51`) behaves identically."""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from copula_var.copulas.common import (
    PENALTY,
    corr_matrix_from_params,
    is_positive_definite,
)
from copula_var.ops.special import t_ppf


def copula_density(u, nu, corr):
    """Student-t copula density for u of shape (..., d)
    (`student.py:49-79`)."""
    u = jnp.asarray(u)
    corr = jnp.asarray(corr)
    d = corr.shape[-1]
    nu = jnp.asarray(nu, dtype=u.dtype)
    x = t_ppf(u, nu)
    finite = jnp.all(jnp.isfinite(x), axis=-1)
    xs = jnp.where(finite[..., None], x, 0.0)

    # Cholesky-based quadratic form/determinant (see
    # gaussian._chol_quad_logdet).
    L = jnp.linalg.cholesky(corr)
    flat = xs.reshape(-1, d)
    y = jax.scipy.linalg.solve_triangular(L, flat.T, lower=True)
    quad = jnp.sum(y * y, axis=0).reshape(xs.shape[:-1])
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))

    log_mvt = (
        gammaln((nu + d) / 2.0)
        - gammaln(nu / 2.0)
        - (d / 2.0) * jnp.log(nu * jnp.pi)
        - 0.5 * logdet
        - ((nu + d) / 2.0) * jnp.log1p(quad / nu)
    )
    log_uni = (
        gammaln((nu + 1.0) / 2.0)
        - gammaln(nu / 2.0)
        - 0.5 * jnp.log(nu * jnp.pi)
        - ((nu + 1.0) / 2.0) * jnp.log1p(xs * xs / nu)
    )
    ratio = jnp.exp(log_mvt - jnp.sum(log_uni, axis=-1))
    # reference: 0/0 -> NaN when any coordinate is non-finite
    return jnp.where(finite, ratio, jnp.nan)


def ifm_log_likelihood(marginals, densities, nu, corr):
    """IFM log-likelihood: sum log f_i + sum log c (no floor for Student;
    `student/inference_for_margins.py:38-55`)."""
    c = copula_density(marginals, nu, corr)
    return jnp.sum(jnp.log(jnp.asarray(densities))) + jnp.sum(jnp.log(c))


def precompute_transform(marginals, nu):
    """Per-(data, nu) constants of the IFM loss: the ppf transform and the
    univariate log-pdf sum. Across an L-BFGS correlation solve these never
    change, so hoisting them removes every t_ppf call from the optimizer's
    inner loop. Returns (z (N, d) zero-filled at non-finite, finite (N,),
    log_uni_sum (N,))."""
    u = jnp.asarray(marginals)
    nu = jnp.asarray(nu, dtype=u.dtype)
    x = t_ppf(u, nu)
    finite = jnp.all(jnp.isfinite(x), axis=-1)
    z = jnp.where(finite[..., None], x, 0.0)
    log_uni = (
        gammaln((nu + 1.0) / 2.0)
        - gammaln(nu / 2.0)
        - 0.5 * jnp.log(nu * jnp.pi)
        - ((nu + 1.0) / 2.0) * jnp.log1p(z * z / nu)
    )
    return z, finite, jnp.sum(log_uni, axis=-1)


def negative_log_likelihood_from_transform(
    corr_params, z, finite, log_uni_sum, nu, log_density_sum, dim: int
):
    """Penalized IFM NLL from precomputed transforms (no ppf inside).
    `log_density_sum` is the constant sum(log densities) term."""
    nu = jax.lax.stop_gradient(jnp.asarray(nu, dtype=z.dtype))
    corr = corr_matrix_from_params(corr_params, dim)
    ok = is_positive_definite(corr) & jnp.all(jnp.isfinite(corr))
    safe = jnp.where(ok, corr, jnp.eye(dim, dtype=corr.dtype))

    L = jnp.linalg.cholesky(safe)
    y = jax.scipy.linalg.solve_triangular(L, z.T, lower=True)
    quad = jnp.sum(y * y, axis=0)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    log_mvt = (
        gammaln((nu + dim) / 2.0)
        - gammaln(nu / 2.0)
        - (dim / 2.0) * jnp.log(nu * jnp.pi)
        - 0.5 * logdet
        - ((nu + dim) / 2.0) * jnp.log1p(quad / nu)
    )
    log_c = jnp.where(finite, log_mvt - log_uni_sum, jnp.nan)
    nll = -(log_density_sum + jnp.sum(log_c))
    return jnp.where(ok, nll, PENALTY)


def negative_log_likelihood(params, marginals, densities, dim: int):
    """Penalized NLL over packed (nu, corr_params)
    (`student/opti.py:34-64`)."""
    params = jnp.asarray(params)
    return negative_log_likelihood_fixed_nu(
        params[1:], params[0], marginals, densities, dim
    )


def negative_log_likelihood_fixed_nu(corr_params, nu, marginals, densities, dim: int):
    """Penalized NLL over corr_params with nu treated as a non-differentiated
    input.

    JAX's betainc (inside t_ppf) has no derivative rule for its shape
    parameter, so nu is wrapped in stop_gradient: the loss stays
    differentiable w.r.t. corr_params AND one jitted instance serves every
    nu in the stage-1 IFM grid (`student/opti.py:116-147`) without
    recompilation."""
    nu = jax.lax.stop_gradient(jnp.asarray(nu))
    corr = corr_matrix_from_params(corr_params, dim)
    ok = is_positive_definite(corr) & jnp.all(jnp.isfinite(corr))
    safe = jnp.where(ok, corr, jnp.eye(dim, dtype=corr.dtype))
    nll = -ifm_log_likelihood(marginals, densities, nu, safe)
    return jnp.where(ok, nll, PENALTY)
