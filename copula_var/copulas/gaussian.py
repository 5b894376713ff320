"""Gaussian copula: density and IFM log-likelihood as fused XLA ops.

Capability surface of the reference `copulas/gaussian/`:
  c(u) = MVN_pdf(Phi^-1(u); Sigma) / prod_i phi(Phi^-1(u_i))
(`gaussian/gaussian.py:47-117`), IFM log-likelihood with a 1e-10 density
floor (`gaussian/inference_for_margins.py:34-53`), and the L-BFGS-compatible
penalized negative log-likelihood (`gaussian/opti.py:30-56`).

Everything is expressed per-sample and vmaps over arbitrary leading batch
axes; the matrix inverse/determinant are computed once per density call
(shape (d, d)), so the per-point work is one small quadratic form that XLA
fuses with the surrounding quadrature."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from copula_var.copulas.common import (
    PENALTY,
    corr_matrix_from_params,
    is_positive_definite,
)
from copula_var.ops.special import norm_ppf

_LOG_2PI = 1.8378770664093454835606594728112353


def _chol_quad_logdet(corr, z):
    """(||L^-1 z||^2, log det corr) via Cholesky.

    Cholesky rather than LU-based `jnp.linalg.inv`/`slogdet`: it compiles
    in f64 on every backend and is better conditioned for correlation
    matrices.
    """
    L = jnp.linalg.cholesky(corr)
    # solve L y = z^T for all sample vectors at once
    flat = z.reshape(-1, z.shape[-1])
    y = jax.scipy.linalg.solve_triangular(L, flat.T, lower=True)
    quad = jnp.sum(y * y, axis=0).reshape(z.shape[:-1])
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    return quad, logdet


def log_density(u, corr):
    """log Gaussian copula density.

    The pdf ratio of `gaussian.py:47-61` simplifies to
      -1/2 (log det Sigma + z^T (Sigma^-1 - I) z),  z = Phi^-1(u)
    (identical in exact arithmetic to the reference's explicit MVN /
    product-of-pdfs ratio)."""
    u = jnp.asarray(u)
    corr = jnp.asarray(corr)
    z = norm_ppf(u)
    quad, logdet = _chol_quad_logdet(corr, z)
    return -0.5 * (logdet + quad - jnp.sum(z * z, axis=-1))


def copula_density(u, corr):
    """Gaussian copula density for u of shape (..., d)
    (`gaussian.py:47-61`)."""
    return jnp.exp(log_density(u, corr))


def ifm_log_likelihood(marginals, densities, corr):
    """IFM log-likelihood: sum log f_i + sum log max(c, 1e-10)
    (`inference_for_margins.py:48-53`; the floor is Gaussian-specific)."""
    c = jnp.maximum(copula_density(marginals, corr), 1e-10)
    return jnp.sum(jnp.log(jnp.asarray(densities))) + jnp.sum(jnp.log(c))


def negative_log_likelihood(corr_params, marginals, densities, dim: int):
    """Penalized NLL over packed correlation params, jit/vmap/grad-safe
    (`gaussian/opti.py:30-56`): non-PD or non-finite matrices return 1e10."""
    corr = corr_matrix_from_params(corr_params, dim)
    ok = is_positive_definite(corr) & jnp.all(jnp.isfinite(corr))
    safe = jnp.where(ok, corr, jnp.eye(dim, dtype=corr.dtype))
    nll = -ifm_log_likelihood(marginals, densities, safe)
    return jnp.where(ok, nll, PENALTY)
