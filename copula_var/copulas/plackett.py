"""Plackett copula (strictly bivariate): density and IFM log-likelihood.

Capability surface of the reference `copulas/plackett/`: the closed-form
density loop (`plackett/plackett.py:45-71`), the d = 2 restriction
(`plackett.py:20-21`), and the IFM likelihood
(`plackett/inference_for_margins.py:32-49`).

Formula parity note: the reference's denominator
  [(1 + (theta-1)(u+v)) (1 + (theta-1)(1-u-v))]^2
differs from the textbook Plackett density denominator
  ([1 + (theta-1)(u+v)]^2 - 4 theta (theta-1) u v)^{3/2};
we reproduce the reference's formula exactly — parity is defined against its
outputs, and the deviation is documented here rather than silently fixed."""

from __future__ import annotations

import jax.numpy as jnp

from copula_var.copulas.common import PENALTY


def copula_density(u, theta):
    """Plackett density for u of shape (..., 2) (`plackett.py:45-71`)."""
    u = jnp.asarray(u)
    if u.shape[-1] != 2:
        raise ValueError(
            "Plackett copula is only defined for 2-dimensional marginals."
        )
    theta = jnp.asarray(theta, dtype=u.dtype)
    a, b = u[..., 0], u[..., 1]
    tm1 = theta - 1.0
    num = theta * (1.0 + tm1 * (a + b - 2.0 * a * b))
    denom = ((1.0 + tm1 * (a + b)) * (1.0 + tm1 * (1.0 - a - b))) ** 2
    return num / denom


def ifm_log_likelihood(marginals, densities, theta):
    """sum log f_i + sum log c (`plackett/inference_for_margins.py:41-49`)."""
    c = copula_density(marginals, theta)
    return jnp.sum(jnp.log(jnp.asarray(densities))) + jnp.sum(jnp.log(c))


def negative_log_likelihood(theta, marginals, densities):
    """NLL over theta (>= 0.1 bound enforced by the optimizer schedule,
    `plackett/opti.py:66-67`); non-finite guarded with the 1e10 penalty."""
    nll = -ifm_log_likelihood(marginals, densities, theta)
    return jnp.where(jnp.isfinite(nll), nll, PENALTY)
