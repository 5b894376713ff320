"""Student-t copula test-data generator (`copulas/student/generate.py`).

Reproduces the reference's seeded fixture pipeline exactly, fully
vectorized (the reference loops `t_copula` over 100k pairs with a scalar
bisection ppf, `generate.py:66-90`):

  1. n uniform pairs from the legacy NumPy global RNG, seed 42
     (`np.random.seed(42)`; `np.random.rand(n, 2)`), for bit-identical
     fixture data.
  2. "Copula value" per pair using the reference's APPROXIMATE t-cdf
     (`t_cdf`, `generate.py:6-20`): exact only for nu = 1; the general
     branch `0.5 + x a b` is a pdf-based approximation — reproduced, not
     fixed, because the selected top-N set depends on it.
  3. Bisection inverse of that approximate cdf on [-1000, 1000] to
     tol 1e-6 (`inverse_t_cdf`, `generate.py:22-48`), including the
     return-0 branch when the bracket does not sign-change.
  4. Keep the top `top_n` pairs by copula value (argsort order), then
     marginals = the pairs, densities = phi(Phi^-1(T_nu_cdf(pairs)))
     using the EXACT scipy-equivalent t cdf (`generate.py:84-88`).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from copula_var.ops.special import norm_pdf, norm_ppf, t_cdf as t_cdf_exact


def approx_t_cdf(x, nu):
    """The reference's approximate t-cdf (`generate.py:6-20`), vectorized.
    Exact only for nu == 1; otherwise 0.5 + x * pdf-ish term."""
    x = np.asarray(x, dtype=float)
    if nu <= 0:
        raise ValueError("Degrees of freedom must be positive")
    if nu == 1:
        return 0.5 + np.arctan(x) / math.pi
    a = math.gamma((nu + 1) / 2) / (math.sqrt(nu * math.pi) * math.gamma(nu / 2))
    b = (1 + (x**2) / nu) ** (-(nu + 1) / 2)
    return 0.5 + x * a * b


def inverse_approx_t_cdf(u, nu, tol=1e-6, max_iter=100):
    """Vectorized bisection inverse of `approx_t_cdf` on [-1000, 1000]
    (`generate.py:22-48`), with the reference's return-0 branch when the
    initial bracket does not sign-change."""
    u = np.asarray(u, dtype=float)
    a = np.full_like(u, -1000.0)
    b = np.full_like(u, 1000.0)
    fa = approx_t_cdf(a, nu) - u
    fb = approx_t_cdf(b, nu) - u
    invalid = fa * fb >= 0
    out = np.zeros_like(u)
    done = invalid.copy()
    for _ in range(max_iter):
        c = (a + b) / 2.0
        fc = approx_t_cdf(c, nu) - u
        conv = (np.abs(fc) < tol) | ((b - a) / 2.0 < tol)
        newly = conv & ~done
        out[newly] = c[newly]
        done |= conv
        go_left = fa * fc < 0
        b = np.where(go_left & ~done, c, b)
        fb = np.where(go_left & ~done, fc, fb)
        a = np.where(~go_left & ~done, c, a)
        fa = np.where(~go_left & ~done, fc, fa)
        if done.all():
            break
    return out


def t_copula_value(u1, u2, rho, nu):
    """The reference's bivariate t-copula kernel value
    (`t_copula`, `generate.py:50-64`), elementwise-vectorized."""
    x1 = inverse_approx_t_cdf(np.asarray(u1), nu)
    x2 = inverse_approx_t_cdf(np.asarray(u2), nu)
    term2 = (x1**2 + x2**2 - 2 * rho * x1 * x2) / (nu * (1 - rho**2))
    return (1 + term2) ** (-(nu + 2) / 2)


def generate_student_t_copula_data(
    n: int = 100000, nu: float = 5, rho: float = 0.5, top_n: int = 1000
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference-identical fixture data (`generate.py:66-90`): returns
    (marginals (top_n, 2), densities (top_n, 2))."""
    np.random.seed(42)  # reference reproducibility seed (`generate.py:70`)
    random_couples = np.random.rand(n, 2)
    vals = t_copula_value(random_couples[:, 0], random_couples[:, 1], rho, nu)
    top = np.argsort(vals)[-top_n:]
    best = random_couples[top]
    x = np.asarray(norm_ppf(np.asarray(t_cdf_exact(best, nu))))
    densities = np.asarray(norm_pdf(x))
    return best, densities
