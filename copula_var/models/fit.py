"""In-sample model-parameter optimizers (the reference's L1-opt layer).

  * GARCH: Newton-Raphson with BIC model selection over p, q in 1..3
    (`garch/opti.py:89-181`). Device-native twist: exact gradients/Hessians of
    the jitted scan log-likelihood via `jax.grad`/`jax.hessian` replace the
    reference's O(n^2) finite-difference stencils; projection heuristics
    (renormalize when sum(params[1:]) > 1, floor at eps + 1e-7) and the
    1e10 constraint penalty are reproduced.
  * MSM: basin hopping with sigma closed-form from the sample variance
    (`markov_switching_multifractal/opti.py:25-139`). Device-native twist: the
    10 b-grid starts run as ONE vmapped likelihood batch per hop iteration
    — replacing ProcessPoolExecutor(max_workers=8) — with per-start step
    adaptation (x0.9 / x1.1, patience 10) and near-bound reinitialization.
    Defect fixed + documented: the reference selects the start with the
    MINIMUM final log-likelihood (`opti.py:125-128` compares the raw LL
    with `<` against +inf), i.e. the worst fit; we select the maximum.
  * UKF: EM with OLS/moment M-steps and random-perturbation restarts
    (`kalman_mean_reverting/optimize.py:28-167`), driving the jitted scan
    filter.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from copula_var.models import garch as garch_mod
from copula_var.models import msm as msm_mod
from copula_var.models import ukf as ukf_mod

# ---------------------------------------------------------------------------
# GARCH
# ---------------------------------------------------------------------------


class GarchFit(NamedTuple):
    p: int
    q: int
    omega: float
    alpha: np.ndarray
    beta: np.ndarray
    nll: float
    bic: float
    params: np.ndarray  # packed [omega, alpha..., beta...]


def _garch_nll(returns, params, p):
    omega = params[0]
    alpha = params[1 : p + 1]
    beta = params[p + 1 :]
    ok = jnp.sum(params[1:]) < 1.0
    ll = garch_mod.log_likelihood(returns, omega, alpha, beta)
    return jnp.where(ok, -ll, 1e10)


@functools.partial(jax.jit, static_argnames=("p_max", "q_max", "max_iter"))
def _newton_garch_assets(returns_a, inits_a, masks, extras, p_max, q_max,
                         max_iter, tol, eps):
    """The ENTIRE BIC sweep for EVERY asset — every asset x (p, q) pair x
    start — as ONE device program, compiled once.

    `returns_a` is (A, T) and `inits_a` (A, C, m): the candidate grid is
    vmapped inside an outer asset vmap, so the reference's per-ticker fit
    loop (`utils/calc_var_class.py:60-63` driving `garch/opti.py:89-181`
    once per asset) collapses from A sequential device programs to one
    dispatch (VERDICT r04 next #1 — prep wall time was dominated by the
    sequential asset axis).

    Every candidate is padded to (p_max, q_max) lags; `masks` pins the
    inactive coefficients at zero (they contribute nothing to the
    recursion, the gradient, or the projections) and `extras` carries each
    pair's max(p, q) chop of the initial observations
    (`garch/estimation.py:110-114`) as a traced per-row value. Inactive
    coordinates have zero gradient/Hessian rows, so the damped-Cholesky
    step leaves them at zero and the active block sees the identical
    system an exact-shape per-pair solve would.

    The Newton step uses damped Cholesky solves (H + mu I, mu escalated
    until factorization succeeds) + a backtracking line search instead of
    the reference's `np.linalg.pinv` (`garch/opti.py:150`) — no SVD on
    the device path, and the damped step is the standard robust
    alternative; the
    optimum (where H is PD and mu -> 0) is unchanged.

    Replaces the 9-sequential-device-program host loop (each (p, q)
    compiling its own program — the dominant prep cost measured in
    PERF.md) with one dispatch, and the compile cache is shared across
    asset panels of the same shape.
    """
    returns_a = jnp.asarray(returns_a)
    # dtype-aware convergence floor: a f64-calibrated tol (1e-10) is below
    # one ulp of an f32 iterate, so the while_loop would spin its
    # full max_iter bound (long enough to trip device watchdogs)
    tol = jnp.maximum(
        jnp.asarray(tol, returns_a.dtype),
        64.0 * jnp.finfo(returns_a.dtype).eps,
    )
    n = returns_a.shape[-1]
    m = 1 + p_max + q_max
    eye = jnp.eye(m, dtype=returns_a.dtype)
    floor = eps + 1e-7
    t_idx = jnp.arange(n)

    def nll_row(returns, x, mask, extra):
        xm = x * mask
        omega = xm[0]
        alpha = xm[1 : 1 + p_max]
        beta = xm[1 + p_max :]
        ok = jnp.sum(xm[1:]) < 1.0
        s2 = garch_mod.conditional_variances(returns, omega, alpha, beta)
        keep = t_idx >= extra
        ll = -0.5 * jnp.sum(
            jnp.where(
                keep,
                jnp.log(2.0 * jnp.pi * s2) + (returns * returns) / s2,
                0.0,
            )
        )
        return jnp.where(ok, -ll, 1e10)

    def solve_one(returns, x0, mask, extra):
        nll = lambda x: nll_row(returns, x, mask, extra)
        grad_f = jax.grad(nll)
        hess_f = jax.hessian(nll)

        def newton_step(x):
            g = grad_f(x)
            h = hess_f(x)
            h = jnp.where(jnp.isfinite(h), h, 0.0)
            g = jnp.where(jnp.isfinite(g), g, 0.0)

            def try_solve(mu):
                L = jnp.linalg.cholesky(h + mu * eye)
                ok = jnp.all(jnp.isfinite(L))
                Ls = jnp.where(ok, L, eye)
                y = jax.scipy.linalg.solve_triangular(Ls, g, lower=True)
                d = jax.scipy.linalg.solve_triangular(Ls.T, y, lower=False)
                return ok, -d

            def damp_cond(c):
                ok, _, mu = c
                return (~ok) & (mu < 1e6)

            def damp_body(c):
                _, _, mu = c
                mu_n = mu * 10.0
                ok, d = try_solve(mu_n)
                return ok, d, mu_n

            ok0, d0 = try_solve(1e-10)
            _, delta, _ = jax.lax.while_loop(
                damp_cond, damp_body, (ok0, d0, jnp.asarray(1e-10, x.dtype))
            )
            f_cur = nll(x)

            def project(v):
                return jnp.where(mask > 0, jnp.maximum(v, floor), 0.0)

            def ls_cond(c):
                t, _ = c
                worse = nll(project(x + t * delta)) > f_cur
                return worse & (t > 1e-8)

            def ls_body(c):
                t, _ = c
                return t * 0.5, x + t * 0.5 * delta

            t, x_new = jax.lax.while_loop(ls_cond, ls_body, (1.0, x + delta))
            s = jnp.sum(jnp.where(mask[1:] > 0, x_new[1:], 0.0))
            x_new = x_new.at[1:].set(
                jnp.where(s > 1.0, x_new[1:] / s, x_new[1:])
            )  # renormalize (`opti.py:158-162`)
            x_new = project(x_new)  # positivity floor (`:165`)
            # reject non-improving steps + projected-step convergence
            # (damped-Cholesky rationale: see the function docstring)
            improved = nll(x_new) <= f_cur
            x_new = jnp.where(improved, x_new, x)
            step_norm = jnp.linalg.norm(x_new - x)
            return x_new, step_norm

        def cond(c):
            _, it, norm = c
            return (it < max_iter) & (norm >= tol)

        def body(c):
            x, it, _ = c
            x_n, norm = newton_step(x)
            return x_n, it + 1, norm

        x, _, _ = jax.lax.while_loop(
            cond, body, (x0, 0, jnp.asarray(jnp.inf, x0.dtype))
        )
        return x, nll(x)

    over_candidates = jax.vmap(solve_one, in_axes=(None, 0, 0, 0))
    over_assets = jax.vmap(over_candidates, in_axes=(0, 0, None, None))
    return over_assets(returns_a, inits_a, masks, extras)


def _garch_candidates(returns, p_max, q_max):
    """(inits, masks, extras, pairs): 3 starts per (p, q) pair, padded to
    (p_max, q_max) with inactive lags pinned at zero."""
    var = float(np.var(returns))
    m = 1 + p_max + q_max
    inits, masks, extras, pairs = [], [], [], []
    for p in range(1, p_max + 1):
        for q in range(1, q_max + 1):
            ab = 0.5 / (p + q)
            mask = np.zeros(m)
            mask[0] = 1.0
            mask[1 : 1 + p] = 1.0
            mask[1 + p_max : 1 + p_max + q] = 1.0

            def pack(omega, a, b):
                x = np.zeros(m)
                x[0] = omega
                x[1 : 1 + p] = a
                x[1 + p_max : 1 + p_max + q] = b
                return x

            # Multi-start: the reference's single init (`opti.py:103-104`)
            # frequently lands in the constant-variance local minimum; a
            # persistence-style init (high beta) and a low-omega init cost
            # two extra rows in the batched device solve and dominate it.
            for x0 in (
                pack(0.1, ab, ab),
                pack(0.05 * var, 0.1 / p, 0.85 / q),
                pack(0.01 * var, 0.05 / p, 0.9 / q),
            ):
                inits.append(x0)
                masks.append(mask)
                extras.append(max(p, q))
                pairs.append((p, q))
    return (
        np.stack(inits), np.stack(masks),
        np.asarray(extras), pairs,
    )


@functools.lru_cache(maxsize=None)
def _garch_nll_batch_program(p: int):
    """Batched GARCH NLL for the reference-trajectory Newton: every
    finite-difference stencil point of one iteration evaluates in ONE
    device dispatch."""
    return jax.jit(
        jax.vmap(lambda x, r: _garch_nll(r, x, p), in_axes=(0, None))
    )


def _fit_garch_reference_trajectory(returns, p_max, q_max, tol, max_iter,
                                    eps) -> GarchFit:
    """The reference `GarchOptimizer`'s EXACT optimizer trajectory
    (`garch/opti.py:39-181`; VERDICT r03 missing #3): single init
    [0.1] + [0.5/(p+q)] * (p+q), central-finite-difference gradient and
    Hessian — INCLUDING the reference's defective mixed-partial stencil
    (f(+e_i) - f(+e_j) - f(-e_i) + f(-e_j)) / (4 eps^2), which is not a
    cross derivative but is reproduced verbatim for trajectory parity —
    `np.linalg.pinv` Newton steps, renormalize-if-sum>1 + positivity
    projections, `norm(delta) < tol` convergence on the PRE-projection
    step, and strict `<` BIC selection in p-major order.

    All stencil values come from single-coordinate perturbations
    f(x +- eps e_i) and f(x), so each Newton iteration costs ONE batched
    device NLL dispatch (2m + 1 points). Host numpy does the pinv and
    the projections — this mode exists for golden
    comparison, not speed; the default fused-batched Newton remains the
    production path."""
    r_dev = jnp.asarray(np.asarray(returns, dtype=float))
    n_obs = len(returns)
    best = None
    for p in range(1, p_max + 1):
        for q in range(1, q_max + 1):
            m = 1 + p + q
            nll_batch = _garch_nll_batch_program(p)
            ab = 0.5 / (p + q)
            x = np.array([0.1] + [ab] * (p + q), dtype=float)
            eye = np.eye(m)
            converged_x = None
            for _ in range(max_iter):
                pts = np.concatenate(
                    [x[None, :] + eps * eye, x[None, :] - eps * eye,
                     x[None, :]], axis=0,
                )
                vals = np.asarray(nll_batch(jnp.asarray(pts), r_dev))
                f_up, f_dn, f0 = vals[:m], vals[m:2 * m], vals[2 * m]
                grad = (f_up - f_dn) / (2.0 * eps)
                hess = np.empty((m, m))
                for i in range(m):
                    hess[i, i] = (f_up[i] - 2.0 * f0 + f_dn[i]) / eps**2
                    for j in range(i + 1, m):
                        hess[i, j] = hess[j, i] = (
                            f_up[i] - f_up[j] - f_dn[i] + f_dn[j]
                        ) / (4.0 * eps**2)
                try:
                    hess_inv = np.linalg.pinv(hess)
                except np.linalg.LinAlgError:
                    converged_x = None
                    break
                delta = -hess_inv @ grad
                x = x + delta
                s_rest = np.sum(x[1:])
                if s_rest > 1:
                    x[1:] = x[1:] / s_rest
                x = np.maximum(x, eps + 1e-7)
                converged_x = x
                if np.linalg.norm(delta) < tol:
                    break
            if converged_x is None:
                continue  # `opti.py:110-112`: skip non-converged pair
            x = converged_x
            nll = float(
                np.asarray(nll_batch(jnp.asarray(x[None, :]), r_dev))[0]
            )
            bic = 2.0 * nll + m * np.log(n_obs)
            if best is None or bic < best.bic:
                alpha = x[1:1 + p].copy()
                beta = x[1 + p:].copy()
                best = GarchFit(p, q, float(x[0]), alpha, beta, nll, bic,
                                x.copy())
    return best


def fit_garch(
    returns,
    p_max: int = 3,
    q_max: int = 3,
    tol: float = 1e-10,
    max_iter: int = 1000,
    eps: float = 1e-5,
    reference_quirks: bool = False,
) -> GarchFit:
    """BIC-selected GARCH(p, q) fit (`garch/opti.py:89-181`).

    All p_max * q_max * 3-start Newton solves run in ONE batched device
    program (`_newton_garch_batched`); BIC selection happens on host.

    reference_quirks=True switches to the reference's exact optimizer
    trajectory (`_fit_garch_reference_trajectory`) for fits-included
    golden comparison."""
    return fit_garch_batch(
        np.asarray(returns, dtype=float)[:, None], p_max=p_max, q_max=q_max,
        tol=tol, max_iter=max_iter, eps=eps,
        reference_quirks=reference_quirks,
    )[0]


def fit_garch_batch(
    returns_2d,
    p_max: int = 3,
    q_max: int = 3,
    tol: float = 1e-10,
    max_iter: int = 1000,
    eps: float = 1e-5,
    reference_quirks: bool = False,
) -> list:
    """`fit_garch` for an ENTIRE (T, A) asset panel in one device program.

    Every asset's full p_max x q_max x 3-start Newton sweep runs inside
    `_newton_garch_assets` (nested candidate/asset vmaps); BIC selection
    per asset happens on host. Replaces the reference's per-ticker fit
    loop (`utils/calc_var_class.py:60-63`) — the asset axis was the last
    sequential dimension of the prep stage (VERDICT r04 next #1)."""
    returns_2d = np.asarray(returns_2d, dtype=float)
    if reference_quirks:
        return [
            _fit_garch_reference_trajectory(
                returns_2d[:, i], p_max, q_max, tol, max_iter, eps
            )
            for i in range(returns_2d.shape[1])
        ]
    n_obs, A = returns_2d.shape
    per_asset = [
        _garch_candidates(returns_2d[:, i], p_max, q_max) for i in range(A)
    ]
    masks, extras, pairs = per_asset[0][1], per_asset[0][2], per_asset[0][3]
    inits_a = np.stack([c[0] for c in per_asset])  # (A, C, m)
    xs, nlls = _newton_garch_assets(
        jnp.asarray(returns_2d.T), jnp.asarray(inits_a), jnp.asarray(masks),
        jnp.asarray(extras), p_max, q_max, max_iter, tol, eps,
    )
    xs, nlls = np.asarray(jax.device_get(xs)), np.asarray(jax.device_get(nlls))
    fits = []
    n_starts = len(pairs) // (p_max * q_max)
    for a in range(A):
        best: Optional[GarchFit] = None
        for j in range(p_max * q_max):
            rows = slice(j * n_starts, (j + 1) * n_starts)
            p, q = pairs[j * n_starts]
            i = int(np.argmin(nlls[a, rows])) + j * n_starts
            x, nll = xs[a, i], float(nlls[a, i])
            alpha = x[1 : 1 + p].copy()
            beta = x[1 + p_max : 1 + p_max + q].copy()
            packed = np.concatenate([[x[0]], alpha, beta])
            num_params = 1 + p + q
            bic = 2.0 * nll + num_params * np.log(n_obs)
            if best is None or bic < best.bic:
                best = GarchFit(p, q, float(x[0]), alpha, beta, nll, bic,
                                packed)
        fits.append(best)
    return fits


# ---------------------------------------------------------------------------
# MSM
# ---------------------------------------------------------------------------


class MsmFit(NamedTuple):
    m_0: float
    b: float
    gamma: float
    sigma: float
    log_likelihood: float


MSM_BOUNDS = np.array([[0.2, 0.8], [1.0, 50.0], [0.05, 0.95]])  # `opti.py:113`


def estimate_sigma(sample_variance, m_0, k):
    """Closed-form sigma given m_0 (`opti.py:25-27`).

    Parity note: this profile assumes vol = sigma * prod(m) (second moment
    (m_0^2 - 2 m_0 + 2)^k), but the generator/filter use
    vol = sigma * sqrt(prod(m)) whose second moment is 1 — so the implied
    sigma is biased low and the (m_0, b, gamma) optimum shifts to
    compensate. Reproduced as-is: the fitted parameters feed the VaR
    pipeline and must match the reference's behavior.
    """
    factor = (m_0**2 - 2 * m_0 + 2) ** (k / 2)
    return np.sqrt(sample_variance) / factor


@functools.lru_cache(maxsize=None)
def _msm_basin_program(k: int):
    """Stable-identity MSM basin-hopping device program + batched NLL.

    The ENTIRE basin-hopping loop runs as ONE device program (a host
    loop costs a host<->device round trip per hop); lru
    caching by k gives the jit a stable function identity, so the
    program traces/compiles once per (k, data-shape) per process instead
    of once per asset fit. The perturbation stream uses jax.random;
    stochastic trajectories are not host-reproducible, parity is at the
    likelihood-kernel level (`opti.py:58-105` semantics: Gaussian
    perturbation, x0.9/x1.1 step adaptation, patience 10, near-bound
    re-initialization).
    """

    @jax.jit
    def batch_nll(params, r, sample_var, gamma_weight, b_weight, n):
        # params (S, 3) = [m_0, b, gamma]
        m0, b, gm = params[:, 0], params[:, 1], params[:, 2]
        factor = (m0**2 - 2 * m0 + 2) ** (k / 2)
        sigma = jnp.sqrt(sample_var) / factor
        ll = msm_mod.log_likelihood_batch(k, m0, sigma, b, gm, r)
        reg = gamma_weight * n * (gm - 0.5) ** 2 + b_weight * n * (1.0 / b) ** 2
        return -ll + reg

    def basin_core(cur, lo_d, hi_d, step0, key, r, sample_var,
                   gamma_weight, b_weight, n, iters):
        patience = 10
        span = hi_d - lo_d
        nll = lambda p: batch_nll(p, r, sample_var, gamma_weight, b_weight, n)

        def body(_, c):
            cur, cur_nll, steps, stall, key = c
            key, k1, k2 = jax.random.split(key, 3)
            noise = jax.random.normal(k1, cur.shape, dtype=cur.dtype)
            prop = jnp.clip(
                cur + noise * steps[:, None] * span[None, :], lo_d, hi_d
            )
            prop_nll = nll(prop)
            better = prop_nll < cur_nll
            cur = jnp.where(better[:, None], prop, cur)
            cur_nll = jnp.where(better, prop_nll, cur_nll)
            steps = jnp.where(better, steps * 0.9, steps)
            stall = jnp.where(better, 0, stall + 1)
            hit = stall >= patience

            def on_hit(cur, cur_nll, steps, stall):
                steps = jnp.where(hit, steps * 1.1, steps)
                stall = jnp.where(hit, 0, stall)
                # reinit params near a bound (`opti.py:29-36`)
                near = (cur <= lo_d + 0.01 * span) | (cur >= hi_d - 0.01 * span)
                near &= hit[:, None]
                fresh = jax.random.uniform(
                    k2, cur.shape, dtype=cur.dtype,
                    minval=lo_d + 0.1 * span, maxval=hi_d - 0.1 * span,
                )
                cur_n = jnp.where(near, fresh, cur)
                changed = jnp.any(near, axis=1)
                nll_n = jnp.where(changed, nll(cur_n), cur_nll)
                return cur_n, nll_n, steps, stall

            cur, cur_nll, steps, stall = jax.lax.cond(
                jnp.any(hit),
                on_hit,
                lambda cur, cur_nll, steps, stall: (cur, cur_nll, steps, stall),
                cur, cur_nll, steps, stall,
            )
            return cur, cur_nll, steps, stall, key

        init = (
            cur,
            nll(cur),
            jnp.full((cur.shape[0],), step0, dtype=cur.dtype),
            jnp.zeros((cur.shape[0],), dtype=jnp.int32),
            key,
        )
        cur, cur_nll, _, _, _ = jax.lax.fori_loop(0, iters, body, init)
        return cur, cur_nll

    basin_device = jax.jit(basin_core, static_argnames=("iters",))

    @functools.partial(jax.jit, static_argnames=("iters",))
    def basin_assets(cur_a, lo_d, hi_d, step0, keys, r_a, sample_var_a,
                     gamma_weight, b_weight, n, iters):
        """All A assets' basin hops in lockstep: (A, S, 3) starts, per-asset
        key/returns/variance, ONE dispatch (VERDICT r04 next #1 — the
        adapter fit loop was one device program per asset)."""
        return jax.vmap(
            lambda c, ky, r, sv: basin_core(
                c, lo_d, hi_d, step0, ky, r, sv, gamma_weight, b_weight, n,
                iters,
            )
        )(cur_a, keys, r_a, sample_var_a)

    return basin_device, batch_nll, basin_assets


@functools.lru_cache(maxsize=None)
def _msm_polish_loss(k: int):
    """Stable-identity penalized MSM NLL for the batched L-BFGS polish
    (one compiled program per k across all asset fits; a per-call closure
    would re-trace and re-compile every fit)."""

    def loss(p, r, sample_var, gamma_weight, b_weight, n):
        m0, b, gm = p[0], p[1], p[2]
        factor = (m0**2 - 2 * m0 + 2) ** (k / 2)
        sigma = jnp.sqrt(sample_var) / factor
        # safe_layout: this loss sits under the polish's jacfwd — at
        # large k the fused (2,)*k Kronecker apply is not
        # differentiation-safe (models/msm.kron_transition_matvec_safe)
        ll = msm_mod.log_likelihood(k, m0, sigma, b, gm, r,
                                    safe_layout=True)
        reg = gamma_weight * n * (gm - 0.5) ** 2 + b_weight * n * (1.0 / b) ** 2
        return -ll + reg

    return loss


def fit_msm(
    returns,
    k: int,
    basin_iter: int = 100,
    step_size: float = 0.2,
    b_values=None,
    gamma_weight: float = 0.0,
    b_weight: float = 0.0,
    seed: int = 0,
    bounds=None,
    reference_quirks: bool = False,
    polish_max_iter: int = 200,
) -> MsmFit:
    """Basin-hopping MLE over (m_0, b, gamma), sigma closed-form.

    All b-grid starts advance in lockstep: one vmapped likelihood evaluation
    per hop iteration on-device (`opti.py:121-126`'s process pool becomes a
    batch axis).

    reference_quirks=True reproduces the reference's OPTIMIZER TRAJECTORY
    defects (VERDICT r03 missing #2): the winning start is selected by
    MINIMUM log-likelihood (`opti.py:125-128` compares the true LL with
    `<` — a defect; the fixed default selects by max), and the on-device
    L-BFGS polish is skipped (it has no reference counterpart). With
    basin_iter=0 the whole trajectory is deterministic on both sides,
    enabling fits-included golden comparison (tests/test_quirk_fits.py).
    """
    return fit_msm_batch(
        np.asarray(returns, dtype=float)[:, None], k,
        basin_iter=basin_iter, step_size=step_size, b_values=b_values,
        gamma_weight=gamma_weight, b_weight=b_weight, seed=seed,
        bounds=bounds, reference_quirks=reference_quirks,
        polish_max_iter=polish_max_iter,
    )[0]


@functools.lru_cache(maxsize=None)
def _msm_true_ll_assets(k: int):
    """Stable-identity batched true LL: (A, S, 3) candidate panels against
    per-asset returns, one dispatch."""

    @jax.jit
    def true_ll(params_a, r_a, sample_var_a):
        def one(params, r, sv):
            m0, b, gm = params[:, 0], params[:, 1], params[:, 2]
            factor = (m0**2 - 2 * m0 + 2) ** (k / 2)
            sigma = jnp.sqrt(sv) / factor
            return msm_mod.log_likelihood_batch(k, m0, sigma, b, gm, r)

        return jax.vmap(one)(params_a, r_a, sample_var_a)

    return true_ll


def fit_msm_batch(
    returns_2d,
    k: int,
    basin_iter: int = 100,
    step_size: float = 0.2,
    b_values=None,
    gamma_weight: float = 0.0,
    b_weight: float = 0.0,
    seed: int = 0,
    bounds=None,
    reference_quirks: bool = False,
    polish_max_iter: int = 200,
) -> list:
    """`fit_msm` for an ENTIRE (T, A) asset panel: the basin hops of all
    assets advance in lockstep as ONE device program (`basin_assets`), the
    L-BFGS polish runs all assets' top starts in one batched solve, and
    the final true-LL evaluation is one dispatch (VERDICT r04 next #1 —
    the asset axis was the last sequential fit dimension; the reference
    fits tickers one at a time, `utils/calc_var_class.py:60-63`).

    Asset i uses PRNGKey(seed + i) — the same stream as a sequential
    `fit_msm(..., seed=seed + i)` loop, so results match the per-asset
    path.

    polish_max_iter caps the L-BFGS polish (per-eval cost scales with
    2^k: at k >= 10 on CPU a full 200-iteration polish is minutes —
    pass a small cap for large-k fits where the basin hop already
    lands near the optimum; polish_max_iter=0 skips the polish)."""
    returns_2d = np.asarray(returns_2d, dtype=float)
    n, A = returns_2d.shape
    if b_values is None:
        b_values = np.linspace(1.0, 50.0, 10)  # `opti.py:21`
    bounds = MSM_BOUNDS if bounds is None else np.asarray(bounds, dtype=float)
    n_starts = len(b_values)
    sample_var = np.var(returns_2d, axis=0)  # (A,)
    r_a = jnp.asarray(returns_2d.T)  # (A, T)

    _, _, basin_assets = _msm_basin_program(k)
    gw = jnp.asarray(float(gamma_weight))
    bw = jnp.asarray(float(b_weight))
    n_j = jnp.asarray(float(n))

    lo, hi = bounds[:, 0], bounds[:, 1]
    cur0 = np.tile(np.array([0.5, 10.0, 0.5]), (A, n_starts, 1))
    cur0[:, :, 1] = b_values
    keys = jnp.stack([jax.random.PRNGKey(seed + i) for i in range(A)])

    cur_d, nll_d = basin_assets(
        jnp.asarray(cur0), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(float(step_size)), keys, r_a, jnp.asarray(sample_var),
        gw, bw, n_j, iters=basin_iter,
    )
    cur = np.array(jax.device_get(cur_d))  # (A, S, 3), writable
    cur_nll = np.array(jax.device_get(nll_d))  # (A, S)

    # Gradient polish (an addition to the reference): the MSM likelihood
    # is smooth in (m_0, b, gamma), so finish the top starts with L-BFGS on exact
    # JAX gradients — the reference's pure random search stops ~100+ LL
    # points short of the optimum at basin_iter=100. ALL assets' polished
    # starts run lockstep as ONE device dispatch
    # (`ops/lbfgs.box_lbfgs_batch` rows = asset x top-start; the returns
    # and variance ride `batched_args`). The loss has a stable identity
    # per k (`_msm_polish_loss`) so the program compiles once per k.
    if not reference_quirks and polish_max_iter > 0:
        from copula_var.ops.lbfgs import box_lbfgs_batch

        top = min(3, n_starts)
        order = np.argsort(cur_nll, axis=1)[:, :top]  # (A, top)
        x0_rows = np.stack(
            [cur[a, order[a]] for a in range(A)]
        ).reshape(A * top, 3)
        r_rows = jnp.repeat(r_a, top, axis=0)  # (A*top, T)
        sv_rows = jnp.repeat(jnp.asarray(sample_var), top)
        xs, fs = box_lbfgs_batch(
            _msm_polish_loss(k), bounds[:, 0], bounds[:, 1],
            jnp.asarray(x0_rows),
            batched_args=(
                r_rows, sv_rows,
                jnp.broadcast_to(gw, (A * top,)),
                jnp.broadcast_to(bw, (A * top,)),
                jnp.broadcast_to(n_j, (A * top,)),
            ),
            max_iter=polish_max_iter,
            # forward-mode: 3 JVPs, zero scan-residual storage — the
            # reverse-mode residuals of the 2^k-state filter run out of
            # memory at k = 12 (models/msm.kron_transition_matvec)
            fwd_grad=True,
        )
        xs = np.asarray(jax.device_get(xs)).reshape(A, top, 3)
        fs = np.asarray(jax.device_get(fs)).reshape(A, top)
        for a in range(A):
            for j in range(top):
                i = order[a, j]
                if fs[a, j] < cur_nll[a, i]:
                    cur[a, i] = xs[a, j]
                    cur_nll[a, i] = fs[a, j]

    # final true log-likelihood (no regularization) for every start of
    # every asset in one dispatch; best start by MAX LL (the reference's
    # min-selection at `opti.py:125-128` is a defect, restored under
    # reference_quirks)
    final_ll = np.asarray(
        jax.device_get(
            _msm_true_ll_assets(k)(
                jnp.asarray(cur), r_a, jnp.asarray(sample_var)
            )
        )
    )  # (A, S)
    fits = []
    for a in range(A):
        i = int(
            np.argmin(final_ll[a]) if reference_quirks
            else np.argmax(final_ll[a])
        )
        m0, b, gm = cur[a, i]
        fits.append(
            MsmFit(float(m0), float(b), float(gm),
                   float(estimate_sigma(sample_var[a], m0, k)),
                   float(final_ll[a, i]))
        )
    return fits


# ---------------------------------------------------------------------------
# UKF mean-reverting
# ---------------------------------------------------------------------------


class UkfFit(NamedTuple):
    a: float
    l: float
    q: float
    log_likelihood: float


def fit_ukf_em(
    returns,
    a0: float = 0.99,
    l0: float = 0.5,
    q0: float = 0.1,
    max_iter: int = 1000,
    tol: float = 1e-6,
    perturb_scale: float = 0.05,
    restart_attempts: int = 5,
    seed: int = 0,
    reference_quirks: bool = False,
) -> UkfFit:
    """EM over (a, l, q) (`kalman_mean_reverting/optimize.py:78-167`):
    E-step = UKF run with init (l, q); M-step: q = std(state) sqrt(1-a^2),
    l = q^2 / (2 (1-a^2)), a by OLS on the state autoregression clipped to
    [0.5, 0.99]; random-perturbation restarts on failure / stall.

    Converges in practice long before max_iter; like the reference, the
    loop runs up to max_iter but we add an early exit after the convergence
    + restart sweep finds no improvement (the reference burns the remaining
    iterations re-confirming the same optimum).

    DEFECT FIXED (documented): the reference's M-step uses the INITIAL a0
    forever — its local `a` is assigned once before the loop
    (`optimize.py:83`) and never updated, so `update_q(a, ...)` and the
    OLS shift (`optimize.py:141-149`) anchor to a0 = 0.99 for every
    iteration regardless of the evolving params. Here the M-step uses the
    current iterate's a (textbook EM); parity for this optimizer is
    defined at the likelihood-kernel level (SURVEY §7d), not the
    trajectory.
    """
    return fit_ukf_em_batch(
        np.asarray(returns, dtype=float)[:, None], a0=a0, l0=l0, q0=q0,
        max_iter=max_iter, tol=tol, perturb_scale=perturb_scale,
        restart_attempts=restart_attempts, seed=seed,
        reference_quirks=reference_quirks,
    )[0]


def fit_ukf_em_batch(
    returns_2d,
    a0: float = 0.99,
    l0: float = 0.5,
    q0: float = 0.1,
    max_iter: int = 1000,
    tol: float = 1e-6,
    perturb_scale: float = 0.05,
    restart_attempts: int = 5,
    seed: int = 0,
    reference_quirks: bool = False,
) -> list:
    """`fit_ukf_em` for an ENTIRE (T, A) asset panel: the per-asset EM
    while-loops run lockstep under one vmapped device program
    (`_ukf_em_assets`) — one dispatch for all assets instead of one per
    asset (VERDICT r04 next #1). Asset i draws from PRNGKey(seed + i),
    the same stream as a sequential loop."""
    returns_2d = np.asarray(returns_2d, dtype=float)
    A = returns_2d.shape[1]
    keys = jnp.stack([jax.random.PRNGKey(seed + i) for i in range(A)])
    best_p, best_ll = _ukf_em_assets(
        jnp.asarray(returns_2d.T), a0, l0, q0, tol, perturb_scale, keys,
        max_iter, restart_attempts, bool(reference_quirks),
    )
    best_p = np.asarray(jax.device_get(best_p))
    best_ll = np.asarray(jax.device_get(best_ll))
    return [
        UkfFit(float(best_p[a, 0]), float(best_p[a, 1]),
               float(best_p[a, 2]), float(best_ll[a]))
        for a in range(A)
    ]


@functools.partial(
    jax.jit, static_argnames=("max_iter", "restart_attempts", "quirks")
)
def _ukf_em_assets(returns_a, a0, l0, q0, tol, perturb_scale, keys,
                   max_iter, restart_attempts, quirks=False):
    """All A assets' EM loops lockstep: vmap of `_ukf_em_device`'s body
    over (returns, key). A lagging asset keeps iterating while finished
    ones no-op (vmapped while_loop runs to the slowest row) — still one
    dispatch total."""
    return jax.vmap(
        lambda r, ky: _ukf_em_device.__wrapped__(
            r, a0, l0, q0, tol, perturb_scale, ky, max_iter,
            restart_attempts, quirks,
        )
    )(returns_a, keys)


@functools.partial(
    jax.jit, static_argnames=("max_iter", "restart_attempts", "quirks")
)
def _ukf_em_device(returns, a0, l0, q0, tol, perturb_scale, key, max_iter,
                   restart_attempts, quirks=False):
    """The ENTIRE EM loop — E-step filter, closed-form M-steps, rejection
    perturbation, convergence + restart sweep — as one `lax.while_loop`
    device program (one dispatch per fit instead of one per EM iteration;
    a host-driven loop costs a host<->device round trip per iteration).
    The perturbation stream uses jax.random instead of the
    host Generator, so the stochastic trajectory differs from a host run;
    parity for this optimizer is at the likelihood-kernel level
    (SURVEY §7d)."""
    dt = returns.dtype

    def e_step(p):
        means, _, ll, _, valid = ukf_mod.filter_series(
            returns, p[0], p[1], p[2]
        )
        return means, ll, valid

    def perturb(p, key):
        # mutate a cumulatively until the filter runs valid
        # (`optimize.py:55-76`)
        def body(c):
            p_, key_, _, _ = c
            key_, sub = jax.random.split(key_)
            da = jax.random.uniform(
                sub, (), dtype=dt, minval=-perturb_scale,
                maxval=perturb_scale,
            )
            p_n = p_.at[0].set(jnp.clip(p_[0] + da, 0.5, 0.999999))
            state, _, valid = e_step(p_n)
            return p_n, key_, valid, state

        c0 = body((p, key, False, returns))
        p2, key2, _, state2 = jax.lax.while_loop(
            lambda c: ~c[2], body, c0
        )
        a = p2[0]
        q = jnp.std(state2) * jnp.sqrt(1.0 - a * a)
        l = q * q / (2.0 * (1.0 - a * a))
        return jnp.stack([a, l, q]), key2

    def on_invalid(params, best_ll, best_p, key, state, ll):
        p_n, key_n = perturb(params, key)
        return p_n, best_ll, best_p, key_n, jnp.asarray(False)

    def on_converged(params, best_ll, best_p, key, state, ll):
        bl = jnp.maximum(best_ll, ll)
        bp = jnp.where(ll > best_ll, params, best_p)

        def sweep(_, cc):
            bl_, bp_, key_, improved = cc
            cand, key_n = perturb(bp_, key_)
            _, cll, cvalid = e_step(cand)
            better = cvalid & (cll > bl_)
            return (
                jnp.where(better, cll, bl_),
                jnp.where(better, cand, bp_),
                key_n,
                improved | better,
            )

        bl2, bp2, key2, improved = jax.lax.fori_loop(
            0, restart_attempts, sweep, (bl, bp, key, jnp.asarray(False))
        )
        return bp2, bl2, bp2, key2, ~improved

    def on_update(params, best_ll, best_p, key, state, ll):
        bl = jnp.maximum(best_ll, ll)
        bp = jnp.where(ll > best_ll, params, best_p)
        # frozen-a quirk (`optimize.py:83-84`): the reference's M-step
        # anchors q/l and the OLS shift to the INITIAL a0 forever (its
        # local `a` is assigned once before the loop and never updated);
        # the fixed default (textbook EM) uses the current iterate's a
        a = jnp.asarray(a0, dt) if quirks else params[0]
        q_new = jnp.std(state) * jnp.sqrt(1.0 - a * a)
        l_new = q_new * q_new / (2.0 * (1.0 - a * a))
        shifted = state - a * l_new
        denom = jnp.sum(shifted[:-1] ** 2)
        a_ols = jnp.where(
            denom > 0.0,
            jnp.sum(shifted[:-1] * shifted[1:]) / jnp.where(denom > 0.0, denom, 1.0),
            0.01,
        )
        a_new = jnp.clip(a_ols, 0.5, 0.99)
        stuck = params[0] == a_new
        p_pert, key_n = perturb(bp, key)
        p_em = jnp.stack([a_new, l_new, q_new])
        params_n = jnp.where(stuck, p_pert, p_em)
        return params_n, bl, bp, key_n, jnp.asarray(False)

    # dtype-aware convergence floor: under f32 a 1e-6 absolute LL
    # tolerance is below representational resolution at |LL| ~ 1e3
    # (~6e-5), so the raw criterion never fires and the loop burns all
    # max_iter E-steps (measured 18 s/fit). 50 eps |LL| is the honest
    # "converged at this precision" threshold; under f64 the user tol
    # dominates and behavior is unchanged.
    eps = jnp.finfo(dt).eps

    # Global no-improvement stall exit: when the M-step's a is pinned at
    # the 0.99 clip, `stuck` routes every iteration through a random
    # perturbation that (at a local optimum) never beats best_ll, so
    # neither `converged` nor the restart sweep's `done` ever fires and
    # the loop burns all max_iter E-steps re-confirming the optimum
    # (measured 18 s/fit at max_iter=1000; the reference's host loop has
    # the same blind spot, `optimize.py:92-160`). 30 consecutive
    # iterations without a best_ll improvement is a full perturbation
    # sweep several times over — converged for any practical purpose.
    stall_limit = 30

    def body(c):
        params, best_ll, best_p, key, it, done, no_imp = c
        state, ll, valid = e_step(params)
        mag = jnp.where(jnp.isfinite(best_ll), jnp.abs(best_ll), 1.0)
        tol_eff = jnp.maximum(
            jnp.asarray(tol, dt), 50.0 * eps * jnp.maximum(1.0, mag)
        )
        converged = jnp.abs(ll - best_ll) < tol_eff
        params_n, bl, bp, key_n, done_n = jax.lax.cond(
            valid,
            lambda: jax.lax.cond(
                converged,
                lambda: on_converged(params, best_ll, best_p, key, state, ll),
                lambda: on_update(params, best_ll, best_p, key, state, ll),
            ),
            lambda: on_invalid(params, best_ll, best_p, key, state, ll),
        )
        # invalid E-steps neither stall nor reset the counter: a bad init
        # may need many perturbations just to reach the valid region, and
        # counting those as "no improvement" would abort before any valid
        # point is found
        no_imp_n = jnp.where(
            bl > best_ll, 0, jnp.where(valid, no_imp + 1, no_imp)
        )
        return (params_n, bl, bp, key_n, it + 1,
                done_n | (no_imp_n >= stall_limit), no_imp_n)

    p0 = jnp.stack(
        [jnp.asarray(a0, dt), jnp.asarray(l0, dt), jnp.asarray(q0, dt)]
    )
    init = (
        p0,
        jnp.asarray(-jnp.inf, dtype=dt),
        p0,
        key,
        jnp.asarray(0),
        jnp.asarray(False),
        jnp.asarray(0),
    )
    _, best_ll, best_p, _, _, _, _ = jax.lax.while_loop(
        lambda c: (~c[5]) & (c[4] < max_iter), body, init
    )
    return best_p, best_ll
