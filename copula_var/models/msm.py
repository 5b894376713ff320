"""Markov-Switching Multifractal (MSM) volatility model as JAX scan kernels.

Capability surface of the reference `markov_switching_multifractal/` package:
state-space construction, transition probabilities, vol states
(`calc_prob.py:86-108`), Hamilton filter + log-likelihood
(`calc_prob.py:7-69,110-142`), predictive marginals/densities/forecasts
(`calc_marginals.py:7-38`), and the synthetic simulator
(`generate_data.py:5-81`) — re-expressed device-first:

  * The filter is one `lax.scan` over time whose per-step normalizer IS the
    likelihood term (the reference recomputes `P @ pi` twice; here it is
    computed once).
  * The 2^k x 2^k transition matrix is a k-fold Kronecker product of
    symmetric 2x2 factors (`calc_prob.py:91-101`). For large k the matvec
    is applied factor-by-factor in O(k 2^k) instead of O(4^k) — the
    "Kronecker scan" — while small k uses a dense matvec that batches
    well under vmap.
  * Everything jits and vmaps over assets, rolling windows, and parameter
    candidates (replacing the reference's ProcessPoolExecutor fan-out).

State indexing convention matches `itertools.product([m_0, 2-m_0],
repeat=k)`: component 0 is the most-significant bit, bit value 1 selects
`2 - m_0`.
"""

from __future__ import annotations

from typing import NamedTuple

import functools

import jax
import jax.numpy as jnp

from copula_var.ops.special import norm_cdf, norm_pdf

# Above this k the dense 2^k x 2^k matvec loses to the factored form.
_DENSE_K_MAX = 6


class MsmParams(NamedTuple):
    """m_0 in (0, 2), sigma > 0, b > 1, gamma in (0, 1)."""

    m_0: jax.Array
    sigma: jax.Array
    b: jax.Array
    gamma: jax.Array


def state_components(k: int, m_0) -> jax.Array:
    """(2^k, k) multiplier combinations, itertools.product order
    (`calc_prob.py:86-89`)."""
    idx = jnp.arange(2**k)
    bits = (idx[:, None] >> jnp.arange(k - 1, -1, -1)[None, :]) & 1
    m_0 = jnp.asarray(m_0)
    return jnp.where(bits == 1, 2.0 - m_0, m_0)


def component_stay_probs(k: int, b, gamma) -> jax.Array:
    """p_j = 1 - gamma_j / 2 with gamma_j = 1 - (1-gamma)^(b^j)
    (`calc_prob.py:93-95`). Shape (k,)."""
    j = jnp.arange(k)
    gamma_j = 1.0 - (1.0 - jnp.asarray(gamma)) ** (jnp.asarray(b) ** j)
    return 1.0 - gamma_j / 2.0


def transition_matrix(k: int, b, gamma) -> jax.Array:
    """Dense 2^k x 2^k transition matrix: the k-fold Kronecker product of
    [[p_j, q_j], [q_j, p_j]] (equivalent to the broadcast-product form at
    `calc_prob.py:97-101`; symmetric, so row/column convention is moot)."""
    p = component_stay_probs(k, b, gamma)
    mat = jnp.ones((1, 1), dtype=p.dtype)
    for j in range(k):
        f = jnp.array(
            [[p[j], 1.0 - p[j]], [1.0 - p[j], p[j]]], dtype=p.dtype
        )
        mat = jnp.kron(mat, f)
    return mat


def _kron_apply(factors_01, v):
    """Factored apply: per component j, contract axis j of the reshaped
    (2,)*k state with the symmetric 2x2 matrix [[a_j, b_j], [b_j, a_j]]
    (factors_01 rows are (a_j, b_j)). XLA fuses the per-factor ops
    without materializing the tiny-trailing-axis intermediates, so the
    FORWARD pass avoids the per-step relayouts of a strided-slice
    reformulation (`kron_transition_matvec_safe`)."""
    k = factors_01.shape[0]
    batch_shape = v.shape[:-1]
    t = v.reshape(batch_shape + (2,) * k)
    nb = len(batch_shape)
    for j in range(k):
        tj = jnp.moveaxis(t, nb + j, -1)
        t0, t1 = tj[..., 0], tj[..., 1]
        a = factors_01[j, 0]
        b = factors_01[j, 1]
        out = jnp.stack([a * t0 + b * t1, b * t0 + a * t1], axis=-1)
        t = jnp.moveaxis(out, -1, nb + j)
    return t.reshape(batch_shape + (2**k,))


def kron_transition_matvec(p_factors: jax.Array, v: jax.Array) -> jax.Array:
    """Apply the Kronecker-structured transition to v of shape (..., 2^k)
    in O(k 2^k): one symmetric 2x2 contraction per component.

    Memory note: REVERSE-mode autodiff through the (2,)*k reshapes
    materializes broadcast residuals with tiny trailing axes for every
    scan step — at k = 12 the scan-remat gradient ran out of device
    memory. The MSM optimizers therefore differentiate the likelihood in
    FORWARD mode
    (3 parameters -> 3 JVPs, zero residual storage;
    `ops/lbfgs.box_lbfgs_batch(fwd_grad=True)`); forward-mode tangents
    ride the same fused per-factor ops as the primal.
    """
    p = p_factors
    return _kron_apply(jnp.stack([p, 1.0 - p], axis=-1), v)


def kron_transition_matvec_safe(p_factors: jax.Array, v: jax.Array):
    """Layout-safe Kronecker apply: every intermediate stays flat
    (..., 2^k / 2^(k-1)) — each step contracts the CURRENT
    least-significant bit via even/odd strided slices, then rotates the
    bit order right by concatenating the halves (after k steps the
    order returns to the original). ~6x slower than the fused
    `kron_transition_matvec` on plain forward evals (stride-2 minor
    relayouts), but it is the only form whose DIFFERENTIATION compiles
    at large k: any grad/jvp of the (2,)*k form makes XLA materialize
    per-step broadcasts that pad 21x under (8, 128) tiling — 26.7 GB of
    planned HBM at k = 12 (used by `filter_states(safe_layout=True)`
    inside the polish loss)."""
    k = p_factors.shape[0]
    t = v
    for j in range(k - 1, -1, -1):
        t0 = t[..., 0::2]
        t1 = t[..., 1::2]
        p = p_factors[j]
        q = 1.0 - p
        t = jnp.concatenate([p * t0 + q * t1, q * t0 + p * t1], axis=-1)
    return t


def vol_states(k: int, m_0, sigma) -> jax.Array:
    """sigma_s = sigma * sqrt(prod of state multipliers)
    (`calc_prob.py:103-108`). Shape (2^k,)."""
    comps = state_components(k, m_0)
    return jnp.asarray(sigma) * jnp.sqrt(jnp.prod(comps, axis=1))


def conditional_probs(returns, vols) -> jax.Array:
    """Normal density of each return under each state vol, shape (N, 2^k)
    (`calc_prob.py:110-120`)."""
    returns = jnp.asarray(returns)
    return norm_pdf(returns[:, None], std=vols[None, :])


def _transition_apply(k: int, b, gamma, dense: bool, safe_layout=False):
    if dense:
        P = transition_matrix(k, b, gamma)
        return lambda v: v @ P  # symmetric: P @ v == v @ P
    p = component_stay_probs(k, b, gamma)
    mv = kron_transition_matvec_safe if safe_layout else \
        kron_transition_matvec
    return lambda v: mv(p, v)


@functools.partial(jax.jit, static_argnames=("k", "dense", "safe_layout"))
def filter_states(k: int, m_0, sigma, b, gamma, returns, *, dense=None,
                  safe_layout=False):
    """Hamilton filter (`calc_state_prob_numba`, `calc_prob.py:7-32`).

    Returns (state_probs (N, 2^k), cond_probs (N, 2^k), log_norms (N,),
    valid scalar bool). log_norms[i] = log( (P pi_{i-1}) . c_i ) with
    pi_{-1} uniform — the reference's likelihood terms (`calc_prob.py:35-47`)
    for i >= 1. `valid` is False iff any normalizer was <= 0, the scan
    analog of the reference's -1.0 sentinel array.
    """
    if dense is None:
        dense = k <= _DENSE_K_MAX
    nb_states = 2**k
    vols = vol_states(k, m_0, sigma)
    cond = conditional_probs(returns, vols)
    apply_P = _transition_apply(k, b, gamma, dense, safe_layout)

    init = jnp.full((nb_states,), 1.0 / nb_states, dtype=cond.dtype)

    def step(prev, c):
        trans = apply_P(prev)
        unnorm = trans * c
        norm = jnp.sum(unnorm)
        ok = norm > 0.0
        safe = jnp.where(ok, norm, 1.0)
        state = jnp.where(ok, unnorm / safe, prev)
        return state, (state, norm, ok)

    _, (states, norms, oks) = jax.lax.scan(step, init, cond)
    valid = jnp.all(oks)
    log_norms = jnp.where(norms > 0.0, jnp.log(jnp.maximum(norms, 1e-300)), -jnp.inf)
    return states, cond, log_norms, valid


@functools.partial(jax.jit, static_argnames=("k", "dense", "safe_layout"))
def log_likelihood(k: int, m_0, sigma, b, gamma, returns, *, dense=None,
                   safe_layout=False):
    """MSM log-likelihood: sum_{i=1}^{N-1} log((P pi_{i-1}) . c_i)
    (`calc_likelihood_numba`, `calc_prob.py:35-47`); -inf on any
    non-positive term or filter failure (`calc_prob.py:134-142`).
    safe_layout routes the Kronecker apply through the strided
    (differentiation-safe) form — required when this likelihood sits
    under grad/jvp at large k."""
    _, _, log_norms, valid = filter_states(
        k, m_0, sigma, b, gamma, returns, dense=dense,
        safe_layout=safe_layout,
    )
    ll = jnp.sum(log_norms[1:])
    return jnp.where(valid & jnp.isfinite(ll), ll, -jnp.inf)


def state_marginals(k: int, m_0, sigma, returns):
    """(cond_marginals (N, 2^k), eps (N, 2^k)): Phi(r_t / sigma_s) and the
    standardized returns matrix (`calc_state_marginals`,
    `calc_prob.py:122-132`)."""
    vols = vol_states(k, m_0, sigma)
    eps = jnp.asarray(returns)[:, None] / vols[None, :]
    return norm_cdf(eps), eps


@functools.partial(jax.jit, static_argnames=("k", "dense"))
def marginals(k: int, m_0, sigma, b, gamma, returns, *, dense=None):
    """Predictive marginals with the reference's alignment shift
    (`calc_marginals.py:7-18`): F_t = sum_s pi_{t}(s) Phi(r_{t-1}/sigma_s)
    via state_probs[1:] x cond_marginals[:-1]. Returns
    (marginals (N-1,), eps (N,), vol_states (2^k,))."""
    states, _, _, _ = filter_states(k, m_0, sigma, b, gamma, returns, dense=dense)
    cond_marg, eps_mat = state_marginals(k, m_0, sigma, returns)
    eps = jnp.sum(states * eps_mat, axis=1)
    marg = jnp.sum(states[1:, :] * cond_marg[:-1, :], axis=1)
    return marg, eps, vol_states(k, m_0, sigma)


@functools.partial(jax.jit, static_argnames=("k", "dense"))
def densities(k: int, m_0, sigma, b, gamma, returns, *, dense=None):
    """Predictive densities, same shift (`calc_marginals.py:21-30`).
    Shape (N-1,)."""
    states, cond, _, _ = filter_states(k, m_0, sigma, b, gamma, returns, dense=dense)
    return jnp.sum(states[1:, :] * cond[:-1, :], axis=1)


@functools.partial(jax.jit, static_argnames=("k", "dense"))
def forecast_state_distribution(k: int, m_0, sigma, b, gamma, returns, *, dense=None):
    """Last filtered state distribution pi_T (`calc_marginals.py:33-38`).
    Shape (2^k,)."""
    states, _, _, _ = filter_states(k, m_0, sigma, b, gamma, returns, dense=dense)
    return states[-1, :]


# ---------------------------------------------------------------------------
# Synthetic data (`generate_data.py:5-81`)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("k", "n"))
def simulate(key, k: int, m_0, sigma, b, gamma, n: int):
    """Simulate an MSM series. Returns (returns (n,), vol (n,), eps (n,),
    components (n+1, k)).

    Semantics of `generate_data.py:23-57`: components initialize uniformly
    over {m_0, 2-m_0}; each step, component j flips to a *fresh uniform
    draw-independent* value `2 - m` with prob gamma_j/2 (i.e. stays with
    prob 1 - gamma_j/2); vol_t = sigma * sqrt(prod comps_t) using rows 1..n;
    returns = vol * N(0,1).
    """
    j = jnp.arange(k)
    gamma_j = 1.0 - (1.0 - gamma) ** (b**j)
    k_init, k_flip, k_ret = jax.random.split(key, 3)
    init_bits = jax.random.bernoulli(k_init, 0.5, (k,))
    flips = jax.random.bernoulli(k_flip, gamma_j / 2.0, (n, k))

    def step(bits, flip):
        new_bits = jnp.where(flip, ~bits, bits)
        return new_bits, new_bits

    _, bits_path = jax.lax.scan(step, init_bits, flips)
    all_bits = jnp.concatenate([init_bits[None], bits_path], axis=0)
    comps = jnp.where(all_bits, 2.0 - m_0, m_0)
    vol = sigma * jnp.sqrt(jnp.prod(comps[1:], axis=1))
    eps = jax.random.normal(k_ret, (n,))
    return vol * eps, vol, eps, comps


# Batched conveniences -------------------------------------------------------

#: likelihood vmapped over a leading batch of (m_0, sigma, b, gamma).
log_likelihood_batch = jax.jit(
    jax.vmap(log_likelihood, in_axes=(None, 0, 0, 0, 0, None)),
    static_argnames=("k",),
)

#: forecast distribution vmapped over rolling windows (T, N).
forecast_windows = jax.jit(
    jax.vmap(
        forecast_state_distribution,
        in_axes=(None, None, None, None, None, 0),
    ),
    static_argnames=("k",),
)
