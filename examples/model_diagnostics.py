"""Model diagnostics: the reference's manual `__main__` checks as one
offline script (`markov_switching_multifractal/test.py` + `plots.py`,
`garch/test.py`, `calc_marginals.py:41-83`).

Simulates each model family with known parameters, refits, evaluates
held-out likelihood, and writes diagnostic PNGs.
"""

import argparse
import os
import sys

# runnable as `python examples/model_diagnostics.py` without installing
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="/tmp/copula_var_diag")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--holdout", type=int, default=500,
                    help="held-out tail length for likelihood evaluation")
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)

    import jax

    from copula_var import plots
    from copula_var.models import fit as mfit
    from copula_var.models import garch, msm, ukf

    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)

    # --- MSM: simulate -> fit -> held-out LL -> state-prob stackplot ----
    k_comp, m0, sigma, b, gamma = 4, 0.3, 1.0, 18.0, 0.5
    ret, vol, eps, comps = msm.simulate(k1, k_comp, m0, sigma, b, gamma, args.n)
    r = np.asarray(ret)
    fit = mfit.fit_msm(r[: -args.holdout], k_comp, basin_iter=40)
    ll_hold = float(
        msm.log_likelihood(k_comp, fit.m_0, fit.sigma, fit.b, fit.gamma,
                           r[-args.holdout :])
    )
    ll_true = float(
        msm.log_likelihood(k_comp, m0, sigma, b, gamma, r[-args.holdout :])
    )
    print(f"MSM fit: m0={fit.m_0:.3f} b={fit.b:.1f} gamma={fit.gamma:.3f} "
          f"sigma={fit.sigma:.3f}")
    print(f"MSM held-out LL: fitted {ll_hold:.1f} vs true-params {ll_true:.1f}")
    states, _, _, _ = msm.filter_states(
        k_comp, fit.m_0, fit.sigma, fit.b, fit.gamma, r[:400]
    )
    fig = plots.msm_state_probabilities(np.asarray(states))
    fig.savefig(os.path.join(args.outdir, "msm_states.png"), dpi=110)

    marg, eps_f, _ = msm.marginals(k_comp, fit.m_0, fit.sigma, fit.b, fit.gamma, r[:400])
    fig = plots.marginals_and_innovations(
        np.asarray(marg), np.asarray(eps_f), np.asarray(eps)[:400]
    )
    fig.savefig(os.path.join(args.outdir, "msm_marginals.png"), dpi=110)

    # --- GARCH: simulate -> BIC fit -> residual plot --------------------
    y, s2, _ = garch.simulate(k2, 0.02, [0.08], [0.9], args.n)
    gfit = mfit.fit_garch(np.asarray(y), p_max=2, q_max=2, max_iter=100)
    print(f"GARCH BIC pick: (p,q)=({gfit.p},{gfit.q}) omega={gfit.omega:.4f} "
          f"alpha={np.round(gfit.alpha,3)} beta={np.round(gfit.beta,3)}")
    eps_g = garch.standardized_residuals(y, gfit.omega, gfit.alpha, gfit.beta)
    fig = plots.residual_series(np.asarray(eps_g), "GARCH standardized residuals")
    fig.savefig(os.path.join(args.outdir, "garch_residuals.png"), dpi=110)

    # --- UKF: simulate -> EM fit -> vol-path overlay --------------------
    X, vol_u, r_u = ukf.simulate(k3, 0.95, 0.0, 0.2, args.n)
    ufit = mfit.fit_ukf_em(np.asarray(r_u), max_iter=60)
    print(f"UKF EM fit: a={ufit.a:.3f} l={ufit.l:.3f} q={ufit.q:.3f}")
    vols = ukf.vol_path(r_u, ufit.a, ufit.l, ufit.q)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(np.asarray(vol_u)[:500], label="true vol")
    ax.plot(np.asarray(vols)[:500], label="UKF estimate", linestyle="--")
    ax.legend()
    ax.set_title("UKF stochastic-volatility tracking")
    fig.savefig(os.path.join(args.outdir, "ukf_vol.png"), dpi=110)

    print("diagnostics written to", args.outdir)


if __name__ == "__main__":
    main()
