"""End-to-end VaR-solve benchmark (BASELINE.md protocol item 2).

Measures the full 3-stage VaR solve (`VaRBacktest.calc_var`: bracketing +
on-device bisection, ~24 quadrature sweeps over T days) at the reference
problem size — 2 assets, T out-of-sample days, num_points grid — for both
engines, plus the one-time prep (model fit, IFM, integration inputs).

Usage: python benchmarks/var_solve.py [--days 500] [--points 100]
                                      [--engine xla|pallas|both]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=int, default=500)
    ap.add_argument("--points", type=int, default=100)
    ap.add_argument("--insample", type=int, default=1135,
                    help="in-sample days (the fit stage; the solve-stage "
                         "rate is insensitive to this)")
    ap.add_argument("--copula", default="student")
    ap.add_argument("--engine", default="both")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax

    from copula_var.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()

    from copula_var.backtest import create_var_backtest
    from copula_var.data import synthetic_dataset

    total = args.insample + args.days
    data = synthetic_dataset(
        jax.random.PRNGKey(0), total, args.insample, spec=("garch", "garch")
    )
    # engine='pallas' compiles its kernel for the GPU and refuses any
    # other backend
    engines = ["xla", "pallas"] if args.engine == "both" else [args.engine]

    for engine in engines:
        bt = create_var_backtest(
            data, "garch", args.copula, num_points=args.points,
            engine=engine, p_max=1, q_max=1,
        )
        # warm-up solve compiles the bracketing sweeps + bisection loop
        var = bt.calc_var(obj_var=0.05)
        assert np.all(np.isfinite(var))
        times = []
        for _ in range(args.reps):
            t0 = time.time()
            bt.calc_var(obj_var=0.05)
            times.append(time.time() - t0)
        dt = min(times)
        print(
            f"engine={engine:7s} prep={bt.prep_seconds:6.1f}s  "
            f"solve={dt * 1e3:8.1f} ms  -> {1.0 / dt:7.2f} VaR solves/s "
            f"({args.days} days, {args.points} pts, {args.copula})"
        )


if __name__ == "__main__":
    main()
