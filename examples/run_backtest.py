"""End-to-end example: the reference `main.py` pipeline on the device.

Runs two out-of-sample VaR backtests over the same 2-asset dataset —
Student copula + GARCH and Student copula + MSM — and plots both VaR
series against realized portfolio returns (`main.py:23-75`).

Data: the reference downloads ^GSPC/^IXIC via yfinance (network). Offline
(the default here), a seeded 2-asset synthetic dataset stands in; pass
--tickers to use yfinance when available, or --csv for a local price file.
"""

import argparse
import os
import sys

# runnable as `python examples/run_backtest.py` without installing the
# package: python puts examples/ (not the repo root) on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tickers", nargs="+", default=None,
                    help="yfinance tickers (requires network + yfinance)")
    ap.add_argument("--csv", default=None, help="CSV of adjusted closes")
    ap.add_argument("--start", default="2009-04-15")
    ap.add_argument("--end", default="2015-10-12")
    ap.add_argument("--n-insample", type=int, default=1135)
    ap.add_argument("--num-points", type=int, default=100)
    ap.add_argument("--k", type=int, default=4, help="MSM components")
    ap.add_argument("--obj-var", type=float, default=0.05)
    ap.add_argument("--synthetic-days", type=int, default=1635)
    ap.add_argument("--plot", default=None, help="output PNG path")
    ap.add_argument("--quick", action="store_true",
                    help="tiny problem + cheap optimizers (smoke run)")
    ap.add_argument("--engine", default="xla",
                    choices=("xla", "pallas", "sharded", "sharded_pallas",
                             "grid_sharded"),
                    help="solver engine: xla (f64 parity), pallas (fused "
                         "f32 kernels, ONE dispatch per solve), sharded / "
                         "sharded_pallas (day-sharded over the device "
                         "mesh), grid_sharded (grid rows sharded, psum "
                         "across the mesh)")
    args = ap.parse_args()

    import jax

    # the 'xla' engine's parity contract is f64; JAX defaults to f32
    jax.config.update("jax_enable_x64", True)
    from copula_var import data as data_mod
    from copula_var.config import BacktestConfig, run_backtest

    if args.tickers:
        data = data_mod.from_yfinance(
            args.tickers, args.start, args.n_insample, end_date=args.end
        )
    elif args.csv:
        data = data_mod.from_csv(args.csv, args.n_insample)
    else:
        n_total = 260 if args.quick else args.synthetic_days
        n_in = 220 if args.quick else args.n_insample
        data = data_mod.synthetic_dataset(
            jax.random.PRNGKey(0), n_total, n_in, spec=("garch", "msm")
        )
    print(f"data: {data.dim} assets, N={data.n_insample} in-sample, "
          f"T={data.out_sample_n} out-of-sample")

    results = {}
    for est in ("garch", "msm"):
        cfg = BacktestConfig(
            estimation_type=est,
            copula_type="student",
            n_insample=data.n_insample,
            num_points=24 if args.quick else args.num_points,
            engine=args.engine,
        )
        cfg.solver.obj_var = args.obj_var
        cfg.msm.k = 2 if args.quick else args.k
        if args.quick:
            cfg.msm.basin_iter = 10
            cfg.garch.p_max = cfg.garch.q_max = 1
            cfg.garch.newton_max_iter = 40
        bt, var = run_backtest(data, cfg)
        results[est] = var
        print(f"{est}: prep {bt.prep_seconds:.1f}s solve {bt.solve_seconds:.1f}s "
              f"VaR mean {var.mean():.3f}")

    ptf = data.portfolio_out_sample()
    for est, var in results.items():
        exc = float(np.mean(ptf < var))
        print(f"{est} exceptions at {args.obj_var:.0%}: {exc:.3f}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        x = np.arange(len(ptf))
        plt.figure(figsize=(10, 6))
        plt.plot(x, results["msm"], label="MSM VaR", alpha=0.8)
        plt.plot(x, results["garch"], label="GARCH VaR", linestyle="--", alpha=0.8)
        plt.plot(x, ptf, label="Portfolio Returns", linestyle=":", alpha=0.8)
        plt.title("VaR and Portfolio Returns Over Time")
        plt.xlabel("Time")
        plt.ylabel("Value")
        plt.legend()
        plt.grid(True)
        plt.savefig(args.plot, dpi=120)
        print("plot saved to", args.plot)


if __name__ == "__main__":
    main()
