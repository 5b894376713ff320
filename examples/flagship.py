"""The pinned flagship run: the reference's `main.py` configuration
end-to-end on the checked-in dataset, with recorded results.

Reproduces `/root/reference/main.py:23-75` on `data/flagship.csv`
(see `make_flagship_data.py` for why the dataset is a pinned synthetic
stand-in for the ^GSPC/^IXIC window): two backtests over the same
2-asset data — Student copula + GARCH(BIC p,q<=3) and Student copula +
MSM k=4 — N = 1135 in-sample, num_points = 100, obj_var = 0.05, plus
the comparison plot and Kupiec/Christoffersen coverage statistics the
reference eyeballs from its plot.

Forces CPU + f64 (platform-stable, reproducible bit-for-bit on one
machine) and writes:
  * data/flagship_var.npz       — both (T,) VaR series + config + stats
  * data/flagship_artifacts_{garch,msm}.npz — fitted params (resume)
  * data/flagship.png           — the `main.py:75` comparison plot

`tests/test_flagship.py` re-runs the solve from the committed artifacts
and asserts the committed VaR series reproduces at 1e-9.
"""

import hashlib
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402


def series_hash(arr):
    """Stable hash of a float series: sha256 of the f64 bytes."""
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(arr, np.float64)).tobytes()
    ).hexdigest()[:16]


def main():
    from copula_var import data as data_mod
    from copula_var import stats
    from copula_var.backtest import create_var_backtest
    from copula_var.utils.artifacts import save_artifacts
    from copula_var.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    csv = os.path.join(root, "data", "flagship.csv")
    data = data_mod.from_csv(csv, n_insample=1135)
    print(f"data: {data.dim} assets, N={data.n_insample}, "
          f"T={data.out_sample_n}")
    assert data.out_sample_n == 500

    obj_var = 0.05
    results, meta = {}, {}
    for est in ("garch", "msm"):
        kw = dict(k=4, basin_iter=100, seed=0) if est == "msm" else {}
        t0 = time.time()
        bt = create_var_backtest(
            data, est, "student", num_points=100, engine="xla", **kw
        )
        var = bt.calc_var(obj_var)
        wall = time.time() - t0
        results[est] = var
        save_artifacts(
            os.path.join(root, "data", f"flagship_artifacts_{est}.npz"), bt
        )
        ptf = data.portfolio_out_sample()
        kup = stats.kupiec_pof(ptf, var, obj_var)
        chr_ = stats.christoffersen_conditional_coverage(ptf, var, obj_var)
        meta[est] = dict(
            wall_s=round(wall, 1),
            prep_s=round(bt.prep_seconds, 1),
            solve_s=round(bt.solve_seconds, 2),
            exception_rate=float(stats.exception_rate(ptf, var)),
            kupiec_stat=float(kup.statistic), kupiec_p=float(kup.p_value),
            cc_stat=float(chr_.statistic), cc_p=float(chr_.p_value),
            var_hash=series_hash(var),
        )
        print(f"{est}: wall {wall:.1f}s  exc {meta[est]['exception_rate']:.3f}"
              f"  kupiec p={meta[est]['kupiec_p']:.3f}"
              f"  cc p={meta[est]['cc_p']:.3f}  hash {meta[est]['var_hash']}")

    np.savez(
        os.path.join(root, "data", "flagship_var.npz"),
        garch_var=results["garch"], msm_var=results["msm"],
        obj_var=obj_var, n_insample=1135, num_points=100, k=4,
        **{f"{e}_{k}": v for e, m in meta.items() for k, v in m.items()},
    )

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ptf = data.portfolio_out_sample()
    x = np.arange(len(ptf))
    plt.figure(figsize=(10, 6))
    plt.plot(x, results["msm"], label="MSM VaR", alpha=0.8)
    plt.plot(x, results["garch"], label="GARCH VaR", linestyle="--",
             alpha=0.8)
    plt.plot(x, ptf, label="Portfolio Returns", linestyle=":", alpha=0.6)
    plt.title("VaR and Portfolio Returns Over Time (flagship)")
    plt.xlabel("Time")
    plt.ylabel("Value")
    plt.legend()
    plt.grid(True)
    plt.savefig(os.path.join(root, "data", "flagship.png"), dpi=120)
    print("saved data/flagship_var.npz + flagship.png + artifacts")


if __name__ == "__main__":
    main()
