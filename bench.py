"""Benchmark: warm VaR solves of the flagship backtest on one GPU.

Problem size (BASELINE.md §3, from the reference's `main.py:25-69`): the
flagship configuration `examples/flagship.py` pins — 2 assets, T = 500
out-of-sample days, num_points = 100 (10^4 grid points per day), MSM
k = 4 (q = 5 unique vol levels, 25 state combinations), Student-t copula
— solved from the committed fitted-parameter artifacts. Each "integral"
is one day's joint-density quadrature over the masked tensor-product
grid; one VaR solve evaluates 2 bracketing sweeps plus ~23 bisection
sweeps over all T days (`calc_var_class.py:111-169,278-309`).

Measured path: the production solve through the public API on the fused
Pallas engine (`engine='pallas'`, `ops/pallas_solver.py`): `calc_var`
(one level) and `calc_var_grid` over 32 portfolios x 4 levels (128 solves
in one dispatch). Every solve API returns host numpy, so each timed call
has waited for the device. The benchmark's cells and metrics are defined
in BENCHMARK.json once it exists; this script is the one-card probe.

vs_baseline: the reference's `calculate_result_for_i`
(`utils/calc_integral/calc_integral.py:122-171`) measured on a CPU at
5.42 integrals/s single-core (pure-Python mode; numba is not in that
image — its `@njit` kernels are not the bottleneck, the elementwise scipy
`t.ppf` loop is). Scaled x32 for a full joblib node (`n_jobs=-1`,
`calc_integral.py:211`) -> 173 int/s, a deliberately generous baseline.

Prints the device lines, then ONE JSON line; exits non-zero with no GPU.
"""

import json
import os
import sys

REF_NODE_INTEGRALS_PER_SEC = 5.42 * 32  # see docstring
RUNS = 5


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    jax.config.update("jax_enable_x64", True)
    import chip_smoke
    from copula_var.ops.pallas_solver import _full_iters
    from copula_var.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    info = chip_smoke.device_info()
    card = chip_smoke.card_info()
    print(f"device: {info}; card: {card}", flush=True)
    if info["platform"] != "gpu":
        print("bench.py measures the GPU; JAX found "
              f"{info['platform']!r}", file=sys.stderr)
        return 2

    bt = chip_smoke.flagship_loader(chip_smoke.flagship_data())("msm")
    bt.engine = "pallas"
    T = bt.data.out_sample_n
    sweeps = 2 + _full_iters(1e-6, -7.5, 0.0)  # calc_var defaults
    W = chip_smoke.portfolio_rows()
    levels = chip_smoke.LEVELS
    L = len(W) * len(levels)
    first1, t1, _ = chip_smoke._time(lambda: bt.calc_var(0.05), RUNS)
    first128, t128, _ = chip_smoke._time(
        lambda: bt.calc_var_grid(W, levels), RUNS)
    rate = T * sweeps / t1
    print(json.dumps({
        "metric": "msm_student_grid_integrals_per_sec",
        "value": rate,
        "unit": "integrals/s/device",
        "vs_baseline": rate / REF_NODE_INTEGRALS_PER_SEC,
        "path": "pallas_fused_solver",
        "solve_ms_L1": t1 * 1e3,
        "solve_ms_L128": t128 * 1e3,
        "value_L128": T * sweeps * L / t128,
        "first_call_s": [first1, first128],
        "runs": RUNS,
        "device": info,
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
