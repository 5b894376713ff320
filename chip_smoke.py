"""Bring-up check: the flagship VaR backtest end to end on one GPU.

Drives the main path through the public entry points at the flagship
configuration that `examples/flagship.py` pins (2 assets from
`data/flagship.csv`, N = 1135 in-sample and T = 500 out-of-sample days,
num_points = 100, Student-t copula, GARCH p, q <= 3 and MSM k = 4 with
basin_iter = 100 and seed 0, obj_var = 0.05) and checks it against the
committed CPU f64 record (`data/flagship_var.npz` and the fitted-parameter
artifacts beside it).

Phases (each prints its result on its own line):
  0  device check: the JAX platform must be 'gpu'; x64 on
  1  solve from the committed fits (engine 'xla') vs the record
  2  the whole pipeline, fits included, vs the record
  3  the fused Pallas solver (engine 'pallas') vs engine 'xla' in f64
  4  warm solve timings: 'xla' f64, 'xla' f32 and 'pallas' at L = 1
     and L = 128 (32 portfolios x 4 levels)

    python chip_smoke.py               # phases 0-4 on one card
    python chip_smoke.py --four-cards  # only the multi-device engines on
                                       # a 4-card mesh vs one-card 'xla'

The last line of stdout is one JSON object,
{"ok": ..., "device": {"platform", "kind", "count"}}. The script exits
non-zero, printing no result, when JAX finds no GPU, and exits non-zero
when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "data")
OBJ_VAR = 0.05
LEVELS = (0.01, 0.025, 0.05, 0.1)
N_PORTFOLIOS = 32
TIMED_RUNS = 5
# max |dVaR| vs the CPU f64 record: the solver's bisection tolerance for a
# solve from the committed fits (f64 sums on the GPU run in another order
# than on the CPU), and a bound that only a change of optimizer basin can
# break when the fits run again (newton_tol 1e-10, copula tol 1e-9)
SOLVE_TOL = 1e-6
PIPELINE_TOL = 1e-4
# sharded engines vs one-card 'xla' in f64
MESH_TOL = 1e-9
FAMILIES = ("garch", "msm")


def card_info():
    """`nvidia-smi` name and power limit of each card, from a child that
    stays off JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = [l.strip() for l in r.stdout.splitlines() if l.strip()]
    return "; ".join(lines) if lines else "nvidia-smi gave no card"


def device_info():
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def portfolio_rows(n=N_PORTFOLIOS):
    """n long-only 2-asset weight rows, (a, 1 - a) for a in [0.05, 0.95]."""
    a = np.linspace(0.05, 0.95, n)
    return np.column_stack([a, 1.0 - a])


def flagship_data():
    from copula_var.data.returns import from_csv

    return from_csv(os.path.join(DATA, "flagship.csv"), n_insample=1135)


def flagship_loader(data):
    """load(family) -> a solve-ready backtest from the committed fits."""
    from copula_var.utils.artifacts import load_artifacts

    def load(family):
        return load_artifacts(
            os.path.join(DATA, f"flagship_artifacts_{family}.npz"), data
        )

    return load


def _artifact_meta(family):
    z = np.load(os.path.join(DATA, f"flagship_artifacts_{family}.npz"))
    return json.loads(str(z["meta"]))


def _exceptions(data, var):
    return int(np.sum(data.portfolio_out_sample() < var))


def _record_exceptions(rec, family):
    return int(round(float(rec[f"{family}_exception_rate"])
                     * rec[f"{family}_var"].shape[0]))


def _max_diff(a, b):
    """max |a - b| over days where both are finite; inf when the NaN days
    differ."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        return float("inf")
    ok = ~np.isnan(a)
    return float(np.max(np.abs(a[ok] - b[ok]))) if ok.any() else 0.0


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _with_engine(bt, engine, interpret=False, mesh=None):
    bt.engine, bt.interpret, bt.mesh = engine, interpret, mesh
    return bt


def phase_committed_fits(load, data, rec, tol=SOLVE_TOL):
    """Phase 1: `calc_var(0.05)` on engine 'xla' from the committed fits."""
    import jax

    for fam in FAMILIES:
        bt = load(fam)
        t0 = time.perf_counter()
        var = bt.calc_var(float(rec["obj_var"]))
        secs = time.perf_counter() - t0
        tensors = bt.adapter.day_tensors(bt.integration_inputs,
                                         bt.copula_spec)
        diff = _max_diff(var, rec[f"{fam}_var"])
        exc, want = _exceptions(data, var), _record_exceptions(rec, fam)
        print(f"[phase 1] {fam}: max|dVaR| {diff!r} (limit {tol}), "
              f"exceptions {exc} (record {want}), day tensors "
              f"{tensors.dtype} on {jax.devices()[0].platform}, first solve "
              f"{secs!r} s", flush=True)
        _check(diff <= tol, f"{fam}: max|dVaR| {diff} > {tol}")
        _check(exc == want, f"{fam}: {exc} exceptions, record {want}")


def phase_pipeline(data, rec, tol=PIPELINE_TOL):
    """Phase 2: `create_var_backtest` with the fits, at the flagship
    arguments, vs the record."""
    from copula_var.backtest import create_var_backtest

    for fam in FAMILIES:
        kw = dict(k=4, basin_iter=100, seed=0) if fam == "msm" else {}
        bt = create_var_backtest(data, fam, "student", num_points=100,
                                 engine="xla", **kw)
        t0 = time.perf_counter()
        var = bt.calc_var(float(rec["obj_var"]))
        solve_s = time.perf_counter() - t0
        st = bt.stage_seconds
        diff = _max_diff(var, rec[f"{fam}_var"])
        exc, want = _exceptions(data, var), _record_exceptions(rec, fam)
        meta = _artifact_meta(fam)
        line = (f"[phase 2] {fam}: max|dVaR| {diff!r} (limit {tol}), "
                f"exceptions {exc} (record {want}); wall s: fit "
                f"{st['fit']!r}, copula fit {st['copula_fit']!r}, prep "
                f"{st['prep']!r}, solve {solve_s!r}")
        if fam == "garch":
            pq = [(f.p, f.q) for f in bt.model_fits]
            pq_rec = [(f["p"], f["q"]) for f in meta["model_fits"]]
            line += f"; (p, q) {pq} (record {pq_rec})"
        print(line, flush=True)
        if diff > tol:
            _report_moved_fits(bt, meta)
        if fam == "garch":
            _check(pq == pq_rec, f"garch (p, q) {pq}, record {pq_rec}")
        _check(exc == want, f"{fam}: {exc} exceptions, record {want}")
        _check(diff <= tol, f"{fam}: max|dVaR| {diff} > {tol}")


def _report_moved_fits(bt, meta):
    """Name the fit that moved when the pipeline leaves the record."""
    for i, (f, f_rec) in enumerate(zip(bt.model_fits, meta["model_fits"])):
        for k, v in f._asdict().items():
            r = np.asarray(f_rec[k], np.float64)
            v = np.asarray(v, np.float64)
            if v.shape != r.shape or np.max(np.abs(v - r)) > 1e-6:
                print(f"[phase 2]   asset {i} model fit moved: {k} {v} "
                      f"(record {r})", flush=True)
    for k, v in bt.copula_fit._asdict().items():
        r = np.asarray(meta["copula_fit"][k], np.float64)
        if np.max(np.abs(np.asarray(v, np.float64) - r)) > 1e-6:
            print(f"[phase 2]   copula fit moved: {k} {v} (record {r})",
                  flush=True)


def phase_fused(load, interpret=False, n_portfolios=N_PORTFOLIOS,
                levels=LEVELS):
    """Phase 3: engine 'pallas' vs engine 'xla' (f64) within the plateau
    bound, at L = 1, L = len(levels) and n_portfolios weight rows."""
    from copula_var.ops.pallas_solver import root_plateau_bound

    W = portfolio_rows(n_portfolios)
    for fam in FAMILIES:
        bt_x = load(fam)
        bt_p = _with_engine(load(fam), "pallas", interpret)
        dx = np.asarray(bt_x.integration_inputs.dx)
        w = bt_x.data.weights
        bound = root_plateau_bound(dx, w)
        d1 = _max_diff(bt_p.calc_var(OBJ_VAR), bt_x.calc_var(OBJ_VAR))
        dl = _max_diff(bt_p.calc_var_levels(levels),
                       bt_x.calc_var_levels(levels))
        got = bt_p.calc_var_portfolios(W, OBJ_VAR)
        want = bt_x.calc_var_portfolios(W, OBJ_VAR)
        rows = [(_max_diff(g, v), root_plateau_bound(dx, wr))
                for g, v, wr in zip(got, want, W)]
        dp = max(d for d, _ in rows)
        print(f"[phase 3] {fam}: pallas vs xla f64 max|dVaR| L=1 {d1!r}, "
              f"L={len(levels)} {dl!r} (plateau bound {bound!r}); "
              f"{n_portfolios} portfolios {dp!r} (per-row bounds "
              f"{min(b for _, b in rows)!r}..{max(b for _, b in rows)!r})",
              flush=True)
        _check(d1 <= bound and dl <= bound, f"{fam}: beyond plateau bound")
        _check(all(d <= b for d, b in rows), f"{fam}: portfolio row beyond "
               "its plateau bound")


def _time(fn, runs=TIMED_RUNS):
    """(first-call seconds incl. compile, median warm seconds, all warm
    seconds). Every solve API returns host numpy, so each call has waited
    for the device before the clock stops."""
    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    warm = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        warm.append(time.perf_counter() - t0)
    return first, float(np.median(warm)), warm


def phase_timings(load, interpret=False, n_portfolios=N_PORTFOLIOS,
                  levels=LEVELS, runs=TIMED_RUNS, card=""):
    """Phase 4: warm solve times (median of `runs`), compilation apart,
    of engine 'xla' in f64, 'xla' on f32 inputs and 'pallas', at L = 1
    and L = n_portfolios x len(levels)."""
    import jax

    W = portfolio_rows(n_portfolios)
    L = n_portfolios * len(levels)
    for fam in FAMILIES:
        configs = (
            ("xla f64", lambda: load(fam), True),
            ("xla f32", lambda: load(fam), False),
            ("pallas", lambda: _with_engine(load(fam), "pallas", interpret),
             True),
        )
        for name, build, x64 in configs:
            with jax.enable_x64(x64):
                bt = build()
                for lbl, fn in (
                    ("L=1", lambda: bt.calc_var(OBJ_VAR)),
                    (f"L={L}", lambda: bt.calc_var_grid(W, levels)),
                ):
                    first, med, warm = _time(fn, runs)
                    print(f"[phase 4] {fam} {name} {lbl}: warm median "
                          f"{med * 1e3!r} ms over {runs} runs (all ms "
                          f"{[t * 1e3 for t in warm]!r}); first call incl. "
                          f"compile {first!r} s; card {card}", flush=True)


def phase_four_cards(load, n_devices=4, interpret=False, levels=LEVELS):
    """The multi-device engines on an n_devices mesh vs the one-card
    'xla' solve: 'sharded' and 'grid_sharded' within MESH_TOL (f64),
    'sharded_pallas' within the plateau bound."""
    from copula_var.ops.pallas_solver import root_plateau_bound
    from copula_var.parallel import make_mesh

    days = make_mesh(n_devices=n_devices)
    grid = make_mesh(n_devices=n_devices, axis_names=("days", "grid"),
                     shape=(1, n_devices))
    for fam in FAMILIES:
        bt_x = load(fam)
        want, want_l = bt_x.calc_var(OBJ_VAR), bt_x.calc_var_levels(levels)
        bound = root_plateau_bound(bt_x.integration_inputs.dx,
                                   bt_x.data.weights)
        for engine, mesh, tol in (("sharded", days, MESH_TOL),
                                  ("grid_sharded", grid, MESH_TOL),
                                  ("sharded_pallas", days, bound)):
            bt = _with_engine(load(fam), engine, interpret, mesh)
            t0 = time.perf_counter()
            d1 = _max_diff(bt.calc_var(OBJ_VAR), want)
            first = time.perf_counter() - t0
            dl = _max_diff(bt.calc_var_levels(levels), want_l)
            print(f"[four cards] {fam} {engine} on {mesh.devices.size} "
                  f"devices {dict(mesh.shape)}: max|dVaR| vs one-card xla "
                  f"L=1 {d1!r}, L={len(levels)} {dl!r} (limit {tol!r}); "
                  f"first solve {first!r} s", flush=True)
            _check(d1 <= tol and dl <= tol, f"{fam} {engine}: beyond {tol}")


def run(phases):
    """Run (name, fn) phases in order; a failing phase is reported and
    the rest still run. Returns {name: passed}."""
    passed = {}
    for name, fn in phases:
        try:
            fn()
            passed[name] = True
        except Exception:  # report every phase, fail at the end
            traceback.print_exc()
            print(f"[{name}] FAILED", flush=True)
            passed[name] = False
    return passed


def select_phases(four_cards, data, load, rec=None, card="",
                  interpret=False, n_devices=4):
    """(name, fn) phases: the one-card phases 1-4, or with four_cards only
    the multi-device engines and the one-card solve they are compared
    with."""
    if four_cards:
        return [("four_cards",
                 lambda: phase_four_cards(load, n_devices, interpret))]
    return [
        ("committed_fits", lambda: phase_committed_fits(load, data, rec)),
        ("pipeline", lambda: phase_pipeline(data, rec)),
        ("fused", lambda: phase_fused(load, interpret)),
        ("timings", lambda: phase_timings(load, interpret, card=card)),
    ]


def main(argv=None, only=None):
    """`only`: names of the one-card phases to run (default: all)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device engines on a 4-card "
                         "mesh, against the one-card 'xla' solve")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax

    # the 'xla' engine's parity contract is f64 (as in tests/conftest.py)
    jax.config.update("jax_enable_x64", True)
    from copula_var.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    info = device_info()
    card = card_info()
    print(f"[phase 0] devices {jax.devices()}; platform {info['platform']}, "
          f"kind {info['kind']}, count {info['count']}, jax "
          f"{jax.__version__}, default float "
          f"{jax.numpy.zeros(()).dtype}", flush=True)
    print(f"[phase 0] card (nvidia-smi name, power.limit): {card}",
          flush=True)
    if info["platform"] != "gpu":
        print(f"no GPU: JAX platform is {info['platform']!r}",
              file=sys.stderr)
        return 2

    data = flagship_data()
    rec = np.load(os.path.join(DATA, "flagship_var.npz"))
    phases = select_phases(args.four_cards, data, flagship_loader(data), rec,
                           card)
    passed = run([p for p in phases if only is None or p[0] in only])
    ok = all(passed.values())
    print(f"phases: {passed}", flush=True)
    print(json.dumps({"ok": ok, "device": info}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
