"""`chip_smoke.py`: its CPU rehearsal and its GPU phases.

The CPU tests call the phase functions directly at tiny sizes, with the
Pallas kernel in interpret mode; `main` itself refuses the CPU. The `gpu`
tests run one phase each in a child process on the card (this process is
pinned to the CPU) and skip without one:

    python -m pytest -o addopts="" -m gpu tests/test_chip_smoke.py
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from copula_var.backtest import GarchAdapter, MsmAdapter, VaRBacktest
from copula_var.copulas.fit import StudentFit
from copula_var.data.returns import from_csv, from_returns
from copula_var.models.fit import GarchFit, MsmFit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORR = np.array([[1.0, 0.45], [0.45, 1.0]])
LEVELS = (0.01, 0.05)


def _tiny_loader(n_in=60, T=13, n=24):
    """load(family) -> a small backtest with pinned fits, the stand-in for
    the flagship artifacts (num_points 24 divides a 4-device grid axis)."""
    rets = np.random.default_rng(3).multivariate_normal(
        np.zeros(2), CORR, size=n_in + T)
    data = from_returns(rets, ["A", "B"], n_in, np.array([0.5, 0.5]))
    cfit = StudentFit(6.0, CORR, 0.0, np.array([6.0, 0.45]))

    def load(family):
        if family == "garch":
            adapter = GarchAdapter()
            fits = [GarchFit(1, 1, 0.05, np.array([0.08]), np.array([0.88]),
                             0.0, 0.0, np.array([0.05, 0.08, 0.88]))] * 2
        else:
            adapter = MsmAdapter(k=2)
            fits = [
                MsmFit(m_0=0.45, b=3.0, gamma=0.5, sigma=1.0,
                       log_likelihood=0.0),
                MsmFit(m_0=0.55, b=5.0, gamma=0.3, sigma=1.15,
                       log_likelihood=0.0),
            ]
        return VaRBacktest(data, adapter, "student", num_points=n,
                           model_fits_override=fits,
                           copula_fit_override=cfit)

    return data, load


def test_main_refuses_cpu(capsys):
    """Phase 0: on a CPU backend main exits non-zero and prints no
    result line."""
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr().out
    assert "[phase 0]" in out and '"ok"' not in out


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_four_cards_selects_only_mesh_phase():
    """--four-cards runs the multi-device engines and the one-card solve
    they are compared with, and no other phase: here on 4 of the 8
    virtual CPU devices, sharded / grid_sharded within 1e-9 and
    sharded_pallas within the plateau bound of one-card xla."""
    data, load = _tiny_loader()
    one_card = chip_smoke.select_phases(False, data, load)
    assert [n for n, _ in one_card] == [
        "committed_fits", "pipeline", "fused", "timings"]
    phases = chip_smoke.select_phases(True, data, load, interpret=True)
    assert [n for n, _ in phases] == ["four_cards"]
    assert chip_smoke.run(phases) == {"four_cards": True}


def test_fused_phase_rehearsal(capsys):
    """Phase 3 at a tiny size: pallas vs xla f64 at L = 1, L = 2 and 4
    portfolio rows, each within its plateau bound."""
    _, load = _tiny_loader()
    chip_smoke.phase_fused(load, interpret=True, n_portfolios=4,
                           levels=LEVELS)
    assert capsys.readouterr().out.count("[phase 3]") == 2


def test_timings_phase_rehearsal(capsys):
    """Phase 4 at a tiny size: one line per family x engine x L."""
    _, load = _tiny_loader()
    chip_smoke.phase_timings(load, interpret=True, n_portfolios=2,
                             levels=LEVELS, runs=1, card="cpu")
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[phase 4]")]
    assert len(lines) == 12
    assert sum("L=4:" in l for l in lines) == 6


@pytest.mark.parametrize("shift,passes", [(0.0, True), (2e-6, False)])
def test_committed_fits_phase_tolerance(shift, passes):
    """Phase 1 holds the solve to the record within 1e-6: a series moved
    by more fails the phase."""
    data, load = _tiny_loader()
    ptf = data.portfolio_out_sample()
    rec = {"obj_var": 0.05}
    for fam in chip_smoke.FAMILIES:
        var = load(fam).calc_var(0.05)
        rec[f"{fam}_var"] = var + shift
        rec[f"{fam}_exception_rate"] = float(np.mean(ptf < var))
    if passes:
        chip_smoke.phase_committed_fits(load, data, rec)
    else:
        with pytest.raises(AssertionError, match="max"):
            chip_smoke.phase_committed_fits(load, data, rec)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir_rule(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins when set and no other directory is
    set in code; otherwise the cache lives at the fixed <repo>/.jax_cache."""
    import jax

    from copula_var.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable_persistent_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(ROOT, ".jax_cache")
        assert compile_cache.enable_persistent_cache() == want
        assert jax.config.jax_compilation_cache_dir == want


def test_from_csv_without_pandas(monkeypatch):
    """The flagship data loads with pandas unavailable, and the parsed
    prices are bit-identical to a plain float parse of the file."""
    monkeypatch.setitem(sys.modules, "pandas", None)
    data = from_csv(os.path.join(ROOT, "data", "flagship.csv"),
                    n_insample=1135)
    raw = np.genfromtxt(os.path.join(ROOT, "data", "flagship.csv"),
                        delimiter=",", skip_header=1, usecols=(1, 2))
    np.testing.assert_array_equal(
        data.returns, np.log(raw[1:] / raw[:-1]) * 100.0)
    assert data.tickers == ["GSPC_SYN", "IXIC_SYN"]
    assert data.dates[0] == "2009-04-16" and data.out_sample_n == 500


def test_from_csv_drops_rows_with_missing_prices(tmp_path):
    p = tmp_path / "px.csv"
    p.write_text("day,A,B\nd0,1.0,2.0\nd1,,2.5\nd2,1.5,3.0\nd3,1.2,nan\n"
                 "d4,1.8,2.7\n")
    data = from_csv(str(p), n_insample=1)
    assert list(data.dates) == ["d2", "d4"]
    np.testing.assert_array_equal(
        data.returns,
        np.log(np.array([[1.5, 3.0], [1.8, 2.7]])
               / np.array([[1.0, 2.0], [1.5, 3.0]])) * 100.0)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "phase", [None, "committed_fits", "pipeline", "fused", "timings"],
    ids=["0_device", "1_committed_fits", "2_pipeline", "3_fused",
         "4_timings"],
)
def test_phase_on_gpu(gpu_env, phase):
    """chip_smoke phase 0 (device check alone) or one of phases 1-4, in a
    child process on the card: exits 0 with the contract's last line."""
    only = [] if phase is None else [phase]
    code = ("import sys, chip_smoke; "
            f"sys.exit(chip_smoke.main([], only={only!r}))")
    r = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT, env=gpu_env, capture_output=True, text=True, timeout=1200,
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
