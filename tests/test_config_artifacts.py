"""Config round-trips, config-driven runs, artifact save/load resume, and
the profiling hooks."""

import numpy as np
import pytest

import jax

from copula_var.config import BacktestConfig, run_backtest
from copula_var.data import synthetic_dataset
from copula_var.utils import StageTimer, load_artifacts, save_artifacts


def test_config_roundtrip():
    cfg = BacktestConfig(estimation_type="msm", copula_type="plackett")
    cfg.msm.k = 2
    d = cfg.to_dict()
    back = BacktestConfig.from_dict(d)
    assert back.estimation_type == "msm"
    assert back.msm.k == 2
    assert back.solver.obj_var == 0.05
    assert back.copula.nu_bounds == (2.01, 50.0)


def test_config_driven_run_and_artifacts(tmp_path):
    data = synthetic_dataset(jax.random.PRNGKey(5), 240, 220)
    cfg = BacktestConfig(estimation_type="garch", copula_type="gaussian",
                         n_insample=220, num_points=32)
    cfg.garch.p_max = cfg.garch.q_max = 1
    cfg.garch.newton_max_iter = 40
    bt, var = run_backtest(data, cfg)
    assert var.shape == (20,)
    assert np.all(np.isfinite(var))

    # save -> load -> identical solve
    path = str(tmp_path / "artifacts.npz")
    save_artifacts(path, bt)
    bt2 = load_artifacts(path, data)
    var2 = bt2.calc_var(obj_var=cfg.solver.obj_var)
    np.testing.assert_allclose(var2, var, rtol=1e-12)
    # loaded fits match
    assert bt2.model_fits[0].p == bt.model_fits[0].p
    np.testing.assert_allclose(
        bt2.copula_fit.corr_matrix, bt.copula_fit.corr_matrix
    )


def test_artifacts_msm_roundtrip(tmp_path):
    data = synthetic_dataset(jax.random.PRNGKey(6), 160, 150, spec=("msm", "garch"))
    from copula_var.backtest import create_var_backtest

    bt = create_var_backtest(
        data, "msm", "plackett", num_points=24, k=2, basin_iter=5
    )
    path = str(tmp_path / "msm.npz")
    save_artifacts(path, bt)
    bt2 = load_artifacts(path, data)
    b = np.column_stack([np.full(10, -100.0), np.full(10, -2.0)])
    np.testing.assert_allclose(
        bt2.compute_integral(b), bt.compute_integral(b), rtol=1e-12
    )


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    assert t.counts == {"a": 2, "b": 1}
    assert "a:" in t.report() and "b:" in t.report()


def test_config_knobs_are_honored():
    """Regression for dead-knob wiring: solver bracket, box, and copula
    grid settings must actually change behavior."""
    data = synthetic_dataset(jax.random.PRNGKey(8), 150, 130)
    cfg = BacktestConfig(estimation_type="garch", copula_type="plackett",
                         n_insample=130, num_points=24)
    cfg.garch.p_max = cfg.garch.q_max = 1
    cfg.garch.newton_max_iter = 30
    cfg.copula.theta_grid = (1.0, 5.0, 2)
    bt, var = run_backtest(data, cfg)
    assert np.all(np.isfinite(var))

    # a custom box changes the quadrature grid end-points
    cfg2 = BacktestConfig(estimation_type="garch", copula_type="gaussian",
                          n_insample=130, num_points=24)
    cfg2.garch.p_max = cfg2.garch.q_max = 1
    cfg2.garch.newton_max_iter = 30
    cfg2.solver.box = (-6.0, 6.0)
    bt2, var2 = run_backtest(data, cfg2)
    x = np.asarray(bt2.integration_inputs.x)
    assert x[0] == -6.0 and x[-1] == 6.0
    assert np.all(np.isfinite(var2))

    # a wider min_var_value moves the lower bracket for deep quantiles
    cfg3 = BacktestConfig(estimation_type="garch", copula_type="gaussian",
                          n_insample=130, num_points=24)
    cfg3.garch.p_max = cfg3.garch.q_max = 1
    cfg3.garch.newton_max_iter = 30
    cfg3.solver.min_var_value = -12.0
    bt3, var3 = run_backtest(data, cfg3)
    assert np.all(np.isfinite(var3))
