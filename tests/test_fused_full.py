"""Fully fused solve (stage-1/2 bracketing + bisection in ONE dispatch)
and the stable-identity device bisection programs.

VERDICT r03 tasks 1-2:
  * `calc_var` on the fused engines must perform exactly ONE device
    dispatch after prep — asserted via the host integral-call counter
    (zero `compute_integral` calls) and `last_solve_dispatches == 1`.
  * A second same-shape `VaRBacktest` must trigger ZERO new traces of the
    module-level bisection programs — asserted via `_cache_size()`.
"""

import numpy as np
import pytest

from copula_var.backtest import create_var_backtest
from copula_var.data import returns as returns_mod


def _data(rng, n_total=240, n_insample=200, dim=2, seed_scale=1.0):
    rets = rng.standard_normal((n_total, dim)) * (
        1.0 + 0.5 * np.abs(np.sin(np.arange(n_total) / 17.0))[:, None]
    ) * seed_scale
    return returns_mod.from_returns(rets, n_insample=n_insample)


@pytest.fixture
def data(rng):
    return _data(rng)


def _build(data, engine, **kw):
    kw.setdefault("num_points", 40)
    # the fused engines run their kernel in the Pallas interpreter here
    kw.setdefault("interpret", engine in ("pallas", "sharded_pallas"))
    return create_var_backtest(data, "garch", "gaussian", engine=engine,
                               p_max=1, q_max=1, **kw)


def test_fused_engine_single_dispatch(data):
    bt = _build(data, "pallas")
    v = bt.calc_var()
    assert getattr(bt, "_integral_calls", 0) == 0, (
        "fused engine must not run host-driven integral sweeps"
    )
    assert bt.last_solve_dispatches == 1
    assert np.all(np.isfinite(v))


def test_fused_matches_xla_engine(data):
    v_x = _build(data, "xla").calc_var()
    v_p = _build(data, "pallas").calc_var()
    # interpret-mode f32 vs f64: plateau-bounded agreement; at these
    # smooth synthetic configs the roots coincide to f32 resolution
    np.testing.assert_allclose(v_p, v_x, atol=5e-6)


def test_fused_levels_match_singles(data):
    bt = _build(data, "pallas")
    lv = bt.calc_var_levels([0.01, 0.05])
    v1 = bt.calc_var(0.01)
    v5 = bt.calc_var(0.05)
    np.testing.assert_allclose(lv[0], v1, atol=1e-6)
    np.testing.assert_allclose(lv[1], v5, atol=1e-6)


def test_fused_sharded_pallas_matches_pallas(data):
    v_p = _build(data, "pallas").calc_var()
    bt_s = _build(data, "sharded_pallas")
    v_s = bt_s.calc_var()
    assert getattr(bt_s, "_integral_calls", 0) == 0
    assert bt_s.last_solve_dispatches == 1
    np.testing.assert_allclose(v_s, v_p, atol=1e-6)


def test_fused_reference_quirks_flag(data):
    """reference_quirks must thread through the fused program: the fused
    quirk solve equals the staged XLA quirk solve (and differs from the
    defect-fixed solve on the affected days)."""
    v_fixed = _build(data, "pallas").calc_var()
    bt_q = _build(data, "pallas")
    bt_q.reference_quirks = True
    v_q = bt_q.calc_var()
    bt_xq = _build(data, "xla")
    bt_xq.reference_quirks = True
    v_xq = bt_xq.calc_var()
    assert np.all(np.isfinite(v_q))
    np.testing.assert_allclose(v_q, v_xq, atol=5e-6)
    # on this config the defect bites (days with F(sg1) < obj_var exist)
    assert np.max(np.abs(v_q - v_fixed)) > 1e-3


def test_device_bisection_zero_retrace(rng):
    """Second same-shape backtest dispatches the compiled module-level
    program: `_cache_size()` of the fused whole-solve program must not
    grow (the xla engine now runs stage sweeps + bracketing + bisection
    as ONE dispatch through `_device_full_solve_levels_jit`)."""
    from copula_var.backtest import _device_full_solve_levels_jit

    d1 = _data(rng)
    bt1 = _build(d1, "xla")
    bt1.calc_var()
    bt1.calc_var_levels([0.01, 0.05])
    assert bt1.last_solve_dispatches == 1
    assert getattr(bt1, "_integral_calls", 0) == 0
    n1 = _device_full_solve_levels_jit._cache_size()
    assert n1 >= 1

    d2 = _data(rng, seed_scale=1.3)  # same shapes, different values
    bt2 = _build(d2, "xla")
    bt2.calc_var()
    bt2.calc_var_levels([0.01, 0.05])
    assert _device_full_solve_levels_jit._cache_size() == n1


def test_msm_fused_engine(rng):
    """MSM family through the fused path (q > 1 branch)."""
    d = _data(rng, n_total=160, n_insample=130)
    common = dict(num_points=40, k=2, basin_iter=8)
    bt_x = create_var_backtest(d, "msm", "student", engine="xla", **common)
    bt_p = create_var_backtest(
        d, "msm", "student", engine="pallas", interpret=True,
        model_fits_override=bt_x.model_fits,
        copula_fit_override=bt_x.copula_fit, **common,
    )
    v_x = bt_x.calc_var()
    v_p = bt_p.calc_var()
    assert bt_p.last_solve_dispatches == 1
    np.testing.assert_allclose(v_p, v_x, atol=5e-5)


def test_fused_plackett_family(data):
    """Plackett copula through the fused one-dispatch pallas engine
    (day tensors are copula-generic; completes the 3-copula coverage of
    the fused path)."""
    bt_x = create_var_backtest(data, "garch", "plackett", engine="xla",
                               p_max=1, q_max=1, num_points=40)
    v_x = bt_x.calc_var()
    bt_p = create_var_backtest(data, "garch", "plackett", engine="pallas",
                               interpret=True, p_max=1, q_max=1, num_points=40,
                               model_fits_override=bt_x.model_fits,
                               copula_fit_override=bt_x.copula_fit)
    v_p = bt_p.calc_var()
    assert bt_p.last_solve_dispatches == 1
    np.testing.assert_allclose(v_p, v_x, atol=5e-5)


def test_calc_var_portfolios_matches_per_weight_backtests(data):
    """L portfolios ride the fused kernel's level axis in ONE dispatch:
    row l equals a separate backtest whose data carries weights l
    (exact in interpret mode, incl. each row's own portfolio mean).
    Capability extension beyond the reference (one weight vector per
    calculator)."""
    W = np.array([[0.5, 0.5], [0.8, 0.2], [0.3, 0.7]])
    bt = _build(data, "pallas")
    out = bt.calc_var_portfolios(W, obj_var=0.05)
    assert out.shape == (3, data.out_sample_n)
    assert bt.last_solve_dispatches == 1
    for l in range(3):
        d_l = returns_mod.from_returns(
            data.returns, n_insample=data.n_insample, weights=W[l]
        )
        bt_l = create_var_backtest(
            d_l, "garch", "gaussian", engine="pallas", interpret=True,
            p_max=1, q_max=1, num_points=40, model_fits_override=bt.model_fits,
            copula_fit_override=bt.copula_fit,
        )
        np.testing.assert_allclose(out[l], bt_l.calc_var(0.05), atol=1e-6)


def test_calc_var_portfolios_sharded_gspmd(data):
    """Portfolio batch on the day-sharded GSPMD engine: f64-exact vs the
    xla kernel-path batch on the 8-device mesh."""
    W = np.array([[0.5, 0.5], [0.8, 0.2]])
    want = _build(data, "xla").calc_var_portfolios(W)
    bt = _build(data, "sharded")
    got = bt.calc_var_portfolios(W)
    assert bt.last_solve_dispatches == 1
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_calc_var_portfolios_rejects_bad_inputs(data):
    bt2 = _build(data, "xla")
    with pytest.raises(ValueError, match="weights_batch"):
        bt2.calc_var_portfolios(np.array([[0.5, 0.3, 0.2]]))


def test_calc_var_portfolios_sharded_pallas(data):
    """Portfolio batch through the day-sharded fused engine (shard_map
    over the 8-device mesh; weights replicate, days shard)."""
    W = np.array([[0.5, 0.5], [0.7, 0.3]])
    bt_p = _build(data, "pallas")
    want = bt_p.calc_var_portfolios(W)
    bt_s = _build(data, "sharded_pallas")
    got = bt_s.calc_var_portfolios(W)
    assert bt_s.last_solve_dispatches == 1
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_calc_var_portfolios_per_row_alpha(data):
    """Mixed (weights, alpha) query batches: obj_var may be (L,) — each
    portfolio row solves its own confidence level in the same launch."""
    W = np.array([[0.5, 0.5], [0.5, 0.5]])
    bt = _build(data, "pallas")
    out = bt.calc_var_portfolios(W, obj_var=np.array([0.01, 0.05]))
    v1 = bt.calc_var(0.01)
    v5 = bt.calc_var(0.05)
    np.testing.assert_allclose(out[0], v1, atol=1e-6)
    np.testing.assert_allclose(out[1], v5, atol=1e-6)


def test_calc_var_portfolios_xla_engine(data):
    """Portfolio batches on the f64 parity engine (kernel-id path): each
    row equals a per-weight xla backtest EXACTLY (same f64 ops)."""
    W = np.array([[0.5, 0.5], [0.8, 0.2]])
    bt = _build(data, "xla")
    out = bt.calc_var_portfolios(W, obj_var=0.05)
    for l in range(2):
        d_l = returns_mod.from_returns(
            data.returns, n_insample=data.n_insample, weights=W[l]
        )
        bt_l = create_var_backtest(
            d_l, "garch", "gaussian", engine="xla", p_max=1, q_max=1,
            num_points=40, model_fits_override=bt.model_fits,
            copula_fit_override=bt.copula_fit,
        )
        np.testing.assert_allclose(out[l], bt_l.calc_var(0.05), atol=1e-12)


def test_calc_var_portfolios_dim3(rng):
    """3-asset portfolio batch through the xla tcached kernel path."""
    n_total, N = 140, 120
    rets = rng.standard_normal((n_total, 3)) * (
        1.0 + 0.3 * np.abs(np.sin(np.arange(n_total) / 11.0))[:, None]
    )
    data3 = returns_mod.from_returns(rets, n_insample=N)
    bt = create_var_backtest(data3, "garch", "gaussian", engine="xla",
                             p_max=1, q_max=1, num_points=16)
    W = np.array([[1 / 3, 1 / 3, 1 / 3], [0.6, 0.2, 0.2]])
    out = bt.calc_var_portfolios(W)
    assert out.shape == (2, data3.out_sample_n)
    d_l = returns_mod.from_returns(rets, n_insample=N, weights=W[1])
    bt_l = create_var_backtest(d_l, "garch", "gaussian", engine="xla",
                               p_max=1, q_max=1, num_points=16,
                               model_fits_override=bt.model_fits,
                               copula_fit_override=bt.copula_fit)
    np.testing.assert_allclose(out[1], bt_l.calc_var(0.05), atol=1e-12)


def test_calc_var_portfolios_sharded_dim3(rng):
    """Portfolio batch on the dim-3 day-sharded transform-column engine:
    f64-exact vs the xla kernel-path batch on the 8-device mesh."""
    n_total, N = 140, 120
    rets = rng.standard_normal((n_total, 3)) * (
        1.0 + 0.3 * np.abs(np.sin(np.arange(n_total) / 11.0))[:, None]
    )
    data3 = returns_mod.from_returns(rets, n_insample=N)
    bt_x = create_var_backtest(data3, "garch", "gaussian", engine="xla",
                               p_max=1, q_max=1, num_points=16)
    W = np.array([[1 / 3, 1 / 3, 1 / 3], [0.6, 0.2, 0.2]])
    want = bt_x.calc_var_portfolios(W)
    bt_s = create_var_backtest(data3, "garch", "gaussian",
                               engine="sharded", p_max=1, q_max=1,
                               num_points=16,
                               model_fits_override=bt_x.model_fits,
                               copula_fit_override=bt_x.copula_fit)
    got = bt_s.calc_var_portfolios(W)
    assert bt_s.last_solve_dispatches == 1
    np.testing.assert_allclose(got, want, atol=1e-12)
