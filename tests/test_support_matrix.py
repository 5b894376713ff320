"""Engine x dim support matrix (VERDICT r04 next #4).

The README's support table is a CONTRACT: every supported cell works,
and every unsupported cell raises the documented loud error — never a
silent wrong answer. This test pins the unsupported cells.
"""

import numpy as np
import pytest

from copula_var.backtest import (
    GarchAdapter,
    VaRBacktest,
    create_var_backtest,
)
from copula_var.copulas.fit import GaussianFit
from copula_var.data import returns as returns_mod
from copula_var.models.fit import GarchFit


def _bt(dim, engine, n_points=16, refine=False, copula="gaussian"):
    rng = np.random.default_rng(3)
    n_in, T = 120, 20
    rets = rng.standard_normal((n_in + T, dim))
    data = returns_mod.from_returns(rets, n_insample=n_in)
    fits = [
        GarchFit(1, 1, 0.2, np.array([0.1]), np.array([0.7]), 0.0, 0.0,
                 np.array([0.2, 0.1, 0.7]))
        for _ in range(dim)
    ]
    return VaRBacktest(
        data, GarchAdapter(p_max=1, q_max=1), copula,
        num_points=n_points, engine=engine, model_fits_override=fits,
        copula_fit_override=GaussianFit(np.eye(dim), 0.0, np.zeros(1)),
        refine_root=refine,
        interpret=engine in ("pallas", "sharded_pallas"),
    )


@pytest.mark.parametrize(
    "dim,engine,match",
    [
        # the fused kernel (single-chip and day-sharded) solves dim 2 day
        # tensors only; dim >= 3 runs on xla / sharded / grid_sharded
        (3, "pallas", "dim"),
        (4, "pallas", "dim"),
        (3, "sharded_pallas", "dim"),
        (4, "sharded_pallas", "dim"),
    ],
)
def test_unsupported_engine_dim_raises(dim, engine, match):
    bt = _bt(dim, engine)
    with pytest.raises(ValueError, match=match):
        bt.calc_var()


def test_refine_root_sharded_pallas_dim2_matches_xla():
    """sharded_pallas dim 2 + refine_root: the fused staircase roots
    refine in a SECOND GSPMD dispatch over the sharded tensors; the
    trap re-solve contracts onto the same trap root as refined xla."""
    want = _bt(2, "xla", refine=True).calc_var()
    bt = _bt(2, "sharded_pallas", refine=True)
    got = bt.calc_var()
    assert bt.last_solve_dispatches == 2
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_refine_root_grid_sharded_matches_xla():
    """engine='grid_sharded' + refine_root: the trap sweep shards the
    grid axis with psum partials — f64-exact vs the refined xla root
    (dim 2 and the dim-3 chunked tcached rebuild)."""
    want2 = _bt(2, "xla", refine=True).calc_var()
    got2 = _bt(2, "grid_sharded", refine=True).calc_var()
    np.testing.assert_allclose(got2, want2, atol=1e-12)
    want3 = _bt(3, "xla", refine=True).calc_var()
    got3 = _bt(3, "grid_sharded", refine=True).calc_var()
    np.testing.assert_allclose(got3, want3, atol=1e-12)


def test_refine_root_sharded_matches_xla():
    """engine='sharded' + refine_root: the trap re-solve rides the
    day-sharded tensors (GSPMD) — f64-exact vs the refined xla root."""
    want = _bt(2, "xla", refine=True).calc_var()
    got = _bt(2, "sharded", refine=True).calc_var()
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_refine_root_sharded_dim3_matches_xla():
    """dim >= 3: the shard_map tcached trap twin refines per-shard."""
    want = _bt(3, "xla", refine=True).calc_var()
    got = _bt(3, "sharded", refine=True).calc_var()
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_plackett_dim3_raises():
    from copula_var.copulas.fit import PlackettFit

    rng = np.random.default_rng(3)
    rets = rng.standard_normal((140, 3))
    data = returns_mod.from_returns(rets, n_insample=120)
    fits = [
        GarchFit(1, 1, 0.2, np.array([0.1]), np.array([0.7]), 0.0, 0.0,
                 np.array([0.2, 0.1, 0.7]))
        for _ in range(3)
    ]
    bt = VaRBacktest(
        data, GarchAdapter(p_max=1, q_max=1), "plackett", num_points=16,
        engine="xla", model_fits_override=fits,
        copula_fit_override=PlackettFit(4.0, 0.0, np.array([4.0])),
    )
    with pytest.raises(ValueError, match="[Pp]lackett"):
        bt.calc_var()


def test_grid_sharded_indivisible_points_raises():
    bt = _bt(2, "grid_sharded", n_points=17)
    with pytest.raises(ValueError, match="not divisible"):
        bt.calc_var()


def test_dim4_xla_and_sharded_supported():
    """The f64 tcached paths carry dim >= 4 (the README table's
    supported column): smoke at tiny n."""
    v = _bt(4, "xla").calc_var()
    assert np.all(np.isfinite(v)) and np.all(v < 0)


def test_refine_root_grid_sharded_msm_student():
    """The msm-family grid trap sweep (state-row rescaling dx -> tw,
    student transforms) matches the refined xla root exactly."""
    from copula_var.backtest import MsmAdapter
    from copula_var.copulas.fit import StudentFit
    from copula_var.models.fit import MsmFit

    rng = np.random.default_rng(5)
    rets = rng.standard_normal((140, 2))
    data = returns_mod.from_returns(rets, n_insample=120)
    fits = [
        MsmFit(m_0=0.5, b=3.0, gamma=0.5, sigma=1.0, log_likelihood=0.0),
        MsmFit(m_0=0.6, b=5.0, gamma=0.4, sigma=1.1, log_likelihood=0.0),
    ]
    corr = np.array([[1.0, 0.4], [0.4, 1.0]])

    def bt(engine):
        return VaRBacktest(
            data, MsmAdapter(k=2), "student", num_points=16,
            engine=engine, model_fits_override=fits,
            copula_fit_override=StudentFit(6.0, corr, 0.0,
                                           np.array([6.0, 0.4])),
            refine_root=True,
        )

    want = bt("xla").calc_var()
    got = bt("grid_sharded").calc_var()
    np.testing.assert_allclose(got, want, atol=1e-12)
