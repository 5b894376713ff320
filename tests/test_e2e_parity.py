"""End-to-end golden parity: the reference's OWN pipeline as the oracle.

Runs the reference `ValueAtRiskCalcualtion` (`/root/reference/utils/
calc_var_class.py:9-177`) — with its real adapters
(`utils/model_estimation/model/{garch,msm}_estimation.py`), grid builder,
integrands, and bisection — against `VaRBacktest` on identical data with
identical injected fitted parameters, and asserts the full (T,) VaR series
matches day by day.

Setup per side:
  * Data injection: the reference downloads from yfinance
    (`load_data.py:59`); we prefill its module-level returns cache
    (`load_data.py:7-9,21-30`) with a seeded synthetic DataFrame instead.
  * Param injection: both optimizers are skipped. The reference's
    class-level model-param caches (`calc_var_ABC.py:4-22`,
    `msm_estimation.py:34-51`, `garch_estimation.py:36-52`) are prefilled,
    and its copula fit entry (`copula_or_correl_params_insample`) is
    monkeypatched to return fixed params; `VaRBacktest` receives the same
    params via `model_fits_override` / `copula_fit_override`.
  * Quirk re-enabled: `reference_quirks=True` restores the reference's
    stage-2 bracket anchor (`calc_var_class.py:132`) so the two solvers
    follow bit-identical bisection trajectories.
  * joblib is forced sequential (`n_jobs=1`): the reference fans out with
    loky processes (`calc_integral.py:211`), whose workers would re-import
    numba (absent here; the parent uses the passthrough stub).

A transposed adapter axis, an off-by-one rolling window, a wrong combo
ordering, or any solver-stage drift fails these tests.
"""

import numpy as np
import pandas as pd
import pytest

from tests._reference import ref

TICKERS = ["AAA", "BBB"]
START = "2015-01-01"


@pytest.fixture
def sequential_joblib(monkeypatch):
    import joblib

    ci = ref("utils.calc_integral.calc_integral")
    monkeypatch.setattr(
        ci, "Parallel", lambda n_jobs: joblib.Parallel(n_jobs=1)
    )


def _inject_reference_data(returns):
    """Prefill the reference's returns cache (`load_data.py:21-30`) so
    `IndexReturnsRetriever` skips the yfinance download."""
    load_data = ref("data_loader.load_data")
    cache = load_data.SharedCacheIndexReturns
    cache.returns_cache.clear()
    cache.insample_cache.clear()
    dates = pd.bdate_range("2015-01-02", periods=len(returns))
    df = pd.DataFrame(returns, index=dates, columns=TICKERS)
    cache.returns_cache[(tuple(TICKERS), START, None)] = df


def _correlated_returns(rng, m, rho, scales):
    cov = np.array([[1.0, rho], [rho, 1.0]])
    z = rng.multivariate_normal(np.zeros(2), cov, size=m)
    return z * np.asarray(scales)[None, :]


def _assert_series_match(ours, theirs):
    ours = np.asarray(ours, dtype=float)
    theirs = np.asarray(theirs, dtype=float)
    assert ours.shape == theirs.shape
    # Bisection runs to tolerance 1e-6 on both sides from identical
    # brackets; with integrals agreeing to ~1e-12 the trajectories are
    # branch-identical and the roots agree far below the tolerance.
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-9)


def test_e2e_garch_gaussian(sequential_joblib, monkeypatch):
    """Full-pipeline parity, GARCH(1,1) + Gaussian copula, dim 2,
    per-asset DIFFERENT params and unequal weights (catches transposed
    axes the self-consistency tests cannot)."""
    rng = np.random.default_rng(7)
    N, T, num_points = 150, 25, 48
    weights = np.array([0.6, 0.4])
    returns = _correlated_returns(rng, N + T, 0.5, (1.0, 1.2))
    garch_params = [
        (0.05, 0.08, 0.88),
        (0.10, 0.12, 0.80),
    ]
    corr = np.array([[1.0, 0.45], [0.45, 1.0]])

    # --- reference side -------------------------------------------------
    _inject_reference_data(returns)
    abc = ref("utils.calc_var_ABC")
    abc.SharedCacheCopulaGarchVaR.cache.clear()
    for ticker, (omega, alpha, beta) in zip(TICKERS, garch_params):
        # model-param cache prefill (`garch_estimation.py:36-39`)
        abc.SharedCacheCopulaGarchVaR.cache[ticker] = {
            "optimal_params": {
                "best_pq": (1, 1),
                "best_params": np.array([omega, alpha, beta]),
                "best_bic": 0.0,
            }
        }
    ge = ref("utils.model_estimation.model.garch_estimation")
    gw = ref("utils.model_estimation.copula.gaussian_estimation")
    monkeypatch.setattr(
        gw.GaussianCopulaVaR,
        "copula_or_correl_params_insample",
        staticmethod(lambda m, d: {"corr_matrix": corr}),
    )
    cvc = ref("utils.calc_var_class")
    calc = cvc.ValueAtRiskCalcualtion(
        TICKERS, START, N, gw.GaussianCopulaVaR(ge.GarchEstimation()),
        None, num_points, weights,
    )
    ref_var = calc.calc_var(obj_var=0.05, first_guess=-3,
                            second_guess=(-3.5, -2))

    # --- our side ---------------------------------------------------------
    from copula_var.backtest import GarchAdapter, VaRBacktest
    from copula_var.copulas.fit import GaussianFit
    from copula_var.data.returns import from_returns
    from copula_var.models.fit import GarchFit

    data = from_returns(returns, TICKERS, N, weights)
    fits = [
        GarchFit(1, 1, omega, np.array([alpha]), np.array([beta]), 0.0,
                 0.0, np.array([omega, alpha, beta]))
        for (omega, alpha, beta) in garch_params
    ]
    bt = VaRBacktest(
        data, GarchAdapter(), "gaussian", num_points=num_points,
        model_fits_override=fits,
        copula_fit_override=GaussianFit(corr, 0.0, np.array([corr[0, 1]])),
        reference_quirks=True,
    )
    ours = bt.calc_var(obj_var=0.05, first_guess=-3.0,
                       second_guess=(-3.5, -2.0))
    _assert_series_match(ours, ref_var)


def test_e2e_mean_reverting_plackett(sequential_joblib, monkeypatch):
    """Full-pipeline parity, UKF mean-reverting + Plackett copula, dim 2 —
    covers the MR adapter's per-window UKF forecasts
    (`mean_reverting_estimation.py:192-232`, reusing the GARCH integrand)
    and the Plackett wrapper's scalar-theta packing
    (`plackett_estimation.py:11-36`)."""
    rng = np.random.default_rng(23)
    N, T, num_points = 120, 15, 40
    weights = np.array([0.55, 0.45])
    returns = _correlated_returns(rng, N + T, 0.45, (1.0, 1.1))
    mr_params = [
        # (a, l, q)
        (0.95, -0.10, 0.20),
        (0.90, 0.05, 0.30),
    ]
    theta = 4.0

    # --- reference side -------------------------------------------------
    _inject_reference_data(returns)
    abc = ref("utils.calc_var_ABC")
    abc.SharedCacheCopulaMRVaR.cache.clear()
    for ticker, (a, l, q) in zip(TICKERS, mr_params):
        # model-param cache prefill (`mean_reverting_estimation.py:36-39`)
        abc.SharedCacheCopulaMRVaR.cache[ticker] = {
            "optimal_params": {"a": a, "l": l, "q": q}
        }
    me = ref("utils.model_estimation.model.mean_reverting_estimation")
    pw = ref("utils.model_estimation.copula.plackett_estimation")
    monkeypatch.setattr(
        pw.PlackettCopulaVaR,
        "copula_or_correl_params_insample",
        staticmethod(lambda m, d: {"theta": theta}),
    )
    cvc = ref("utils.calc_var_class")
    calc = cvc.ValueAtRiskCalcualtion(
        TICKERS, START, N, pw.PlackettCopulaVaR(me.MeanRevertingEstimation()),
        None, num_points, weights,
    )
    ref_var = calc.calc_var(obj_var=0.05, first_guess=-3,
                            second_guess=(-3.5, -2))

    # --- our side ---------------------------------------------------------
    from copula_var.backtest import MeanRevertingAdapter, VaRBacktest
    from copula_var.copulas.fit import PlackettFit
    from copula_var.data.returns import from_returns
    from copula_var.models.fit import UkfFit

    data = from_returns(returns, TICKERS, N, weights)
    fits = [
        UkfFit(a=a, l=l, q=q, log_likelihood=0.0)
        for (a, l, q) in mr_params
    ]
    bt = VaRBacktest(
        data, MeanRevertingAdapter(), "plackett", num_points=num_points,
        model_fits_override=fits,
        copula_fit_override=PlackettFit(theta, 0.0, np.array([theta])),
        reference_quirks=True,
    )
    ours = bt.calc_var(obj_var=0.05, first_guess=-3.0,
                       second_guess=(-3.5, -2.0))
    _assert_series_match(ours, ref_var)


def test_e2e_garch_student(sequential_joblib, monkeypatch):
    """Full-pipeline parity, GARCH(1,1) + Student-t copula, dim 2 —
    crosses the Student wrapper's (nu, rho) packing
    (`student_estimation.py:22-56`) with the GARCH integrand's explicit
    pdf product (`garch_integration_function.py:31-40`), a pairing no
    other e2e test exercises."""
    rng = np.random.default_rng(31)
    N, T, num_points = 130, 15, 40
    weights = np.array([0.65, 0.35])
    returns = _correlated_returns(rng, N + T, 0.35, (0.9, 1.3))
    garch_params = [
        (0.08, 0.10, 0.85),
        (0.04, 0.05, 0.92),
    ]
    nu = 5.0
    corr = np.array([[1.0, 0.35], [0.35, 1.0]])

    # --- reference side -------------------------------------------------
    _inject_reference_data(returns)
    abc = ref("utils.calc_var_ABC")
    abc.SharedCacheCopulaGarchVaR.cache.clear()
    for ticker, (omega, alpha, beta) in zip(TICKERS, garch_params):
        abc.SharedCacheCopulaGarchVaR.cache[ticker] = {
            "optimal_params": {
                "best_pq": (1, 1),
                "best_params": np.array([omega, alpha, beta]),
                "best_bic": 0.0,
            }
        }
    ge = ref("utils.model_estimation.model.garch_estimation")
    sw = ref("utils.model_estimation.copula.student_estimation")
    monkeypatch.setattr(
        sw.StudentCopulaVaR,
        "copula_or_correl_params_insample",
        staticmethod(
            lambda m, d: {"optimized_params": np.array([nu]),
                          "corr_matrix": corr}
        ),
    )
    cvc = ref("utils.calc_var_class")
    calc = cvc.ValueAtRiskCalcualtion(
        TICKERS, START, N, sw.StudentCopulaVaR(ge.GarchEstimation()),
        None, num_points, weights,
    )
    ref_var = calc.calc_var(obj_var=0.05, first_guess=-3,
                            second_guess=(-3.5, -2))

    # --- our side ---------------------------------------------------------
    from copula_var.backtest import GarchAdapter, VaRBacktest
    from copula_var.copulas.fit import StudentFit
    from copula_var.data.returns import from_returns
    from copula_var.models.fit import GarchFit

    data = from_returns(returns, TICKERS, N, weights)
    fits = [
        GarchFit(1, 1, omega, np.array([alpha]), np.array([beta]), 0.0,
                 0.0, np.array([omega, alpha, beta]))
        for (omega, alpha, beta) in garch_params
    ]
    bt = VaRBacktest(
        data, GarchAdapter(), "student", num_points=num_points,
        model_fits_override=fits,
        copula_fit_override=StudentFit(
            nu, corr, 0.0, np.array([nu, corr[0, 1]])
        ),
        reference_quirks=True,
    )
    ours = bt.calc_var(obj_var=0.05, first_guess=-3.0,
                       second_guess=(-3.5, -2.0))
    _assert_series_match(ours, ref_var)


def test_e2e_msm_plackett(sequential_joblib, monkeypatch):
    """Full-pipeline parity, MSM(k=2) + Plackett copula, dim 2 — crosses
    the MSM mixture-CDF integrand (`msm_integration_function.py:34-47`)
    with the Plackett closed-form density (`plackett.py:45-71`), and
    covers k=2 (the other value for which the reference's
    `int(sqrt(2^k))` k-recovery quirk is valid,
    `msm_estimation.py:125`)."""
    rng = np.random.default_rng(43)
    N, T, num_points, k = 110, 12, 36, 2
    weights = np.array([0.5, 0.5])
    returns = _correlated_returns(rng, N + T, 0.5, (1.0, 0.95))
    msm_params = [
        # (m_0, sig, b, gamma)
        (0.5, 0.9, 4.0, 0.4),
        (0.6, 1.1, 2.5, 0.6),
    ]
    theta = 6.0

    # --- reference side -------------------------------------------------
    _inject_reference_data(returns)
    abc = ref("utils.calc_var_ABC")
    abc.SharedCacheCopulaMSMVaR.cache.clear()
    for ticker, (m_0, sig, b, gamma) in zip(TICKERS, msm_params):
        abc.SharedCacheCopulaMSMVaR.cache[(ticker, k)] = {
            "optimal_params": {"m_0": m_0, "sig": sig, "b": b,
                               "gamma": gamma}
        }
    me = ref("utils.model_estimation.model.msm_estimation")
    pw = ref("utils.model_estimation.copula.plackett_estimation")
    monkeypatch.setattr(
        pw.PlackettCopulaVaR,
        "copula_or_correl_params_insample",
        staticmethod(lambda m, d: {"theta": theta}),
    )
    cvc = ref("utils.calc_var_class")
    calc = cvc.ValueAtRiskCalcualtion(
        TICKERS, START, N, pw.PlackettCopulaVaR(me.MSMEstimation()),
        None, num_points, weights, k=k,
    )
    ref_var = calc.calc_var(obj_var=0.05, first_guess=-3,
                            second_guess=(-3.5, -2))

    # --- our side ---------------------------------------------------------
    from copula_var.backtest import MsmAdapter, VaRBacktest
    from copula_var.copulas.fit import PlackettFit
    from copula_var.data.returns import from_returns
    from copula_var.models.fit import MsmFit

    data = from_returns(returns, TICKERS, N, weights)
    fits = [
        MsmFit(m_0=m_0, b=b, gamma=gamma, sigma=sig, log_likelihood=0.0)
        for (m_0, sig, b, gamma) in msm_params
    ]
    bt = VaRBacktest(
        data, MsmAdapter(k=k), "plackett", num_points=num_points,
        model_fits_override=fits,
        copula_fit_override=PlackettFit(theta, 0.0, np.array([theta])),
        reference_quirks=True,
    )
    ours = bt.calc_var(obj_var=0.05, first_guess=-3.0,
                       second_guess=(-3.5, -2.0))
    _assert_series_match(ours, ref_var)


def test_e2e_msm_student(sequential_joblib, monkeypatch):
    """Full-pipeline parity, MSM(k=4) + Student-t copula, dim 2 — the
    flagship combination (`main.py:63-71`), exercising forecasts_array
    window alignment, sum_forecast_by_state collapse, densities-on-grid
    assembly, combo ordering, and the full 3-stage solve."""
    rng = np.random.default_rng(11)
    N, T, num_points, k = 120, 15, 36, 4
    weights = np.array([0.6, 0.4])
    returns = _correlated_returns(rng, N + T, 0.4, (1.0, 1.1))
    msm_params = [
        # (m_0, sig, b, gamma)
        (0.45, 1.0, 3.0, 0.5),
        (0.55, 1.2, 5.0, 0.3),
    ]
    nu = 6.0
    corr = np.array([[1.0, 0.45], [0.45, 1.0]])

    # --- reference side -------------------------------------------------
    _inject_reference_data(returns)
    abc = ref("utils.calc_var_ABC")
    abc.SharedCacheCopulaMSMVaR.cache.clear()
    for ticker, (m_0, sig, b, gamma) in zip(TICKERS, msm_params):
        # model-param cache prefill (`msm_estimation.py:34-37`)
        abc.SharedCacheCopulaMSMVaR.cache[(ticker, k)] = {
            "optimal_params": {"m_0": m_0, "sig": sig, "b": b,
                               "gamma": gamma}
        }
    me = ref("utils.model_estimation.model.msm_estimation")
    sw = ref("utils.model_estimation.copula.student_estimation")
    monkeypatch.setattr(
        sw.StudentCopulaVaR,
        "copula_or_correl_params_insample",
        staticmethod(
            lambda m, d: {"optimized_params": np.array([nu]),
                          "corr_matrix": corr}
        ),
    )
    cvc = ref("utils.calc_var_class")
    calc = cvc.ValueAtRiskCalcualtion(
        TICKERS, START, N, sw.StudentCopulaVaR(me.MSMEstimation()),
        None, num_points, weights, k=k,
    )
    ref_var = calc.calc_var(obj_var=0.05, first_guess=-3,
                            second_guess=(-3.5, -2))

    # --- our side ---------------------------------------------------------
    from copula_var.backtest import MsmAdapter, VaRBacktest
    from copula_var.copulas.fit import StudentFit
    from copula_var.data.returns import from_returns
    from copula_var.models.fit import MsmFit

    data = from_returns(returns, TICKERS, N, weights)
    fits = [
        MsmFit(m_0=m_0, b=b, gamma=gamma, sigma=sig, log_likelihood=0.0)
        for (m_0, sig, b, gamma) in msm_params
    ]
    bt = VaRBacktest(
        data, MsmAdapter(k=k), "student", num_points=num_points,
        model_fits_override=fits,
        copula_fit_override=StudentFit(
            nu, corr, 0.0, np.array([nu, corr[0, 1]])
        ),
        reference_quirks=True,
    )
    ours = bt.calc_var(obj_var=0.05, first_guess=-3.0,
                       second_guess=(-3.5, -2.0))
    _assert_series_match(ours, ref_var)


# --- the remaining 4 cells of the 3 x 3 model x copula grid -----------------
#
# (VERDICT r04 next #5) The 5 named tests above cover every family and
# copula at least once; this parametrized harness closes the grid so all
# 9 combinations (`utils/factory.py:10-31`) are golden day-by-day.

_GARCH_P = [(0.05, 0.08, 0.88), (0.10, 0.12, 0.80)]
_MSM_P = [(0.5, 0.9, 4.0, 0.4), (0.6, 1.1, 2.5, 0.6)]  # (m_0, sig, b, gm)
_MR_P = [(0.95, -0.10, 0.20), (0.90, 0.05, 0.30)]  # (a, l, q)
_CORR = np.array([[1.0, 0.45], [0.45, 1.0]])
_NU, _THETA, _K = 5.0, 4.0, 2


def _prefill_model_cache(family):
    abc = ref("utils.calc_var_ABC")
    if family == "garch":
        abc.SharedCacheCopulaGarchVaR.cache.clear()
        for ticker, (omega, alpha, beta) in zip(TICKERS, _GARCH_P):
            abc.SharedCacheCopulaGarchVaR.cache[ticker] = {
                "optimal_params": {
                    "best_pq": (1, 1),
                    "best_params": np.array([omega, alpha, beta]),
                    "best_bic": 0.0,
                }
            }
        return ref(
            "utils.model_estimation.model.garch_estimation"
        ).GarchEstimation()
    if family == "msm":
        abc.SharedCacheCopulaMSMVaR.cache.clear()
        for ticker, (m_0, sig, b, gamma) in zip(TICKERS, _MSM_P):
            abc.SharedCacheCopulaMSMVaR.cache[(ticker, _K)] = {
                "optimal_params": {"m_0": m_0, "sig": sig, "b": b,
                                   "gamma": gamma}
            }
        return ref(
            "utils.model_estimation.model.msm_estimation"
        ).MSMEstimation()
    abc.SharedCacheCopulaMRVaR.cache.clear()
    for ticker, (a, l, q) in zip(TICKERS, _MR_P):
        abc.SharedCacheCopulaMRVaR.cache[ticker] = {
            "optimal_params": {"a": a, "l": l, "q": q}
        }
    return ref(
        "utils.model_estimation.model.mean_reverting_estimation"
    ).MeanRevertingEstimation()


def _ref_copula_wrapper(copula, model_est, monkeypatch):
    if copula == "gaussian":
        gw = ref("utils.model_estimation.copula.gaussian_estimation")
        monkeypatch.setattr(
            gw.GaussianCopulaVaR, "copula_or_correl_params_insample",
            staticmethod(lambda m, d: {"corr_matrix": _CORR}),
        )
        return gw.GaussianCopulaVaR(model_est)
    if copula == "student":
        sw = ref("utils.model_estimation.copula.student_estimation")
        monkeypatch.setattr(
            sw.StudentCopulaVaR, "copula_or_correl_params_insample",
            staticmethod(lambda m, d: {
                "optimized_params": np.array([_NU]), "corr_matrix": _CORR,
            }),
        )
        return sw.StudentCopulaVaR(model_est)
    pw = ref("utils.model_estimation.copula.plackett_estimation")
    monkeypatch.setattr(
        pw.PlackettCopulaVaR, "copula_or_correl_params_insample",
        staticmethod(lambda m, d: {"theta": _THETA}),
    )
    return pw.PlackettCopulaVaR(model_est)


def _our_side(family, copula, returns, N, weights, num_points):
    from copula_var.backtest import (
        GarchAdapter, MeanRevertingAdapter, MsmAdapter, VaRBacktest,
    )
    from copula_var.copulas.fit import (
        GaussianFit, PlackettFit, StudentFit,
    )
    from copula_var.data.returns import from_returns
    from copula_var.models.fit import GarchFit, MsmFit, UkfFit

    data = from_returns(returns, TICKERS, N, weights)
    if family == "garch":
        adapter = GarchAdapter()
        fits = [
            GarchFit(1, 1, o, np.array([a]), np.array([b]), 0.0, 0.0,
                     np.array([o, a, b]))
            for (o, a, b) in _GARCH_P
        ]
    elif family == "msm":
        adapter = MsmAdapter(k=_K)
        fits = [
            MsmFit(m_0=m, b=b, gamma=g, sigma=s, log_likelihood=0.0)
            for (m, s, b, g) in _MSM_P
        ]
    else:
        adapter = MeanRevertingAdapter()
        fits = [UkfFit(a=a, l=l, q=q, log_likelihood=0.0)
                for (a, l, q) in _MR_P]
    cop_fit = {
        "gaussian": GaussianFit(_CORR, 0.0, np.array([_CORR[0, 1]])),
        "student": StudentFit(_NU, _CORR, 0.0,
                              np.array([_NU, _CORR[0, 1]])),
        "plackett": PlackettFit(_THETA, 0.0, np.array([_THETA])),
    }[copula]
    return VaRBacktest(
        data, adapter, copula, num_points=num_points,
        model_fits_override=fits, copula_fit_override=cop_fit,
        reference_quirks=True,
    )


@pytest.mark.slow
@pytest.mark.parametrize(
    "family,copula",
    [
        ("msm", "gaussian"),
        ("garch", "plackett"),
        ("mean_reverting", "gaussian"),
        ("mean_reverting", "student"),
    ],
)
def test_e2e_grid_remaining_cells(family, copula, sequential_joblib,
                                  monkeypatch):
    rng = np.random.default_rng(101)
    N, T, num_points = 110, 10, 36
    weights = np.array([0.6, 0.4])
    returns = _correlated_returns(rng, N + T, 0.4, (1.0, 1.1))

    _inject_reference_data(returns)
    model_est = _prefill_model_cache(family)
    wrapper = _ref_copula_wrapper(copula, model_est, monkeypatch)
    cvc = ref("utils.calc_var_class")
    kw = {"k": _K} if family == "msm" else {}
    calc = cvc.ValueAtRiskCalcualtion(
        TICKERS, START, N, wrapper, None, num_points, weights, **kw,
    )
    ref_var = calc.calc_var(obj_var=0.05, first_guess=-3,
                            second_guess=(-3.5, -2))

    bt = _our_side(family, copula, returns, N, weights, num_points)
    ours = bt.calc_var(obj_var=0.05, first_guess=-3.0,
                       second_guess=(-3.5, -2.0))
    _assert_series_match(ours, ref_var)
