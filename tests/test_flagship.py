"""Flagship pinned-run reproduction (VERDICT r03 task #7).

The committed flagship dataset (`data/flagship.csv`, a deterministic
synthetic stand-in for the reference's ^GSPC/^IXIC window — see
`examples/make_flagship_data.py` for why) and the committed run record
(`data/flagship_var.npz`, produced by `examples/flagship.py` on CPU f64)
must reproduce:

  * the dataset generator is byte-stable;
  * the solve pipeline, restarted from the committed fitted-parameter
    artifacts, reproduces the committed (T,) VaR series at 1e-9;
  * the recorded coverage statistics recompute from the series.
"""

import hashlib
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")


def _series_hash(arr):
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(arr, np.float64)).tobytes()
    ).hexdigest()[:16]


def test_flagship_dataset_is_deterministic():
    import pandas as pd

    from examples.make_flagship_data import COLUMNS, flagship_prices

    prices = flagship_prices()
    df = pd.read_csv(os.path.join(DATA, "flagship.csv"))
    assert list(df.columns) == ["date"] + list(COLUMNS)
    np.testing.assert_allclose(
        df[list(COLUMNS)].to_numpy(), np.round(prices, 6), atol=5e-7
    )
    assert df["date"].iloc[0] == "2009-04-15"


@pytest.mark.slow
@pytest.mark.parametrize("est", ["garch", "msm"])
def test_flagship_var_series_reproduces(est):
    """Solve from the committed artifacts and match the committed VaR
    series day-by-day (f64 engine; fits are injected from the artifact,
    so this pins the whole post-fit pipeline)."""
    from copula_var import data as data_mod
    from copula_var import stats
    from copula_var.utils.artifacts import load_artifacts

    data = data_mod.from_csv(os.path.join(DATA, "flagship.csv"),
                             n_insample=1135)
    rec = np.load(os.path.join(DATA, "flagship_var.npz"))
    bt = load_artifacts(
        os.path.join(DATA, f"flagship_artifacts_{est}.npz"), data
    )
    var = bt.calc_var(float(rec["obj_var"]))
    want = rec[f"{est}_var"]
    np.testing.assert_allclose(var, want, atol=1e-9)
    assert _series_hash(var) == str(rec[f"{est}_var_hash"])
    # recorded coverage statistics recompute
    ptf = data.portfolio_out_sample()
    np.testing.assert_allclose(
        stats.exception_rate(ptf, var), float(rec[f"{est}_exception_rate"]),
        atol=1e-12,
    )
    kup = stats.kupiec_pof(ptf, var, float(rec["obj_var"]))
    np.testing.assert_allclose(kup.p_value, float(rec[f"{est}_kupiec_p"]),
                               atol=1e-9)


def test_flagship_schema_round_trip(tmp_path):
    """Real-data readiness drill (VERDICT r04 next #9): the shared CSV
    writer produces exactly the schema `from_csv` consumes — when
    network exists, `python examples/make_flagship_data.py
    --from-yfinance` swaps in the real ^GSPC/^IXIC window with no other
    code changes."""
    import pandas as pd

    from examples.make_flagship_data import write_flagship_csv
    from copula_var.data import from_csv

    rng = np.random.default_rng(1)
    n = 40
    prices = 100.0 * np.exp(
        np.cumsum(rng.standard_normal((n, 2)) * 0.01, axis=0)
    )
    dates = pd.bdate_range("2009-04-15", periods=n).strftime("%Y-%m-%d")
    path = str(tmp_path / "fl.csv")
    write_flagship_csv(prices, list(dates), ("GSPC", "IXIC"), path)
    data = from_csv(path, n_insample=30)
    assert data.tickers == ["GSPC", "IXIC"]
    assert data.returns.shape == (n - 1, 2)
    want = np.log(np.round(prices[1:], 6) / np.round(prices[:-1], 6)) * 100
    np.testing.assert_allclose(data.returns, want, atol=1e-9)


def test_flagship_yfinance_path_gated_offline():
    from examples.make_flagship_data import real_flagship_prices

    with pytest.raises(RuntimeError, match="yfinance"):
        real_flagship_prices()
