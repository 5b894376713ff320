"""Returns ingestion and rolling-window tensor construction.

Capability surface of the reference `data_loader/load_data.py`:
log-returns x 100 from adjusted closes (`load_data.py:59-66`), sort/dropna,
first-N in-sample split, demeaning by in-sample means, portfolio mean
`ptf_mean = sum_i mean_i w_i` (`load_data.py:100-121`), and per-day rolling
windows (`load_data.py:130-137`).

Device-first re-architecture: the reference's dict-of-dicts of per-ticker
arrays becomes ONE dense (T, N, dim) rolling-window tensor handed to the
device — `windows[t] = returns[t : t + N] - in_sample_mean` — which the
model adapters vmap over. The yfinance network edge is optional and gated
(`from_yfinance`); CSV / ndarray / synthetic sources cover offline use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass(frozen=True)
class ReturnsData:
    """Aligned daily returns plus the in-sample/out-of-sample split.

    returns: (M, dim) float64 — demeaning NOT applied (raw log-returns x100)
    tickers: column labels
    n_insample: N, the in-sample length
    weights: (dim,) portfolio weights
    dates: optional (M,) array of labels (np.datetime64 or str)
    """

    returns: np.ndarray
    tickers: List[str]
    n_insample: int
    weights: np.ndarray
    dates: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.returns.ndim != 2:
            raise ValueError("returns must be (M, dim)")
        if self.returns.shape[1] != len(self.tickers):
            raise ValueError("tickers must match returns columns")
        if len(self.weights) != self.returns.shape[1]:
            raise ValueError("weights must match returns columns")
        if len(self.returns) < self.n_insample:
            raise ValueError(
                f"Not enough returns for in-sample estimation. "
                f"Required: {self.n_insample}, Available: {len(self.returns)}"
            )

    # -- reference `get_insample_data` equivalents -------------------------

    @property
    def dim(self) -> int:
        return self.returns.shape[1]

    @property
    def out_sample_n(self) -> int:
        """T: number of out-of-sample days (`load_data.py:127`)."""
        return len(self.returns) - self.n_insample

    @property
    def in_sample_mean(self) -> np.ndarray:
        """(dim,) in-sample means (`load_data.py:110`)."""
        return self.returns[: self.n_insample].mean(axis=0)

    @property
    def ptf_mean(self) -> float:
        """sum_i mean_i w_i (`load_data.py:113`)."""
        return float(np.sum(self.in_sample_mean * self.weights))

    @property
    def in_sample(self) -> np.ndarray:
        """(N, dim) demeaned in-sample returns (`load_data.py:116-118`)."""
        return self.returns[: self.n_insample] - self.in_sample_mean

    @property
    def out_sample(self) -> np.ndarray:
        """(T, dim) raw out-of-sample returns (`load_data.py:124`)."""
        return self.returns[self.n_insample :]

    def rolling_windows(self) -> np.ndarray:
        """(T, N, dim) demeaned rolling windows: window t covers returns
        [t, t + N) — window t's last row is out-of-sample day t's previous
        trading day (`load_data.py:130-137`). All windows are demeaned by
        the fixed in-sample mean, as in the reference."""
        T, N, d = self.out_sample_n, self.n_insample, self.dim
        idx = np.arange(N)[None, :] + np.arange(T)[:, None]
        return self.returns[idx] - self.in_sample_mean[None, None, :]

    def portfolio_out_sample(self) -> np.ndarray:
        """(T,) realized portfolio returns under `self.weights` — the
        series the solved VaR applies to. (The reference's comparison plot
        uses an unweighted mean across assets, `main.py:73`, which only
        matches its VaR for equal weights; using the actual weights here
        keeps exception statistics consistent for any weighting.)"""
        return self.out_sample @ self.weights


def from_returns(returns, tickers=None, n_insample=None, weights=None, dates=None) -> ReturnsData:
    """Build from an (M, dim) array of (already x100 log-)returns."""
    returns = np.asarray(returns, dtype=float)
    m, d = returns.shape
    if tickers is None:
        tickers = [f"asset_{i}" for i in range(d)]
    if n_insample is None:
        n_insample = m // 2
    if weights is None:
        weights = np.full(d, 1.0 / d)
    return ReturnsData(returns, list(tickers), int(n_insample),
                       np.asarray(weights, dtype=float), dates)


def from_prices(prices, tickers=None, n_insample=None, weights=None, dates=None) -> ReturnsData:
    """(M+1, dim) adjusted closes -> daily log-returns x 100
    (`load_data.py:59-66`)."""
    prices = np.asarray(prices, dtype=float)
    rets = np.log(prices[1:] / prices[:-1]) * 100.0
    if dates is not None:
        dates = np.asarray(dates)[1:]
    return from_returns(rets, tickers, n_insample, weights, dates)


def from_csv(path, n_insample, weights=None, date_column=None) -> ReturnsData:
    """CSV of adjusted closes (columns = tickers). Any column named
    `date_column` (default: first non-numeric) becomes the date index.
    Rows with an empty or NaN price are dropped."""
    import csv

    with open(path, newline="") as f:
        header, *rows = [r for r in csv.reader(f) if r]
    cols = {name: [r[i] for r in rows] for i, name in enumerate(header)}

    def as_float(values):
        try:
            return np.array([float(v) if v.strip() else np.nan
                             for v in values])
        except ValueError:
            return None

    numeric = {name: as_float(v) for name, v in cols.items()}
    if date_column is None:
        date_column = next(
            (name for name in header if numeric[name] is None), None
        )
    tickers = [name for name in header if name != date_column]
    for name in tickers:
        if numeric[name] is None:
            raise ValueError(f"{path}: column {name!r} is not numeric")
    prices = np.column_stack([numeric[name] for name in tickers])
    keep = ~np.isnan(prices).any(axis=1)
    dates = (np.asarray(cols[date_column], dtype=object)[keep]
             if date_column is not None else None)
    return from_prices(prices[keep], tickers, n_insample, weights, dates)


def from_yfinance(tickers, start_date, n_insample, weights=None, end_date=None) -> ReturnsData:
    """Reference-equivalent network path (`load_data.py:42-66`): yfinance
    Adj Close -> dropna -> log-returns x 100 -> sort by date -> dropna.
    Gated: raises a clear error when yfinance is unavailable (offline
    images)."""
    try:
        import yfinance as yf
    except ImportError as e:  # pragma: no cover - environment dependent
        raise ImportError(
            "yfinance is not installed; use from_csv / from_returns / "
            "synthetic_dataset for offline data"
        ) from e
    data = yf.download(tickers, start=start_date, end=end_date)["Adj Close"]
    data = data.dropna().sort_index()
    rets = (np.log(data / data.shift(1)).dropna() * 100.0)
    return from_returns(
        rets.to_numpy(), list(rets.columns), n_insample, weights,
        rets.index.to_numpy(),
    )


def synthetic_dataset(
    key,
    n_total: int,
    n_insample: int,
    spec=("garch", "garch"),
    weights=None,
) -> ReturnsData:
    """Seeded multi-asset synthetic dataset for offline end-to-end runs.

    spec: tuple of per-asset model names: 'garch' (omega .02, alpha .08,
    beta .9 — unit unconditional variance), 'msm' (k=4, m0 .4, sigma 1.0,
    b 3, gamma .5), or 'ou' (a .95, l -0.2, q .2). Assets are simulated
    independently (dependence in the backtest then comes from the copula
    under test). Parameters are calibrated to vol ~ 1 because the
    quadrature box is [-5, 5] in return units (`calc_var_class.py:201-202`)
    — the reference's convention for demeaned daily log-returns x 100.
    """
    import jax

    from copula_var.models import garch as garch_mod
    from copula_var.models import msm as msm_mod
    from copula_var.models import ukf as ukf_mod

    keys = jax.random.split(key, len(spec))
    cols = []
    for s, k in zip(spec, keys):
        if s == "garch":
            y, _, _ = garch_mod.simulate(k, 0.02, [0.08], [0.9], n_total)
        elif s == "msm":
            y, _, _, _ = msm_mod.simulate(k, 4, 0.4, 1.0, 3.0, 0.5, n_total)
        elif s == "ou":
            _, _, y = ukf_mod.simulate(k, 0.95, -0.2, 0.2, n_total)
        else:
            raise ValueError(f"unknown synthetic asset spec: {s}")
        cols.append(np.asarray(y))
    rets = np.stack(cols, axis=1)
    return from_returns(rets, [f"{s}_{i}" for i, s in enumerate(spec)],
                        n_insample, weights)
