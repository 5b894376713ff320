"""Generate the pinned flagship dataset `data/flagship.csv`.

The reference's actual deliverable is two backtests on ^GSPC/^IXIC
adjusted closes 2009-04-15 -> 2015-10-12 downloaded via yfinance
(`/root/reference/main.py:23-75`, `data_loader/load_data.py:59-66`).
This build environment has no network, and the reference repo ships no
data files, so the flagship configuration is pinned against a
DETERMINISTIC SYNTHETIC STAND-IN with the same schema and shape:

  * 1,636 business-day adjusted closes from 2009-04-15 (-> 1,635 daily
    log-returns x 100: N = 1135 in-sample + T = 500 out-of-sample days,
    the reference's `main.py:25-33` split);
  * two large-cap-index-like series (upward drift ~0.05%/day, daily vol
    ~1-1.3%, GARCH(1,1) volatility clustering with different (alpha,
    beta) per asset, cross-correlation ~0.9 via a common factor — the
    empirical profile of S&P 500 / NASDAQ over that window).

Deterministic: seeded PRNG, pure numpy. Re-running this script must
reproduce `data/flagship.csv` byte-for-byte (asserted by the flagship
test when the file exists).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_PRICES = 1636  # -> 1635 returns = 1135 in-sample + 500 out-of-sample
START = "2009-04-15"
COLUMNS = ("GSPC_SYN", "IXIC_SYN")


def flagship_prices():
    rng = np.random.default_rng(20090415)
    n = N_PRICES - 1
    # common + idiosyncratic gaussian factors: corr ~ 0.9
    z_c = rng.standard_normal(n)
    z_i = rng.standard_normal((2, n))
    lam = np.sqrt(0.9)
    eps = lam * z_c[None, :] + np.sqrt(1.0 - lam**2) * z_i

    params = [  # omega, alpha, beta, mu (returns in x100 units)
        (0.020, 0.085, 0.895, 0.045),   # GSPC-like: vol ~1.0%
        (0.030, 0.095, 0.885, 0.055),   # IXIC-like: vol ~1.25%
    ]
    rets = np.zeros((2, n))
    for a, (om, al, be, mu) in enumerate(params):
        var = om / (1.0 - al - be)
        r2_prev, v_prev = var, var
        for t in range(n):
            v = om + al * r2_prev + be * v_prev
            r = np.sqrt(v) * eps[a, t]
            rets[a, t] = mu + r
            r2_prev, v_prev = r * r, v
    prices = 100.0 * np.exp(np.cumsum(
        np.concatenate([np.zeros((2, 1)), rets / 100.0], axis=1), axis=1
    ))
    return prices.T  # (N_PRICES, 2)


def write_flagship_csv(prices, dates, columns, path):
    """Write the committed flagship schema: a `date` column (ISO) plus
    one adjusted-close column per ticker, prices rounded to 6 decimals.
    `copula_var.data.from_csv(path, n_insample=1135)` consumes it
    directly (schema round-trip asserted by tests/test_flagship.py)."""
    import pandas as pd

    df = pd.DataFrame({"date": dates})
    for i, c in enumerate(columns):
        df[c] = np.round(np.asarray(prices)[:, i], 6)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    df.to_csv(path, index=False)
    rets = np.log(np.asarray(prices)[1:] / np.asarray(prices)[:-1]) * 100.0
    print(f"wrote {path}: {len(df)} rows, columns {list(columns)}")
    print(f"  daily ret mean {rets.mean(axis=0).round(4)} "
          f"std {rets.std(axis=0).round(3)} "
          f"corr {np.corrcoef(rets.T)[0, 1]:.3f}")
    return df


def real_flagship_prices():
    """The REFERENCE's actual dataset (`data_loader/load_data.py:59-66`):
    ^GSPC/^IXIC adjusted closes from 2009-04-15 through 2015-10-12,
    downloaded via yfinance. Gated: this build image has no network, so
    the call raises a clear error offline — when network exists, this is
    the one command that swaps the synthetic stand-in for the real
    window (README 'Real-data drill')."""
    try:
        import yfinance as yf
    except ImportError as e:
        raise RuntimeError(
            "the real flagship dataset needs the yfinance package and "
            "network access (this environment has neither); the pinned "
            "synthetic stand-in is the offline default"
        ) from e
    try:
        px = yf.download(
            ["^GSPC", "^IXIC"], start="2009-04-15", end="2015-10-13",
            auto_adjust=False,
        )["Adj Close"]
        px = px[["^GSPC", "^IXIC"]].dropna()
    except Exception as e:
        raise RuntimeError(
            f"yfinance download failed (network required): {e}"
        ) from e
    return (px.to_numpy(), px.index.strftime("%Y-%m-%d").tolist(),
            ("GSPC", "IXIC"))


def main(argv=None):
    import argparse

    import pandas as pd

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", nargs="?", default="data/flagship.csv")
    ap.add_argument(
        "--from-yfinance", action="store_true",
        help="download the REAL ^GSPC/^IXIC window (needs network) "
             "instead of generating the pinned synthetic stand-in; "
             "afterwards re-run `python examples/flagship.py` to re-pin "
             "the VaR hashes/stats/plot on the real data",
    )
    args = ap.parse_args(argv)
    if args.from_yfinance:
        prices, dates, columns = real_flagship_prices()
        write_flagship_csv(prices, dates, columns, args.path)
        return
    prices = flagship_prices()
    dates = pd.bdate_range(START, periods=N_PRICES).strftime("%Y-%m-%d")
    write_flagship_csv(prices, list(dates), COLUMNS, args.path)


if __name__ == "__main__":
    main()
