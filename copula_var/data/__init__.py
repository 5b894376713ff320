from copula_var.data.returns import (
    ReturnsData,
    from_prices,
    from_returns,
    from_csv,
    from_yfinance,
    synthetic_dataset,
)

__all__ = [
    "ReturnsData",
    "from_prices",
    "from_returns",
    "from_csv",
    "from_yfinance",
    "synthetic_dataset",
]
