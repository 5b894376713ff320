"""Checkpoint / resume: explicit precompute artifacts on disk.

The reference has no persistence — only in-memory dict caches with a
known read/write key mismatch (`garch_estimation.py:211-221`,
SURVEY.md §5). Here the expensive precompute stage (fitted model params,
copula fit, per-day integration inputs) serializes to one `.npz` so a
backtest can resume straight into the VaR solve.
"""

from __future__ import annotations

import json

import numpy as np

_FORMAT_VERSION = 1


def save_artifacts(path: str, backtest) -> None:
    """Serialize a constructed VaRBacktest's precompute state."""
    ii = backtest.integration_inputs
    meta = {
        "version": _FORMAT_VERSION,
        "copula": backtest.copula,
        "adapter": backtest.adapter.name,
        "num_points": backtest.num_points,
        "box": list(getattr(backtest, "box", (-5.0, 5.0))),
        "inputs_kind": type(ii).__name__,
        "model_fits": [
            {k: np.asarray(v).tolist() for k, v in f._asdict().items()}
            for f in backtest.model_fits
        ],
        "fit_type": type(backtest.model_fits[0]).__name__,
        "copula_fit": {
            k: np.asarray(v).tolist()
            for k, v in backtest.copula_fit._asdict().items()
        },
        "copula_fit_type": type(backtest.copula_fit).__name__,
    }
    arrays = {f"ii_{k}": np.asarray(v) for k, v in ii._asdict().items()}
    arrays["marginals"] = backtest.marginals
    arrays["densities"] = backtest.densities
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load_artifacts(path: str, data, adapter=None):
    """Rebuild a solve-ready VaRBacktest from saved artifacts + the same
    ReturnsData (skips model fitting, copula fitting, and the
    integration-input precompute)."""
    import jax.numpy as jnp

    from copula_var import backtest as bt_mod
    from copula_var.copulas import fit as copula_fit_mod
    from copula_var.models import fit as model_fit_mod

    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"artifact version {meta['version']} unsupported")

    if adapter is None:
        adapter = bt_mod._ADAPTERS[meta["adapter"]]()

    bt = bt_mod.VaRBacktest.__new__(bt_mod.VaRBacktest)
    bt.data = data
    bt.adapter = adapter
    bt.copula = meta["copula"]
    bt.num_points = meta["num_points"]
    bt.box = tuple(meta.get("box", (-5.0, 5.0)))
    bt.copula_fit_kwargs = None

    fit_cls = getattr(model_fit_mod, meta["fit_type"])
    bt.model_fits = [
        fit_cls(**{k: _restore(v) for k, v in f.items()})
        for f in meta["model_fits"]
    ]
    cfit_cls = getattr(copula_fit_mod, meta["copula_fit_type"])
    bt.copula_fit = cfit_cls(
        **{k: _restore(v) for k, v in meta["copula_fit"].items()}
    )
    bt.copula_spec = bt_mod._copula_spec(bt.copula, bt.copula_fit)

    inputs_cls = getattr(bt_mod, meta["inputs_kind"])
    # staged on-device once, as VaRBacktest construction does
    bt.integration_inputs = inputs_cls(
        **{k: jnp.asarray(z[f"ii_{k}"]) for k in inputs_cls._fields}
    )
    bt.marginals = z["marginals"]
    bt.densities = z["densities"]
    bt.prep_seconds = 0.0
    return bt


def _restore(v):
    arr = np.asarray(v)
    if arr.ndim == 0:
        return arr.item()
    return arr
