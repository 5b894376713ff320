"""Import harness for running the reference implementation as a golden oracle.

The reference at /root/reference is pure Python + numba `@njit`. numba is not
installed in this image, so we substitute a passthrough decorator: every njit
kernel then runs as plain Python/numpy, producing the exact values the compiled
version would (numba compiles the same semantics). Tests import reference
modules through `ref(name)` and compare our kernels against them at f64.

This module never copies reference code — it executes it in place, read-only.
"""

import sys
import types

REFERENCE_ROOT = "/root/reference"


def _install_numba_stub():
    if "numba" in sys.modules:
        return
    fake = types.ModuleType("numba")

    def njit(*args, **kwargs):
        if len(args) == 1 and callable(args[0]):
            return args[0]

        def deco(fn):
            return fn

        return deco

    fake.njit = njit
    fake.jit = njit
    fake.prange = range
    sys.modules["numba"] = fake


def _install_yfinance_stub():
    """The reference's data layer imports yfinance at module level
    (`load_data.py:3`); tests inject data through the returns cache and
    never hit the network, so a raising stub suffices offline."""
    if "yfinance" in sys.modules:
        return
    fake = types.ModuleType("yfinance")

    def download(*args, **kwargs):  # pragma: no cover - guard only
        raise RuntimeError(
            "network access not available in tests; prefill "
            "SharedCacheIndexReturns.returns_cache instead"
        )

    fake.download = download
    sys.modules["yfinance"] = fake


def ref(module_name: str):
    """Import a module from the reference tree (e.g. 'garch.estimation').
    Called inside a test; skips that test when the tree is absent."""
    import os

    import pytest

    if not os.path.isdir(REFERENCE_ROOT):
        pytest.skip(f"reference tree {REFERENCE_ROOT} not present")
    _install_numba_stub()
    _install_yfinance_stub()
    if REFERENCE_ROOT not in sys.path:
        sys.path.insert(0, REFERENCE_ROOT)
    import importlib

    return importlib.import_module(module_name)
