"""parallel/multiprocess put_global / fetch — single-process semantics.

(The cross-process semantics are proven by the real 2-process cluster in
tests/test_distributed.py; these tests pin the single-process fast paths
every engine call goes through.)
"""

import numpy as np

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from copula_var.parallel import make_mesh
from copula_var.parallel.multiprocess import fetch, put_global


def test_put_global_places_and_fetch_roundtrips():
    mesh = make_mesh()
    sharding = NamedSharding(mesh, P("days"))
    a = np.arange(16.0).reshape(16, 1)
    arr = put_global(a, sharding)
    assert arr.sharding.is_equivalent_to(sharding, a.ndim)
    np.testing.assert_array_equal(fetch(arr), a)


def test_fetch_plain_numpy_passthrough():
    a = np.arange(4.0)
    np.testing.assert_array_equal(fetch(a), a)


def test_put_global_passthrough_for_device_arrays():
    mesh = make_mesh()
    sharding = NamedSharding(mesh, P("days"))
    a = put_global(np.arange(8.0), sharding)
    b = put_global(a, sharding)  # already placed: no host round trip
    np.testing.assert_array_equal(fetch(b), np.arange(8.0))


def test_factory_forwards_fit_overrides():
    """create_var_backtest passes model/copula fit overrides through to
    VaRBacktest (the shared-cache injection path the 3x3 harness and
    artifact resume rely on)."""
    from copula_var.backtest import create_var_backtest
    from copula_var.copulas.fit import StudentFit
    from copula_var.data.returns import from_returns
    from copula_var.models.fit import GarchFit

    rng = np.random.default_rng(3)
    corr = np.array([[1.0, 0.4], [0.4, 1.0]])
    rets = rng.multivariate_normal(np.zeros(2), corr, size=46)
    data = from_returns(rets, ["A", "B"], 40, np.array([0.5, 0.5]))
    fits = [
        GarchFit(p=1, q=1, omega=0.05, alpha=np.array([0.08]),
                 beta=np.array([0.85]), nll=0.0, bic=0.0,
                 params=np.array([0.05, 0.08, 0.85])),
        GarchFit(p=1, q=1, omega=0.08, alpha=np.array([0.1]),
                 beta=np.array([0.8]), nll=0.0, bic=0.0,
                 params=np.array([0.08, 0.1, 0.8])),
    ]
    cfit = StudentFit(6.0, corr, 0.0, np.array([6.0, 0.4]))
    bt = create_var_backtest(
        data, "garch", "student", num_points=16,
        model_fits_override=fits, copula_fit_override=cfit,
    )
    assert bt.model_fits is fits
    assert bt.copula_fit is cfit
    var = bt.calc_var(0.05)
    assert var.shape == (6,) and np.all(np.isfinite(var))
