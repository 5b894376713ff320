"""Multi-host (DCN) initialization smoke test: 2 CPU processes.

Exercises `parallel/distributed.py` for real: two subprocesses join a
jax.distributed cluster over a localhost coordinator, build the global
mesh spanning both processes' devices, and run ONE jitted cross-process
reduction — the minimal analog of the multi-host launch recipe
(SURVEY.md §2.10):

    # per host
    distributed.initialize(coordinator_address="<host0>:<port>",
                           num_processes=N, process_id=i)
    mesh = make_mesh()           # spans all processes' devices
    ... engine='sharded' / sharded_bisection_solve over that mesh ...

Skips (with this recipe) only if the jaxlib in the image cannot start the
distributed runtime on CPU; any numerical mismatch is a hard failure.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent(
    """
    import os, sys
    port, pid = sys.argv[1], int(sys.argv[2])
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("XLA_FLAGS", None)  # exactly one local CPU device
    sys.path.insert(0, sys.argv[3])
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    from copula_var.parallel import distributed, make_mesh
    try:
        distributed.initialize(
            coordinator_address=f"127.0.0.1:{port}",
            num_processes=2, process_id=pid,
        )
    except Exception as e:  # runtime unavailable in this image
        print("INIT_FAILED", type(e).__name__, e, flush=True)
        sys.exit(3)
    info = distributed.process_info()
    assert info["process_count"] == 2, info
    assert info["global_device_count"] == 2, info
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = make_mesh()
    sharding = NamedSharding(mesh, P("days"))
    data = np.array([1.5, 2.5])
    arr = jax.make_array_from_callback((2,), sharding, lambda idx: data[idx])
    # jnp.sum over a cross-process-sharded array -> XLA inserts the
    # cross-host all-reduce (the DCN collective path)
    out = jax.jit(jnp.sum)(arr)
    print("RESULT", float(out), flush=True)

    # the PRODUCTION day-sharded bisection across both processes: T=4
    # days, 2 per host; the while_loop's convergence reduction rides the
    # cross-process collective. Each process checks its local shards
    # against a single-process f64 reference computed independently.
    from copula_var.ops.grids import garch_grid
    from copula_var.ops.quadrature import (
        CopulaSpec, garch_day_tensors, garch_integrals_cached,
    )
    from copula_var.parallel import sharded_bisection_solve
    rng = np.random.default_rng(0)
    T, n = 4, 24
    x, dx = garch_grid(n)
    fv = rng.uniform(0.7, 1.4, size=(T, 2))
    corr = np.array([[1.0, 0.45], [0.45, 1.0]])
    spec = CopulaSpec("gaussian", (jnp.asarray(corr),))
    w = np.array([0.5, 0.5])
    V = garch_day_tensors(fv, x, spec)
    entry_up = rng.uniform(-3.0, -1.0, size=T)
    prev = np.asarray(garch_integrals_cached(
        np.column_stack([np.full(T, -100.0), entry_up]), V, x, dx, w))
    roots = sharded_bisection_solve(
        mesh, V, None, None, x, dx, w,
        np.full(T, -7.5), np.full(T, 0.0), prev, entry_up,
        np.ones(T, dtype=bool), 0.05, 1e-6,
    )
    # cross-process the solver returns host-REPLICATED roots (one DCN
    # all-gather inside, parallel/multiprocess.fetch): every process
    # checks the full series
    roots = np.asarray(roots)
    assert roots.shape == (T,), roots.shape
    local = {0: roots}
    # single-process reference bisection (host loop, same math)
    lo, up = np.full(T, -7.5), np.full(T, 0.0)
    pr, pu, us = prev.copy(), entry_up.copy(), np.ones(T, dtype=bool)
    while np.any(up - lo > 1e-6):
        mid = 0.5 * (lo + up)
        b = np.where(us[:, None], np.column_stack([lo, mid]),
                     np.column_stack([mid, up]))
        mres = np.asarray(garch_integrals_cached(b, V, x, dx, w))
        res = np.where(b[:, 0] == pu, pr + mres, pr - mres)
        us = res < 0.05
        lo = np.where(us, mid, lo)
        up = np.where(us, up, mid)
        pr, pu = res, mid
    want = 0.5 * (lo + up)
    for start, vals in local.items():
        assert np.allclose(vals, want[start:start + len(vals)], atol=1e-6), (
            start, vals, want)
    print("SOLVE_OK", flush=True)

    # the FULL user-facing orchestrator across the 2-process mesh
    # (VERDICT r02 #8): VaRBacktest(engine='sharded') with injected model/
    # copula params, compared against an independent single-device
    # engine='xla' solve in the same process. Exercises put_global /
    # fetch (parallel/multiprocess.py) through every solver stage.
    from copula_var.backtest import MsmAdapter, VaRBacktest
    from copula_var.copulas.fit import StudentFit
    from copula_var.data.returns import from_returns
    from copula_var.models.fit import MsmFit
    rng2 = np.random.default_rng(1)
    N, T2 = 60, 6
    rets = rng2.multivariate_normal(np.zeros(2), corr, size=N + T2)
    data = from_returns(rets, ["A", "B"], N, np.array([0.5, 0.5]))
    fits = [MsmFit(m_0=0.45, b=3.0, gamma=0.5, sigma=1.0, log_likelihood=0.0),
            MsmFit(m_0=0.55, b=5.0, gamma=0.3, sigma=0.9, log_likelihood=0.0)]
    cfit = StudentFit(6.0, corr, 0.0, np.array([6.0, 0.45]))
    bt = VaRBacktest(data, MsmAdapter(k=2), "student", num_points=24,
                     model_fits_override=fits, copula_fit_override=cfit,
                     engine="sharded", mesh=mesh)
    var_sharded = np.asarray(bt.calc_var(0.05))
    bt_x = VaRBacktest(data, MsmAdapter(k=2), "student", num_points=24,
                       model_fits_override=fits, copula_fit_override=cfit,
                       engine="xla")
    var_x = np.asarray(bt_x.calc_var(0.05))
    assert var_sharded.shape == (T2,), var_sharded.shape
    assert np.allclose(var_sharded, var_x, atol=1e-6), (var_sharded, var_x)
    print("ORCH_OK", flush=True)
    """
)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_psum(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(port), str(i), REPO],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
        outs.append((p.returncode, out))
    if any(rc == 3 for rc, _ in outs):
        pytest.skip(
            "jax.distributed runtime unavailable on CPU in this image; "
            "launch recipe documented in this test's docstring. Worker "
            f"output: {outs}"
        )
    for rc, out in outs:
        assert rc == 0, out
        assert "RESULT 4.0" in out, out
        assert "SOLVE_OK" in out, out
        assert "ORCH_OK" in out, out
