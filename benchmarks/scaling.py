"""Scaling-efficiency harness (BASELINE.md protocol item 2).

Measures day-sharded cached-sweep throughput vs device count on whatever
mesh is available — the GPUs of the host, or the virtual CPU mesh
(`XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu`)
for correctness-of-scaling tests. Multi-host: initialize
`copula_var.parallel.distributed` first and the mesh spans all
processes.

Usage: python benchmarks/scaling.py [--points 100] [--days 512]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=100)
    ap.add_argument("--days", type=int, default=512)
    ap.add_argument("--sweeps", type=int, default=8)
    args = ap.parse_args()

    import jax

    from copula_var.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    import jax.numpy as jnp

    from copula_var.ops.grids import msm_grid
    from copula_var.ops.quadrature import CopulaSpec, msm_day_tensors
    from copula_var.parallel import make_mesh, sharded_cached_step

    rng = np.random.default_rng(0)
    dim, q, n, T = 2, 5, args.points, args.days
    uvols = np.sort(rng.uniform(0.4, 1.8, size=(dim, q)), axis=1)
    x, dx = msm_grid(n)
    dens = np.exp(-0.5 * (x[None, None, :] / uvols[:, :, None]) ** 2) / (
        np.sqrt(2 * np.pi) * uvols[:, :, None]
    )
    fbs = rng.uniform(0.1, 1.0, size=(T, dim, q))
    fbs /= fbs.sum(axis=2, keepdims=True)
    fcombos = np.einsum("ti,tj->tij", fbs[:, 0], fbs[:, 1]).reshape(T, -1)
    corr = np.array([[1.0, 0.45], [0.45, 1.0]])
    spec = CopulaSpec("student", (6.0, jnp.asarray(corr)))
    C = msm_day_tensors(fbs, x, uvols, spec)

    if jax.devices()[0].platform == "cpu":
        print("NOTE: virtual CPU mesh — devices share physical cores, so "
              "multi-device rates only validate correctness, not scaling.")
    n_avail = len(jax.devices())
    counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n_avail and T % c == 0]
    base_rate = None
    for nd in counts:
        mesh = make_mesh(n_devices=nd)
        bounds = np.column_stack(
            [np.full(T, -100.0), rng.uniform(-4.0, -1.0, size=T)]
        )
        # warm-up
        np.asarray(
            sharded_cached_step(mesh, bounds, C, fcombos, x, dx, dens,
                                np.array([0.5, 0.5]))
        )
        times = []
        for _ in range(args.sweeps):
            b = np.column_stack(
                [np.full(T, -100.0), rng.uniform(-4.0, -1.0, size=T)]
            )
            t0 = time.time()
            np.asarray(
                sharded_cached_step(mesh, b, C, fcombos, x, dx, dens,
                                    np.array([0.5, 0.5]))
            )
            times.append(time.time() - t0)
        dt = min(times)
        rate = T / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd)
        print(
            f"devices={nd:3d}  {rate:12.0f} integrals/s  "
            f"scaling-efficiency={eff:5.2f}"
        )


if __name__ == "__main__":
    main()
