"""Masked-sandwich sweep HBM stream efficiency (VERDICT r02 #5).

Device-only per-sweep time via K-sweep differential timing: a lax.scan
runs K full-T sweeps in ONE launch; the slope between K=K_LO and K=K_HI
cancels launch overhead. Reported as effective GB/s against the
bytes each sweep must stream (the (T, n, n) day tensors, read once).

Engine measured: the XLA cached scan (f64 and f32),
`msm_integrals_cached` — the select materializes the masked operand, so
actual traffic is ~3x the tensor bytes (read C + write vm + matmul
re-read).

Usage: python benchmarks/sweep_bandwidth.py [--days 500] [--points 100]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

K_LO, K_HI = 8, 40


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=int, default=500)
    ap.add_argument("--points", type=int, default=100)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax

    # a REAL f64 row requires x64 (otherwise jnp.asarray silently
    # downcasts and the 'f64' engine measures an identical f32 program)
    jax.config.update("jax_enable_x64", True)

    from copula_var.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    import jax.numpy as jnp

    from copula_var.ops.grids import msm_grid
    from copula_var.ops.quadrature import (
        CopulaSpec,
        _msm_day_tensors,
        msm_integrals_cached,
    )

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
    spec = CopulaSpec("student", (6.0, corr))
    w = np.array([0.5, 0.5])
    C = _msm_day_tensors(jnp.asarray(fbs), jnp.asarray(x),
                         jnp.asarray(uvols), spec.kind, spec.params)

    def bounds_stack(k):
        return jnp.asarray(np.stack([
            np.column_stack([np.full(T, -100.0),
                             rng.uniform(-4.0, -1.0, size=T)])
            for _ in range(k)
        ]))

    def slope(fn, tag, bytes_per_sweep):
        try:
            return _slope(fn, tag, bytes_per_sweep)
        except Exception as e:  # report the failing engine, keep going
            print(f"{tag:>28s}: FAILED ({type(e).__name__}: {str(e)[:90]})")
            return None, None

    def _slope(fn, tag, bytes_per_sweep):
        def scan_k(bs):
            import jax.numpy as jnp

            def body(acc, b):
                return acc + jnp.sum(fn(b)), None

            return jax.lax.scan(body, 0.0, bs)[0]

        scan_j = jax.jit(scan_k)
        ts = {}
        for k in (K_LO, K_HI):
            bs = bounds_stack(k)
            float(scan_j(bs))  # compile + warm
            best = np.inf
            for _ in range(args.reps):
                t0 = time.time()
                float(scan_j(bs))
                best = min(best, time.time() - t0)
            ts[k] = best
        per_sweep = (ts[K_HI] - ts[K_LO]) / (K_HI - K_LO)
        if per_sweep <= 0:
            print(f"{tag:>28s}: (noise-dominated: t(K={K_HI}) <= t(K={K_LO}) "
                  "— slope below environment jitter, discard this run)")
            return None, None
        gbps = bytes_per_sweep / per_sweep / 1e9
        print(f"{tag:>28s}: {per_sweep * 1e3:7.3f} ms/sweep  "
              f"{T / per_sweep:12.0f} int/s  {gbps:6.1f} GB/s effective")
        return per_sweep, gbps

    platform = jax.devices()[0].platform
    print(f"# platform={platform} T={T} n={n} q={q} "
          f"tensor={T * n * n * 4 / 1e6:.0f} MB f32 / "
          f"{T * n * n * 8 / 1e6:.0f} MB f64")

    C64 = jnp.asarray(C)
    slope(lambda b: msm_integrals_cached(b, C64, fcombos, x, dx, dens, w),
          "xla cached scan f64", T * n * n * 8)
    C32 = jnp.asarray(C, jnp.float32)
    d32 = jnp.asarray(dens, jnp.float32)
    x32 = jnp.asarray(x, jnp.float32)
    dx32 = jnp.asarray(dx, jnp.float32)
    w32 = jnp.asarray(w, jnp.float32)
    fc32 = jnp.asarray(fcombos, jnp.float32)
    slope(lambda b: msm_integrals_cached(jnp.asarray(b, jnp.float32), C32, fc32, x32, dx32, d32, w32),
          "xla cached scan f32", T * n * n * 4)


if __name__ == "__main__":
    main()
