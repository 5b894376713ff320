"""Multi-process (multi-host DCN) array placement and retrieval.

The sharded engine's host<->device edges use two primitives that differ
between single-process (everything addressable) and multi-process
(each process addresses only its local devices) execution:

  * `put_global(arr, sharding)` — place a host array under a sharding
    that may span other processes' devices. Single-process this is
    `jax.device_put`; multi-process each process contributes only its
    addressable shards via `jax.make_array_from_callback` (every process
    holds the full host copy — the orchestrator's host stages run
    identically on all processes, the SPMD analog of the reference's
    single driver process).
  * `fetch(arr)` — `np.asarray` for a possibly cross-process-sharded
    device array: a `process_allgather` (one DCN all-gather) when the
    array is not fully addressable, a plain transfer otherwise.

These are what let the user-facing `VaRBacktest(engine='sharded')`
orchestrator run unmodified across a `jax.distributed` cluster
(`tests/test_distributed.py` proves it on a real 2-process mesh).
"""

from __future__ import annotations

import jax
import numpy as np


def put_global(arr, sharding):
    """Place a (fully replicated) host array under `sharding`, which may
    span devices of other processes. An input that is ALREADY a global
    (non-fully-addressable) device array is passed through — it cannot be
    round-tripped via the host, and the orchestrator hands the solver its
    pre-sharded day tensors on exactly this path."""
    if isinstance(arr, jax.Array):
        try:
            if arr.sharding.is_equivalent_to(sharding, arr.ndim):
                # already placed as requested — a device_put here would
                # re-place ~20 MB of day tensors for nothing
                return arr
        except Exception:
            pass
    if jax.process_count() == 1:
        # hand numpy straight to device_put: a jnp.asarray here would
        # first commit the host array to the default device, adding an
        # extra placement + reshard hop
        if not isinstance(arr, (np.ndarray, jax.Array)):
            arr = np.asarray(arr)
        return jax.device_put(arr, sharding)
    if isinstance(arr, jax.Array) and not arr.is_fully_addressable:
        return jax.device_put(arr, sharding)
    host = np.asarray(arr)
    return jax.make_array_from_callback(
        host.shape, sharding, lambda idx: host[idx]
    )


def fetch(arr):
    """Materialize a device array on the host, all-gathering shards held
    by other processes when necessary. Returns np.ndarray."""
    if getattr(arr, "is_fully_addressable", True):
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))
