"""Multi-host initialization for runs that span several hosts.

The reference has no distributed backend at all (SURVEY.md §2.10); the
device-native equivalent is `jax.distributed.initialize` + a mesh spanning
every process's devices. This module is the thin, test-friendly entry:

    from copula_var.parallel import distributed
    distributed.initialize()          # no-op on single-host
    mesh = make_mesh()                # spans every process's devices

Nothing detects a GPU cluster by itself: pass coordinator_address
(`host:port`), num_processes and process_id explicitly.
"""

from __future__ import annotations

from typing import Optional

import jax

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed once; silently no-op when single-host
    and no explicit coordinator is given."""
    global _initialized
    if _initialized:
        return
    if coordinator_address is None and num_processes in (None, 1):
        # single-host: nothing to do
        _initialized = True
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    _initialized = True


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_device_count": jax.local_device_count(),
        "global_device_count": jax.device_count(),
    }
