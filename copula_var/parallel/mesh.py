"""Device-mesh construction for the sharded quadrature engine.

The reference's only parallel axes are process pools over out-of-sample
days and optimizer restarts (SURVEY.md §2.10). Device-native replacement: a
1-D (or 2-D) `jax.sharding.Mesh` whose 'days' axis carries the
embarrassingly-parallel time batch and whose optional 'grid' axis shards
the quadrature grid with `psum` partial reductions. The cards of a host
are joined all to all, so the mesh follows the algorithm alone: devices
in `jax.devices()` order.

Multi-host: call `jax.distributed.initialize()` before `make_mesh()` and
the mesh spans all processes' devices (DCN joins slices; XLA places the
collectives)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("days",),
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a mesh over the first n_devices (default: all).

    axis_names ('days',) gives a 1-D data-parallel mesh; pass
    ('days', 'grid') with `shape` for a 2-D mesh that also shards the grid
    axis."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} visible "
                "(for CPU testing set "
                "XLA_FLAGS=--xla_force_host_platform_device_count=N)"
            )
        devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    arr = np.array(devs).reshape(shape)
    return Mesh(arr, axis_names)
