"""Test harness configuration.

Forces JAX onto a virtual 8-device CPU mesh and enables x64 so golden
parity tests run at f64 tolerance, per the baseline protocol. Must run
before any jax import in test modules. Pallas kernels run in interpret
mode here (tests pass `interpret=True`); tests that need the GPU carry
the `gpu` marker and skip without one.
"""

import os

# Force CPU even where a GPU is visible: the suite is the CPU tier; the
# GPU path is checked by `chip_smoke.py` and the `gpu`-marked tests.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite's wall time is dominated by
# XLA compiles (fused while-loop optimizers, t_ppf Newton kernels, SPMD
# solves), which are identical run-to-run.
from copula_var.utils import compile_cache  # noqa: E402

compile_cache.enable_persistent_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def gpu_env():
    """Environment for a child process that runs on the GPU (this process
    is pinned to the CPU). Skips unless JAX in such a child finds a GPU.
    Decided here, at test time, never at import: xdist workers must all
    collect the same tests."""
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.default_backend())"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    backend = (probe.stdout.strip().splitlines() or ["none"])[-1]
    if probe.returncode != 0 or backend != "gpu":
        pytest.skip(f"needs a GPU; JAX's default backend is {backend!r}")
    return env
