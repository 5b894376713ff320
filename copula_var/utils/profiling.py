"""Tracing / profiling hooks.

The reference instruments with bare print-timers at three points
(`calc_var_class.py:109,173-175`, `calc_integral.py:68-113`,
`opti.py:117-134`; SURVEY.md §5). Here:

  * `StageTimer` — structured named-stage wall timing with the same
    measurement points (grid/prep, integration, solve, optimize) exposed
    as a dict instead of stdout noise.
  * `trace_to` — context manager around `jax.profiler` emitting a
    TensorBoard-loadable trace of the device work.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Optional

logger = logging.getLogger("copula_var")


class StageTimer:
    """Accumulates wall time per named stage.

    with timer.stage("integration"): ...
    timer.totals -> {"integration": 1.23, ...}
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield self
        finally:
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            logger.debug("stage %s: %.4fs (total %.4fs)", name, dt, self.totals[name])

    def report(self) -> str:
        lines = [
            f"{name}: {tot:.3f}s over {self.counts[name]} call(s)"
            for name, tot in sorted(self.totals.items())
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace_to(logdir: Optional[str]):
    """jax.profiler trace context; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
