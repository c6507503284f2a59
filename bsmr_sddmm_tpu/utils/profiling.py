"""Profiling hooks.

The reference's only profiling mechanism is CUDA-event phase timers
flowing into the Logger (include/CudaTimeCalculator.cuh:14-54 — SURVEY.md
section 5). The equivalents here:

* phase wall timers with the same Logger integration (`phase_timer`),
* `jax.profiler` trace capture for xprof/tensorboard (`trace`),
* per-kernel device timing via utils.timing.time_jitted.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator


@contextlib.contextmanager
def phase_timer(sink: Dict[str, float], name: str) -> Iterator[None]:
    """Accumulate the wall time of a pipeline phase into ``sink`` (ms),
    like the reference's per-phase CudaTimeCalculator fields."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink[name] = sink.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False
          ) -> Iterator[None]:
    """Capture a jax.profiler device trace around the enclosed block.
    View with tensorboard/xprof or the perfetto link."""
    import jax
    jax.profiler.start_trace(log_dir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
