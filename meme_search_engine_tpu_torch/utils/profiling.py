"""Tracing and profiling utilities.

The reference instruments every pipeline stage with ``tracing`` spans
and RAII phase timers, and exposes Prometheus on every service (SURVEY
SS5). Here:

- :func:`trace` — a ``torch.profiler`` context over the host and, where
  there is a card, its kernels; on exit it writes a Chrome trace (open
  it in Perfetto or ``chrome://tracing``) into a directory.
- :func:`annotate` — a named span that shows up inside the trace
  (``torch.profiler.record_function``).
- :class:`PhaseTimers` — process-wide named phase timer registry with a
  report, the Timer(lib.rs:389-401) analogue for multi-phase jobs.
- Prometheus metrics live next to each service (serving/*.py).

Counterpart of ``meme_search_engine_tpu/utils/profiling.py``: ``trace``
and ``annotate`` take ``torch.profiler`` where the JAX package takes
``jax.profiler``, and ``trace`` yields the profiler, so a caller can read
its events as well; ``PhaseTimers`` and ``GLOBAL_TIMERS`` are copies.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[object]:
    """Profile the block: host ops always, CUDA kernels where a card is
    present. On exit, error or not, the trace is written to
    ``log_dir/trace_<pid>_<ns>.json``; yields the ``torch.profiler``
    object."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        )


def annotate(name: str):
    """Named span visible in profiler timelines."""
    from torch.profiler import record_function

    return record_function(name)


class PhaseTimers:
    """Accumulating named phase timers with a printable report."""

    def __init__(self):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._totals[name] += time.perf_counter() - t0
            self._counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self._totals, key=self._totals.get, reverse=True):
            lines.append(
                f"{name}: {self._totals[name]:.2f}s "
                f"({self._counts[name]} calls)"
            )
        return "\n".join(lines)

    def totals(self) -> Dict[str, float]:
        return dict(self._totals)


GLOBAL_TIMERS = PhaseTimers()
