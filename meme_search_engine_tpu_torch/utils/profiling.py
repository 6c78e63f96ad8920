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
- :func:`span` and :func:`count` — the program's own spans, with counts,
  at its layers' boundaries, recorded in memory only between
  :func:`start_recording` and :func:`stop_recording` (off by default);
  :func:`recorded` reads them meanwhile.
- Prometheus metrics live next to each service (serving/*.py).

Counterpart of ``meme_search_engine_tpu/utils/profiling.py``: ``trace``
and ``annotate`` take ``torch.profiler`` where the JAX package takes
``jax.profiler``, and ``trace`` yields the profiler, so a caller can read
its events as well; ``PhaseTimers`` and ``GLOBAL_TIMERS`` are copies.
The span recorder is the port's own.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional


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


class Span:
    """One recorded span: ``name``, ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns``, its ``id``, its ``parent``'s id (None for a
    root), the id of its root (``call``: every span of one call shares
    it), its ``counts`` and its ``attrs``. A span nests under the span
    open on its own thread when it starts."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "call", "counts", "attrs",
                 "_rec", "_rf")

    def __init__(self, rec: "_Recorder", name: str, counts: dict, attrs: Optional[dict]):
        self._rec = rec
        self.name = name
        self.counts = counts
        self.attrs = attrs or {}
        self.start_ns = self.end_ns = 0
        self.id = next(rec.ids)
        self.parent = self.call = None

    def __enter__(self) -> "Span":
        stack = self._rec.stack()
        top = stack[-1] if stack else None
        self.parent = top.id if top else None
        self.call = top.call if top else self.id
        stack.append(self)
        self._rf = self._rec.record_function(self.name)
        self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        self._rf = None
        self._rec.stack().pop()
        self._rec.add(self)


class _NoSpan:
    """What :func:`span` returns while nothing records: one shared object
    whose enter and exit do nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()


class _Recorder:
    """The spans of one recording, each thread's stack of open spans, and
    the lock that guards the list."""

    def __init__(self):
        from torch.profiler import record_function

        self.record_function = record_function
        self.ids = itertools.count(1)
        self.spans: List[Span] = []
        self.lock = threading.Lock()
        self.local = threading.local()
        self.done = False

    def stack(self) -> List[Span]:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def add(self, s: Span) -> None:
        with self.lock:
            if not self.done:  # a span that ends after the recording is dropped
                self.spans.append(s)


_recorder: Optional[_Recorder] = None


def start_recording() -> None:
    """Record every :func:`span` from now on, in memory, until
    :func:`stop_recording`. Raises if a recording is already on."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a recording is already on")
    _recorder = _Recorder()


def stop_recording() -> List[Span]:
    """Stop recording; returns the spans that ended, in the order they
    ended, and forgets them. Raises if no recording is on."""
    global _recorder
    rec = _recorder
    if rec is None:
        raise RuntimeError("no recording is on")
    _recorder = None
    with rec.lock:
        rec.done = True
        return rec.spans


def recorded() -> List[Span]:
    """The spans that have ended so far in the recording that is on, in
    the order they ended, which it keeps; raises if no recording is on."""
    rec = _recorder
    if rec is None:
        raise RuntimeError("no recording is on")
    with rec.lock:
        return list(rec.spans)


def is_recording() -> bool:
    """Whether spans are being recorded: for counts that cost something
    to compute."""
    return _recorder is not None


def span(name: str, attrs: Optional[dict] = None, **counts):
    """A span around a block, ``with span("engine.call", rows=n): ...``:
    ``counts`` are numbers (more can be added inside by :func:`count`),
    ``attrs`` a dict of labels. While recording, the block is also an
    :func:`annotate` range of the same name, so a :func:`trace` shows it
    above its kernels. While not recording it returns one shared object
    that does nothing: no clock is read and nothing is kept."""
    rec = _recorder
    if rec is None:
        return _NO_SPAN
    return Span(rec, name, counts, attrs)


def count(name: str, n) -> None:
    """Add ``n`` to the count ``name`` of the innermost span open on this
    thread; does nothing while not recording or outside every span."""
    rec = _recorder
    if rec is None:
        return
    stack = rec.stack()
    if stack:
        c = stack[-1].counts
        c[name] = c.get(name, 0) + n
