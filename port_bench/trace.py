"""What a traced run (``--trace 1``) records, and the arithmetic over it.

- :class:`Spans`: host spans around the calls into each layer, from the
  benchmark's own wrappers (:meth:`Spans.patch`), kept in memory as
  ``(start, end)`` on ``time.perf_counter``'s clock.
- :class:`DeviceTrace`: ``torch.profiler`` over the card alone (CUDA
  activity, no host operators), its kernel and copy intervals moved onto
  ``perf_counter``'s clock.
- :func:`union`, :func:`covered`: busy time as the union of intervals,
  never their sum, so overlapping kernels count once.
- :func:`breakdown`: the device's top operations and its idle gaps by the
  host span that was open.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Spans", "DeviceTrace", "union", "covered", "gaps", "breakdown"]

Interval = Tuple[float, float]


class Spans:
    """Named host spans. :meth:`patch` replaces ``owner.attr`` with a
    wrapper that records each call, from any thread; :meth:`restore` puts
    every original back."""

    def __init__(self):
        self.by_name: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self._patched: list = []

    def add(self, name: str, start: float, end: float) -> None:
        self.by_name[name].append((start, end))

    def patch(self, owner, attr: str, name: str) -> None:
        orig = getattr(owner, attr)
        raw = owner.__dict__.get(attr, orig)
        spans = self

        @functools.wraps(orig)
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                spans.add(name, t0, time.perf_counter())

        setattr(owner, attr, wrapper)
        self._patched.append((owner, attr, raw))

    def restore(self) -> None:
        for owner, attr, raw in reversed(self._patched):
            setattr(owner, attr, raw)
        self._patched.clear()

    def within(self, name: str, t0: float, t1: float) -> List[Tuple[float, float]]:
        """The spans of ``name`` that started in [t0, t1)."""
        return [s for s in self.by_name.get(name, []) if t0 <= s[0] < t1]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged: Sequence[Interval], t0: float, t1: float) -> float:
    """Seconds of [t0, t1] that the disjoint intervals ``merged`` cover."""
    return sum(max(0.0, min(e, t1) - max(s, t0)) for s, e in merged)


def gaps(merged: Sequence[Interval], t0: float, t1: float) -> List[Interval]:
    """The parts of [t0, t1] that the disjoint intervals leave free."""
    out, cur = [], t0
    for s, e in merged:
        if e <= t0 or s >= t1:
            continue
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < t1:
        out.append((cur, t1))
    return out


class DeviceTrace:
    """``torch.profiler`` over the card: kernels, copies and memsets with
    their start and end on ``time.perf_counter``'s clock. The profiler
    stamps device events on the host's wall clock (``time.time_ns``);
    the offset between the two clocks is read when the trace stops."""

    def __init__(self):
        self._prof = None
        self.kernels: List[Tuple[float, float, str]] = []
        self.copies: List[Tuple[float, float, str]] = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self._prof.stop()
        a = time.time_ns() - time.perf_counter_ns()
        b = time.time_ns() - time.perf_counter_ns()
        offset = (a + b) // 2
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            s = (e.start_ns() - offset) / 1e9
            iv = (s, s + e.duration_ns() / 1e9, e.name())
            if e.name().startswith(("Memcpy", "Memset")):
                self.copies.append(iv)
            else:
                self.kernels.append(iv)
        self._prof = None

    def busy(self, t0: float, t1: float) -> float:
        """Seconds of [t0, t1] in which a kernel ran."""
        return covered(union([(s, e) for s, e, _ in self.kernels]), t0, t1)


def breakdown(trace: DeviceTrace, spans: Optional[Spans], t0: float, t1: float,
              top: int = 10) -> dict:
    """The device operations that took most time in [t0, t1], by name,
    and the idle gaps (no kernel running) summed by the host span open at
    each gap's middle (the innermost: the latest started), or "no span"."""
    by_op: Dict[str, float] = defaultdict(float)
    for s, e, name in trace.kernels + trace.copies:
        d = min(e, t1) - max(s, t0)
        if d > 0:
            by_op[name[:120]] += d
    free = gaps(union([(s, e) for s, e, _ in trace.kernels]), t0, t1)
    # one sweep over span starts (0), gap middles (1) and span ends (2)
    events = [(0.5 * (gs + ge), 1, ge - gs, "") for gs, ge in free]
    if spans is not None:
        for n, lst in spans.by_name.items():
            for s, e in lst:
                events += [(s, 0, s, n), (e, 2, s, n)]
    events.sort(key=lambda ev: (ev[0], ev[1]))
    by_host: Dict[str, float] = defaultdict(float)
    open_now: List[Tuple[float, str]] = []
    for _t, kind, x, n in events:
        if kind == 0:
            open_now.append((x, n))
        elif kind == 2:
            open_now.remove((x, n))
        else:
            by_host[max(open_now)[1] if open_now else "no span"] += x
    order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": order(by_op), "idle_gaps": order(by_host)}
