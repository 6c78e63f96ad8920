"""One run of one cell, as ``run.py`` makes it, with the port's own spans
recorded from the process's start to the end of the run; the result line
gains the program's readings under ``"program"``.

    python3 port_bench/program_trace.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The spans are ``meme_search_engine_tpu_torch/utils/profiling.py``'s:
``engine.*`` in ``serving/engine.py`` and ``ops.build`` in
``ops/_build.py``. ``run.py`` records none of them, so these readings
are not among the benchmark's metrics. They read the engine's cells
(``systems/engine.py``):

- on the host's clock, the calls that started in the window:
  ``engine.h2d_gb_per_s`` (the ``engine.h2d`` spans' ``bytes`` over
  their time), ``engine.launch_ms`` and ``engine.d2h_wait_ms`` (time in
  ``engine.launch`` and ``engine.d2h`` a call); the notes add the
  window's counts (rows by bucket, the pageable share of the input
  bytes, the bytes brought back);
- on the host's clock, the set-up (the spans that ended before the
  window): ``setup.engine_init_s``, ``setup.first_call_s``; the notes
  give the set-up's phases between the spans;
- with ``--trace 1``, against the device trace: :func:`clock_check`
  (the copies start inside the spans that make them), :func:`align` (the
  device trace moved onto the spans' clock a call at a time) and, on
  that clock, the window's idle a call by innermost span
  (:func:`idle_by_span`): ``engine.idle_h2d_ms`` under ``engine.h2d`` and
  ``engine.idle_host_ms`` for the rest, which together are the idle of
  ``device.idle_share.images``. The breakdown's idle gaps then name the
  program's spans too.
"""

import time

T_IMPORT = time.perf_counter()

import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import Counter, defaultdict  # noqa: E402
from typing import Dict, Optional, Sequence, Tuple  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT  # the package by name, not this folder's modules

from port_bench import harness  # noqa: E402
from port_bench.trace import DeviceTrace, gaps, union  # noqa: E402

NS = 1_000_000_000
Interval = Tuple[float, float]

# the copies each of the program's spans makes: the pictures in, the embeddings out
COPY_SPANS = (("Memcpy HtoD", "engine.h2d"), ("Memcpy DtoH", "engine.d2h"))
CLOCK_TOLERANCE_S = 50e-6


def _iv(p) -> Interval:
    return p.start_ns / NS, p.end_ns / NS


def window_calls(program, t0: float, t1: float) -> list:
    """The ``engine.call`` spans that started in [t0, t1)."""
    return [p for p in program if p.name == "engine.call" and t0 <= p.start_ns / NS < t1]


def _offset(iv: Interval, t: float) -> float:
    """``t``'s signed distance to ``iv``: negative before it, positive
    after it, 0 inside."""
    return t - iv[0] if t < iv[0] else max(t - iv[1], 0.0)


def _nearest(ivs: Sequence[Interval], starts: Sequence[float], t: float) -> Interval:
    """Of the disjoint intervals ``ivs`` (sorted, with their ``starts``),
    the one nearest ``t``."""
    i = bisect.bisect_right(starts, t)
    return min(ivs[max(i - 1, 0):i + 1], key=lambda iv: abs(_offset(iv, t)))


def clock_check(trace: DeviceTrace, program, t0: float, t1: float) -> dict:
    """For each (copy kind, span name) of ``COPY_SPANS``: of the copies of
    that kind that start in [t0, t1), how many start inside a span of that
    name (within ``CLOCK_TOLERANCE_S``), and the offsets: each copy
    start's signed distance to its nearest span (negative before it,
    positive after it, 0 inside). None for a pair whose spans were not
    recorded."""
    out = {}
    for kind, name in COPY_SPANS:
        ivs = sorted(_iv(p) for p in program if p.name == name)
        if not ivs:
            out[name] = None
            continue
        starts = [a for a, _ in ivs]
        offs = [_offset(_nearest(ivs, starts, s), s)
                for s, _e, n in trace.copies if n.startswith(kind) and t0 <= s < t1]
        out[name] = {"copies": len(offs), "inside": sum(abs(o) <= CLOCK_TOLERANCE_S for o in offs),
                     "tolerance_s": CLOCK_TOLERANCE_S,
                     "median_offset_s": statistics.median(offs) if offs else 0.0,
                     "largest_offset_s": max(offs, key=abs) if offs else 0.0}
    return out


def align(trace: DeviceTrace, program) -> Optional[DeviceTrace]:
    """``trace`` moved onto the clock of the program's spans a call at a
    time. The stamps of CUPTI's device events can wander against the
    host's clock by milliseconds within a window and come back, so one
    offset for the whole trace does not always do (:func:`clock_check`).
    Here each HtoD copy is paired with the ``engine.h2d`` span nearest
    it, and the device's events from that copy to the next are shifted
    so that the copy starts as far into its span as the pairs' median
    copy does (the host's work before the copy is the same from call to
    call), and no further than keeps it inside the span. None without
    such pairs. The shifts are kept as ``shifts`` (seconds, one a pair)."""
    h2d = sorted(_iv(p) for p in program if p.name == COPY_SPANS[0][1])
    copies = sorted(c for c in trace.copies if c[2].startswith(COPY_SPANS[0][0]))
    if not h2d or not copies:
        return None
    starts = [a for a, _ in h2d]
    pairs = [(c, _nearest(h2d, starts, c[0])) for c in copies]
    lead = statistics.median(c[0] - a for c, (a, _) in pairs)
    at = [c[0] for c, _ in pairs]
    shifts = [min(max(a + lead - cs, a - cs), b - ce) for (cs, ce, _), (a, b) in pairs]

    def move(ev):
        d = shifts[max(bisect.bisect_right(at, ev[0]) - 1, 0)]
        return (ev[0] + d, ev[1] + d, ev[2])

    out = DeviceTrace()
    out.kernels = [move(k) for k in trace.kernels]
    out.copies = [move(c) for c in trace.copies]
    out.shifts = shifts
    return out


def idle_by_span(trace: DeviceTrace, program, t0: float, t1: float) -> Dict[str, float]:
    """The idle of [t0, t1] (no kernel running), each piece of it summed
    under the innermost program span open over it (the latest started),
    or "no span". Unlike ``trace.breakdown``, a gap is split where spans
    open and close."""
    events = []
    for gs, ge in gaps(union([(s, e) for s, e, _ in trace.kernels]), t0, t1):
        events += [(gs, 1, None), (ge, 0, None)]
    for p in program:
        s, e = _iv(p)
        if e > t0 and s < t1:
            events += [(s, 2, p), (e, 3, p)]
    events.sort(key=lambda ev: (ev[0], ev[1]))
    out: Dict[str, float] = defaultdict(float)
    open_now: dict = {}
    in_gap, last = False, t0
    for t, kind, p in events:
        if in_gap and t > last:
            inner = max(open_now.values(), key=lambda q: (q.start_ns, q.id), default=None)
            out[inner.name if inner else "no span"] += t - last
        last = max(last, t)
        if kind < 2:
            in_gap = kind == 1
        elif kind == 2:
            open_now[p.id] = p
        else:
            del open_now[p.id]
    return dict(out)


def readings(run, program) -> dict:
    """The program's readings of one run (the module's docstring); a
    reading with nothing to read is left out."""
    out = {}
    calls = window_calls(program, run.t0, run.t1)
    ids = {p.id for p in calls}
    mine = [p for p in program if p.call in ids]

    def seconds(name):
        return sum(p.end_ns - p.start_ns for p in mine if p.name == name) / NS

    if calls:
        h2d_bytes = sum(p.counts.get("bytes", 0) for p in mine if p.name == "engine.h2d")
        if h2d_bytes and seconds("engine.h2d") > 0:
            out["engine.h2d_gb_per_s"] = h2d_bytes / 1e9 / seconds("engine.h2d")
        for key, name in (("engine.launch_ms", "engine.launch"), ("engine.d2h_wait_ms", "engine.d2h")):
            if seconds(name) > 0:
                out[key] = 1e3 * seconds(name) / len(calls)
    before = [p for p in program if p.end_ns / NS < run.t0]
    init = [p for p in before if p.name == "engine.init"]
    if init:
        out["setup.engine_init_s"] = (init[0].end_ns - init[0].start_ns) / NS
    first = min((p for p in before if p.name == "engine.call"), key=lambda p: p.start_ns,
                default=None)
    if first is not None:
        out["setup.first_call_s"] = (first.end_ns - first.start_ns) / NS
    if run.dtrace is not None and calls:
        moved = align(run.dtrace, program)
        if moved is not None:
            idle = idle_by_span(moved, program, run.t0, run.t1)
            on_h2d = idle.get("engine.h2d", 0.0)
            out["engine.idle_h2d_ms"] = 1e3 * on_h2d / len(calls)
            out["engine.idle_host_ms"] = 1e3 * (sum(idle.values()) - on_h2d) / len(calls)
    return out


def setup_notes(program, t_start: float, t0: float) -> list:
    """The set-up on the host's clock: its phases between the program's
    spans, and one line a span (``engine.init`` and its ``engine.prepare``
    a tower, ``ops.build``, the first ``engine.call``)."""
    before = sorted((p for p in program if p.end_ns / NS < t0), key=lambda p: p.start_ns)
    init = next((p for p in before if p.name == "engine.init"), None)
    first = next((p for p in before if p.name == "engine.call"), None)
    if init is None or first is None:
        return ["setup: no engine.init or engine.call span before the window"]

    def line(p):
        what = " ".join([*(f"{k}={v}" for k, v in p.attrs.items()),
                         *(f"{k}={v}" for k, v in p.counts.items())])
        return f"setup span {p.name}: {(p.end_ns - p.start_ns) / NS:.4f} s {what}".rstrip()

    out = [f"setup phase process start to engine.init (the interpreter, imports, CUDA's "
           f"initialisation, the weights drawn): {_iv(init)[0] - t_start:.4f} s"]
    out += [line(p) for p in before if p.name in ("engine.init", "engine.prepare")]
    out.append(f"setup phase engine.init to the first engine.call (the pool of inputs): "
               f"{_iv(first)[0] - _iv(init)[1]:.4f} s")
    out.append(line(first) + " (the first)")
    out += [line(p) for p in before if p.name == "ops.build"]
    out.append(f"setup phase the first engine.call to the window (the rest of the warm-up; "
               f"with --trace 1 the profiler's start): {t0 - _iv(first)[1]:.4f} s")
    return out


def window_notes(program, t0: float, t1: float) -> list:
    """The counts of the calls that started in the window: their buckets'
    rows, the input bytes handed to the device (and the share of them
    from pageable memory) and the output bytes brought back."""
    ids = {p.id for p in window_calls(program, t0, t1)}
    if not ids:
        return []
    mine = [p for p in program if p.call in ids]
    rows = Counter(p.counts.get("rows") for p in mine if p.name == "engine.bucket")
    h2d = sum(p.counts.get("bytes", 0) for p in mine if p.name == "engine.h2d")
    pageable = sum(p.counts.get("pageable_bytes", 0) for p in mine if p.name == "engine.h2d")
    d2h = sum(p.counts.get("bytes", 0) for p in mine if p.name == "engine.d2h")
    share = 100.0 * pageable / h2d if h2d else 0.0
    return [f"window program counts: {len(ids)} engine.call, engine.bucket rows "
            f"{dict(sorted(rows.items()))}; engine.h2d {h2d} bytes, {share:.2f}% pageable; "
            f"engine.d2h {d2h} bytes"]


def clock_notes(check: dict, clock: str) -> list:
    out = []
    for name, c in check.items():
        if c is None:
            out.append(f"clock check {name} ({clock}): no such program spans")
        else:
            out.append(f"clock check {name} ({clock}): {c['inside']} of {c['copies']} copies start "
                       f"inside (tolerance {c['tolerance_s'] * 1e6:.0f} us); offset median "
                       f"{c['median_offset_s'] * 1e6:.2f} us, "
                       f"largest {c['largest_offset_s'] * 1e6:.2f} us")
    return out


def device_notes(dtrace: DeviceTrace, program, t0: float, t1: float) -> list:
    """The clock check on the profiler's clock and on the aligned one (the
    DtoH copies inside their ``engine.d2h`` spans are a check that the
    alignment, made from the HtoD copies, does not make), the alignment's
    shifts, and the window's idle a call by innermost span on both clocks."""
    calls = window_calls(program, t0, t1)
    moved = align(dtrace, program)
    out = clock_notes(clock_check(dtrace, program, t0, t1), "profiler's clock")
    if moved is None or not calls:
        return out + ["aligned: no HtoD copy pairs with an engine.h2d span"]
    sh = sorted(moved.shifts)
    out.append(f"aligned a call at a time: {len(sh)} shifts, median {sh[len(sh) // 2] * 1e6:.2f} "
               f"us, from {sh[0] * 1e6:.2f} to {sh[-1] * 1e6:.2f} us")
    out += clock_notes(clock_check(moved, program, t0, t1), "aligned")
    for clock, dt in (("profiler's clock", dtrace), ("aligned", moved)):
        idle = sorted(idle_by_span(dt, program, t0, t1).items(), key=lambda kv: -kv[1])
        out.append(f"idle a call by innermost program span ({clock}): "
                   + ", ".join(f"{k} {1e3 * v / len(calls):.3f} ms" for k, v in idle))
    return out


def main(argv, t_start: Optional[float] = None, *, cpu: bool = False,
         overrides: Optional[dict] = None) -> int:
    """``harness.main`` with the program's spans recorded around the run."""
    from meme_search_engine_tpu_torch.utils import profiling

    profiling.start_recording()
    try:
        ctx, run = harness.execute(argv, t_start, cpu=cpu, overrides=overrides)
    finally:
        program = profiling.stop_recording()
    if run.spans is not None:  # the breakdown's idle gaps name them too
        for p in program:
            run.spans.add(p.name, *_iv(p))
    result = harness.report(ctx, run)
    checks = result.pop("checks")
    result["program"] = readings(run, program)
    result["checks"] = checks
    bad = harness.forbidden_modules()
    if bad:
        print(f"refusing to report: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    notes = run.notes + setup_notes(program, ctx.t_start, run.t0)
    notes += window_notes(program, run.t0, run.t1)
    if run.dtrace is not None:
        notes += device_notes(run.dtrace, program, run.t0, run.t1)
    for line in notes:
        print(line, file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    cache = os.path.join(ROOT, "build", "bench_cache")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    start = harness.process_start()
    sys.exit(main(sys.argv[1:], T_IMPORT if start is None else start))
