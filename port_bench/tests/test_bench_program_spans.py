"""``program_trace.py``: the readings of the program's own spans, the
clock check and the per-call alignment, against hand-made kernels, copies
and spans; and a run of each cell with the spans recorded, on the CPU."""

import json
from types import SimpleNamespace

import pytest

from port_bench import harness, program_trace, trace

from conftest import tiny_overrides

NS = 1_000_000_000


def span(name, start, end, id, call, parent=None, **counts):
    return SimpleNamespace(name=name, start_ns=round(start * NS), end_ns=round(end * NS), id=id,
                           call=call, parent=parent, counts=counts, attrs={})


def hand_run(with_program=True):
    """A window of [0, 10) s with two calls, and the set-up's engine and
    first call before it. Kernels run in (1.5, 4.5) and (6.8, 9.5), so the
    card is idle in [0, 1.5), [4.5, 6.8) and [9.5, 10): 4.3 s, of which
    2.49 s lie under an engine.h2d span ([0.01, 1] and [5, 6.5])."""
    program = [
        span("engine.init", -3.0, -2.0, 1, 1),
        span("engine.call", -2.0, -1.0, 2, 2, rows=8, buckets=1),
        span("engine.h2d", -2.0, -1.5, 3, 2, parent=2, bytes=5 * NS),
        span("engine.call", 0.0, 4.98, 4, 4, rows=8, buckets=1),
        span("engine.bucket", 0.005, 4.97, 12, 4, parent=4, rows=8),
        span("engine.h2d", 0.01, 1.0, 5, 4, parent=12, bytes=1 * NS, pageable_bytes=1 * NS),
        span("engine.launch", 1.0, 2.0, 6, 4, parent=12),
        span("engine.d2h", 2.0, 4.8, 7, 4, parent=12, bytes=1024),
        span("engine.call", 4.99, 10.0, 8, 8, rows=8, buckets=1),
        span("engine.bucket", 4.995, 9.95, 13, 8, parent=8, rows=8),
        span("engine.h2d", 5.0, 6.5, 9, 8, parent=13, bytes=2 * NS, pageable_bytes=2 * NS),
        span("engine.launch", 6.5, 7.0, 10, 8, parent=13),
        span("engine.d2h", 7.0, 9.9, 11, 8, parent=13, bytes=1024),
    ]
    dt = trace.DeviceTrace()
    dt.kernels = [(1.5, 4.5, "gemm"), (6.8, 9.5, "gemm")]
    dt.copies = [(0.2, 0.9, "Memcpy HtoD (Pageable -> Device)"),
                 (4.6, 4.7, "Memcpy DtoH (Device -> Pageable)"),
                 (5.1, 6.4, "Memcpy HtoD (Pageable -> Device)"),
                 (9.6, 9.7, "Memcpy DtoH (Device -> Pageable)")]
    return SimpleNamespace(t0=0.0, t1=10.0, dtrace=dt,
                           program_spans=program if with_program else [],
                           calls=[(0.0, 5.0, {"img": 8}), (5.0, 10.0, {"img": 8})])


def test_idle_readings_split_the_whole_idle():
    run = hand_run()
    got = program_trace.readings(run, run.program_spans)
    assert got["engine.idle_h2d_ms"] == pytest.approx(1e3 * 2.49 / 2)
    assert got["engine.idle_host_ms"] == pytest.approx(1e3 * 1.81 / 2)
    idle_share = harness.read_metric("device.idle_share.images", run)
    assert (got["engine.idle_h2d_ms"] + got["engine.idle_host_ms"]) * 2 / 1e3 == \
        pytest.approx(idle_share / 100 * 10.0)


def test_host_readings_take_the_window_calls_only():
    run = hand_run()
    got = program_trace.readings(run, run.program_spans)
    assert got["engine.h2d_gb_per_s"] == pytest.approx(3.0 / 2.49)
    assert got["engine.launch_ms"] == pytest.approx(1e3 * 1.5 / 2)
    assert got["engine.d2h_wait_ms"] == pytest.approx(1e3 * 5.7 / 2)
    assert got["setup.engine_init_s"] == pytest.approx(1.0)
    assert got["setup.first_call_s"] == pytest.approx(1.0)
    run.dtrace = None  # no device trace: no idle split
    assert set(program_trace.readings(run, run.program_spans)) == {
        "engine.h2d_gb_per_s", "engine.launch_ms", "engine.d2h_wait_ms",
        "setup.engine_init_s", "setup.first_call_s"}


def test_a_program_without_spans_reads_nothing():
    run = hand_run(with_program=False)
    assert program_trace.readings(run, run.program_spans) == {}


def test_breakdown_names_the_program_spans():
    run = hand_run()
    spans = trace.Spans()
    spans.add("EmbeddingEngine.embed_image_arrays", -0.001, 5.001)
    spans.add("EmbeddingEngine.embed_image_arrays", 4.999, 10.001)
    for p in run.program_spans:
        spans.add(p.name, p.start_ns / NS, p.end_ns / NS)
    gaps = dict((k, v) for k, v in trace.breakdown(run.dtrace, spans, 0.0, 10.0)["idle_gaps"])
    # each gap goes to the innermost span open at its middle: 0.75 and 5.65 under
    # engine.h2d, 9.75 under engine.d2h
    assert gaps == pytest.approx({"engine.h2d": 1.5 + 2.3, "engine.d2h": 0.5})


def test_idle_by_span_splits_gaps_where_spans_open_and_close():
    run = hand_run()
    idle = program_trace.idle_by_span(run.dtrace, run.program_spans, 0.0, 10.0)
    # [0, 1.5): call, bucket, h2d, launch; [4.5, 6.8): d2h, bucket, call, none,
    # call, bucket, h2d, launch; [9.5, 10): d2h, bucket, call
    assert idle == pytest.approx({"engine.call": 0.005 + 0.01 + 0.005 + 0.05,
                                  "engine.bucket": 0.005 + 0.17 + 0.005 + 0.05,
                                  "engine.h2d": 2.49, "engine.launch": 0.8, "engine.d2h": 0.7,
                                  "no span": 0.01})
    assert sum(idle.values()) == pytest.approx(4.3)


def steady_run(wander=0.0, at=2):
    """Five calls of 2 s in a window of [0, 10): the h2d span opens 0.1 s
    in and its copy starts 0.1 s later, the tower's kernel runs from 0.65
    to 1.5 s, its output's copy right after. Call ``at``'s device stamps
    sit ``wander`` seconds off the host's."""
    program, dt, i = [], trace.DeviceTrace(), 0
    for k in range(5):
        t, d = 2.0 * k, wander if k == at else 0.0
        call = i + 1
        program += [span("engine.call", t, t + 1.9, call, call),
                    span("engine.h2d", t + 0.1, t + 0.6, call + 1, call, parent=call, bytes=NS),
                    span("engine.launch", t + 0.6, t + 0.7, call + 2, call, parent=call),
                    span("engine.d2h", t + 0.7, t + 1.8, call + 3, call, parent=call)]
        i += 4
        dt.copies += [(t + 0.2 + d, t + 0.55 + d, "Memcpy HtoD (Pageable -> Device)"),
                      (t + 1.5 + d, t + 1.52 + d, "Memcpy DtoH (Device -> Pageable)")]
        dt.kernels.append((t + 0.65 + d, t + 1.5 + d, "gemm"))
    return SimpleNamespace(t0=0.0, t1=10.0, dtrace=dt, program_spans=program,
                           calls=[(2.0 * k, 2.0 * k + 1.9, {"img": 8}) for k in range(5)])


def test_align_undoes_a_call_whose_device_stamps_wander():
    clean, off = steady_run(), steady_run(wander=-0.3)
    raw = program_trace.clock_check(off.dtrace, off.program_spans, 0.0, 10.0)["engine.h2d"]
    assert (raw["inside"], raw["copies"]) == (4, 5)
    moved = program_trace.align(off.dtrace, off.program_spans)
    assert moved.shifts == pytest.approx([0.0, 0.0, 0.3, 0.0, 0.0])
    fixed = program_trace.clock_check(moved, off.program_spans, 0.0, 10.0)
    assert fixed["engine.h2d"]["inside"] == fixed["engine.d2h"]["inside"] == 5
    want = program_trace.idle_by_span(clean.dtrace, clean.program_spans, 0.0, 10.0)
    assert program_trace.idle_by_span(off.dtrace, off.program_spans, 0.0, 10.0)["engine.h2d"] == \
        pytest.approx(want["engine.h2d"] - 0.25)
    assert program_trace.idle_by_span(moved, off.program_spans, 0.0, 10.0) == pytest.approx(want)
    # the readings split the same idle that device.idle_share.images takes
    got = program_trace.readings(off, off.program_spans)
    assert got["engine.idle_h2d_ms"] == pytest.approx(1e3 * want["engine.h2d"] / 5)
    share = harness.read_metric("device.idle_share.images", off)
    assert (got["engine.idle_h2d_ms"] + got["engine.idle_host_ms"]) * 5 / 1e3 == \
        pytest.approx(share / 100 * 10.0)


def test_align_keeps_each_copy_inside_its_span():
    run = steady_run(wander=0.3, at=0)  # the first call's copy would start 0.4 s in
    run.dtrace.copies[0] = (0.5, 0.65, "Memcpy HtoD (Pageable -> Device)")  # 0.4 s in, to 0.55
    moved = program_trace.align(run.dtrace, run.program_spans)
    # the median lead (0.1 s) would need -0.3; that would end the copy at 0.35,
    # inside, so it stands; a copy as long as its span is pinned to its start
    assert moved.shifts[0] == pytest.approx(-0.3)
    run.dtrace.copies[0] = (0.5, 1.0, "Memcpy HtoD (Pageable -> Device)")
    assert program_trace.align(run.dtrace, run.program_spans).shifts[0] == pytest.approx(-0.4)


def test_align_needs_copies_paired_with_spans():
    run = hand_run(with_program=False)
    assert program_trace.align(run.dtrace, run.program_spans) is None
    run = hand_run()
    run.dtrace.copies = []
    assert program_trace.align(run.dtrace, run.program_spans) is None


def test_notes_read_the_counts_the_set_up_and_the_aligned_idle():
    run = hand_run()
    (line,) = program_trace.window_notes(run.program_spans, 0.0, 10.0)
    assert line == ("window program counts: 2 engine.call, engine.bucket rows {8: 2}; "
                    "engine.h2d 3000000000 bytes, 100.00% pageable; engine.d2h 2048 bytes")
    notes = program_trace.device_notes(run.dtrace, run.program_spans, 0.0, 10.0)
    assert notes[0].startswith("clock check engine.h2d (profiler's clock): 2 of 2 copies")
    assert notes[2].startswith("aligned a call at a time: 2 shifts")
    assert notes[4].startswith("clock check engine.d2h (aligned): 2 of 2 copies")
    assert notes[5].startswith("idle a call by innermost program span (profiler's clock): "
                               "engine.h2d 1245.000 ms")
    assert notes[6].startswith("idle a call by innermost program span (aligned): "
                               "engine.h2d 1245.000 ms")
    assert program_trace.window_notes([], 0.0, 10.0) == []
    run.dtrace.copies = []
    assert program_trace.device_notes(run.dtrace, run.program_spans, 0.0, 10.0)[-1] == \
        "aligned: no HtoD copy pairs with an engine.h2d span"
    setup = program_trace.setup_notes(run.program_spans, -10.0, 0.0)
    assert setup[0].endswith("the weights drawn): 7.0000 s")
    assert setup[1] == "setup span engine.init: 1.0000 s"
    assert setup[2].endswith("(the pool of inputs): 0.0000 s")
    assert setup[3] == "setup span engine.call: 1.0000 s rows=8 buckets=1 (the first)"
    assert setup[4].endswith("the profiler's start): 1.0000 s")
    assert program_trace.setup_notes([], -10.0, 0.0) == [
        "setup: no engine.init or engine.call span before the window"]


def test_clock_check_counts_copies_inside_their_spans():
    run = hand_run()
    out = program_trace.clock_check(run.dtrace, run.program_spans, 0.0, 10.0)
    assert out["engine.h2d"]["copies"] == out["engine.h2d"]["inside"] == 2
    assert out["engine.h2d"]["median_offset_s"] == 0.0
    assert out["engine.d2h"]["copies"] == out["engine.d2h"]["inside"] == 2
    # a copy shifted 1 ms out of its span is counted outside, 40 us is within tolerance
    run.dtrace.copies = [(5.0 - 1e-3, 5.5, "Memcpy HtoD (Pageable -> Device)"),
                         (1.0 + 40e-6, 1.1, "Memcpy HtoD (Pageable -> Device)")]
    out = program_trace.clock_check(run.dtrace, run.program_spans, 0.0, 10.0)
    h2d = out["engine.h2d"]
    assert (h2d["copies"], h2d["inside"]) == (2, 1)
    assert h2d["largest_offset_s"] == pytest.approx(-1e-3)
    assert h2d["median_offset_s"] == pytest.approx(0.5 * (-1e-3 + 40e-6))
    assert out["engine.d2h"]["copies"] == 0


def test_clock_check_without_program_spans():
    run = hand_run(with_program=False)
    assert program_trace.clock_check(run.dtrace, [], 0.0, 10.0) == {
        "engine.h2d": None, "engine.d2h": None}


CELLS = [w["name"] for w in harness._load("..", "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace_on", [0, 1])
def test_a_cell_run_with_the_spans_recorded(cell, trace_on, capsys):
    """The run's result as ``run.py`` gives it, and the program's readings
    on the host's clock, each above 0; the recorder is off after it."""
    from meme_search_engine_tpu_torch.utils import profiling

    argv = ["--workload", cell, "--seed", "4294967311", "--seconds", "1.5",
            "--trace", str(trace_on)]
    assert program_trace.main(argv, cpu=True, overrides=tiny_overrides(cell)) == 0
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert not profiling.is_recording()
    assert result["correct"] is True and list(result)[-2:] == ["program", "checks"]
    assert harness.main(argv, cpu=True, overrides=tiny_overrides(cell)) == 0
    plain = json.loads(capsys.readouterr()[0].strip().splitlines()[-1])
    assert set(result["metrics"]) == set(plain["metrics"])
    # the CPU has no device trace: no idle split
    assert set(result["program"]) == {"engine.h2d_gb_per_s", "engine.launch_ms",
                                      "engine.d2h_wait_ms", "setup.engine_init_s",
                                      "setup.first_call_s"}
    assert all(v > 0 for v in result["program"].values())
    assert "setup span engine.prepare: " in err and "window program counts" in err
