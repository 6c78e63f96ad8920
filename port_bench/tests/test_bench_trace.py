"""Busy time as a union of intervals, idle shares, gaps and the
breakdown's attribution of idle gaps to host spans."""

import threading

import pytest

from port_bench import trace


def test_union_merges_overlaps_and_touching():
    assert trace.union([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == [(0, 2.5), (3, 4)]
    assert trace.union([]) == []


def test_busy_is_the_union_not_the_sum():
    merged = trace.union([(0, 2), (1, 3), (1.5, 2.5), (5, 6)])
    assert trace.covered(merged, 0, 10) == pytest.approx(4.0)  # the sum would be 5
    assert trace.covered(merged, 2, 5.5) == pytest.approx(1.5)  # clipped to the window


def test_idle_share_of_a_window():
    dt = trace.DeviceTrace()
    dt.kernels = [(0.0, 1.0, "a"), (0.5, 1.5, "b"), (3.0, 4.0, "a")]
    assert dt.busy(0.0, 5.0) == pytest.approx(2.5)
    assert 1 - dt.busy(0.0, 5.0) / 5.0 == pytest.approx(0.5)


def test_gaps():
    merged = trace.union([(1, 2), (3, 4)])
    assert trace.gaps(merged, 0, 5) == [(0, 1), (2, 3), (4, 5)]
    assert trace.gaps(merged, 1.5, 3.5) == [(2, 3)]


def test_breakdown_attributes_gaps_to_the_innermost_open_span():
    dt = trace.DeviceTrace()
    dt.kernels = [(0.0, 1.0, "gemm"), (2.0, 3.0, "gemm"), (3.5, 4.0, "gemm"), (6.0, 10.0, "attn")]
    dt.copies = [(1.0, 1.5, "Memcpy HtoD")]
    spans = trace.Spans()
    spans.add("http", 0.0, 5.0)
    spans.add("format_results", 4.0, 5.5)
    out = trace.breakdown(dt, spans, 0.0, 12.0)
    assert out["device_ops"][0] == ["attn", 4.0]
    assert out["device_ops"][1] == ["gemm", 2.5]
    gaps = dict((k, v) for k, v in out["idle_gaps"])
    assert gaps["http"] == pytest.approx(1.0 + 0.5)  # (1, 2) and (3, 3.5)
    assert gaps["format_results"] == pytest.approx(2.0)  # (4, 6): both open at 5, inner wins
    assert gaps["no span"] == pytest.approx(2.0)  # (10, 12)


def test_spans_patch_and_restore():
    class Owner:
        def f(self, x):
            return x + 1

    spans = trace.Spans()
    spans.patch(Owner, "f", "Owner.f")
    assert Owner().f(2) == 3
    worker = threading.Thread(target=Owner().f, args=(5,))  # spans from another thread too
    worker.start()
    worker.join()
    spans.restore()
    assert "wrapper" not in Owner.f.__qualname__
    assert len(spans.by_name["Owner.f"]) == 2
    assert all(e >= s for s, e in spans.by_name["Owner.f"])
    assert spans.within("Owner.f", 0.0, spans.by_name["Owner.f"][1][0]) == \
        spans.by_name["Owner.f"][:1]
