"""The port's span recorder (``utils/profiling.py``: ``span``, ``count``,
``start_recording``, ``stop_recording``) and the spans of the embedding
engine (``serving/engine.py``), on the CPU with the tiny model."""

import threading
import tracemalloc

import numpy as np
import pytest
import torch

from meme_search_engine_tpu_torch.models import siglip
from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine
from meme_search_engine_tpu_torch.utils import profiling


@pytest.fixture
def recording():
    """Recording on for the test; its spans by ``stop()``, and off after
    the test whatever happens."""
    profiling.start_recording()
    box = {}

    def stop():
        box["spans"] = profiling.stop_recording()
        return box["spans"]

    yield stop
    if "spans" not in box:
        profiling.stop_recording()


def _spans_off(n):
    for _ in range(n):
        with profiling.span("engine.bucket", rows=4):
            profiling.count("bytes", 8)


class _Bare:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


def _with_alone(n, bare=_Bare()):
    for _ in range(n):
        with bare:
            pass


def test_off_records_nothing_and_returns_one_object():
    assert not profiling.is_recording()
    a = profiling.span("engine.call", rows=3)
    assert a is profiling.span("engine.d2h") and a.__enter__() is None
    profiling.count("rows", 1)  # nothing open, nothing recording: no effect
    profiling.start_recording()
    assert profiling.stop_recording() == []  # the spans made while off were not kept


def test_off_allocates_nothing_for_a_span():
    """Ten thousand spans with counts while off hold no memory afterwards
    and take no more at their peak than a ``with`` over an object that
    exists already (the statement's own transient bytes)."""
    _spans_off(10)
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        _with_alone(10_000)
        alone = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        _spans_off(10_000)
        spans = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert spans[0] - base <= 0 and alone[0] - base <= 0
    assert spans[1] <= alone[1]


def test_nesting_counts_and_call_ids(recording):
    with profiling.span("a", rows=2) as a:
        profiling.count("bytes", 5)
        with profiling.span("b", attrs={"tower": "img"}) as b:
            profiling.count("bytes", 7)
            profiling.count("bytes", 1)
        with profiling.span("c") as c:
            pass
    with profiling.span("d") as d:
        pass
    spans = recording()
    assert [s.name for s in spans] == ["b", "c", "a", "d"]  # in the order they ended
    assert (a.parent, b.parent, c.parent, d.parent) == (None, a.id, a.id, None)
    assert {a.call, b.call, c.call} == {a.id} and d.call == d.id != a.id
    assert a.counts == {"rows": 2, "bytes": 5} and b.counts == {"bytes": 8} and c.counts == {}
    assert b.attrs == {"tower": "img"}
    assert a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns <= c.end_ns <= a.end_ns <= d.start_ns
    assert not profiling.is_recording()
    # taken and cleared: the next recording starts empty
    profiling.start_recording()
    assert profiling.stop_recording() == []


def test_two_threads_do_not_cross_parents(recording):
    ready, go = threading.Barrier(2), threading.Event()

    def work(tag):
        with profiling.span("outer", attrs={"tag": tag}):
            ready.wait(timeout=10)  # both outers open at once
            with profiling.span("inner", attrs={"tag": tag}):
                go.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(t,)) for t in ("x", "y")]
    for t in threads:
        t.start()
    go.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    spans = recording()
    outer = {s.attrs["tag"]: s for s in spans if s.name == "outer"}
    inner = {s.attrs["tag"]: s for s in spans if s.name == "inner"}
    for tag in ("x", "y"):
        assert inner[tag].parent == outer[tag].id and inner[tag].call == outer[tag].id
        assert outer[tag].parent is None


def test_recording_twice_or_stopping_twice_raises(recording):
    with pytest.raises(RuntimeError):
        profiling.start_recording()
    recording()
    with pytest.raises(RuntimeError):
        profiling.stop_recording()


def test_a_span_shows_in_a_trace(recording):
    """While recording, a span is also a profiler range of its name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("engine.launch"):
            torch.randn(8, 8) @ torch.randn(8, 8)
    recording()
    names = {e.key for e in prof.key_averages()}
    assert "engine.launch" in names and "aten::mm" in names


@pytest.fixture(scope="module")
def engine():
    cfg = siglip.tiny_test_config()
    params = siglip.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    return EmbeddingEngine(params, cfg, max_batch=4, device="cpu"), params, cfg


def test_engine_call_spans(engine, recording):
    """7 images at max_batch 4: one engine.call (rows 7, buckets 3) over
    buckets of 4, 2 and 1, each with h2d, launch and d2h in that order;
    the h2d bytes are the pictures'."""
    eng, _, cfg = engine
    r = cfg.image_size
    imgs = np.random.default_rng(5).integers(0, 256, (7, r, r, 3), dtype=np.uint8)
    eng.embed_image_arrays(imgs)
    spans = recording()
    (call,) = [s for s in spans if s.name == "engine.call"]
    assert call.counts == {"rows": 7, "buckets": 3} and call.parent is None
    assert {s.call for s in spans} == {call.id}
    buckets = sorted((s for s in spans if s.name == "engine.bucket"), key=lambda s: s.start_ns)
    assert [b.counts["rows"] for b in buckets] == [4, 2, 1]
    assert all(b.parent == call.id for b in buckets)
    h2d = 0
    for b in buckets:
        kids = sorted((s for s in spans if s.parent == b.id), key=lambda s: s.start_ns)
        assert [k.name for k in kids] == ["engine.h2d", "engine.launch", "engine.d2h"]
        assert all(b.start_ns <= k.start_ns <= k.end_ns <= b.end_ns for k in kids)
        n = b.counts["rows"] * r * r * 3
        assert kids[0].counts["bytes"] == kids[0].counts["pageable_bytes"] == n
        assert kids[2].counts == {"bytes": b.counts["rows"] * cfg.d_emb * 4}
        h2d += kids[0].counts["bytes"]
    assert h2d == 7 * r * r * 3


def test_embeddings_are_the_same_recording_or_not(engine):
    eng, _, cfg = engine
    r = cfg.image_size
    imgs = np.random.default_rng(6).integers(0, 256, (7, r, r, 3), dtype=np.uint8)
    off = eng.embed_image_arrays(imgs)
    profiling.start_recording()
    try:
        on = eng.embed_image_arrays(imgs)
    finally:
        profiling.stop_recording()
    assert np.array_equal(off, on)


def test_engine_init_spans(engine, recording):
    """engine.init holds one engine.prepare a tower, with the tower's
    name and the bytes of its parameters placed."""
    _, params, cfg = engine
    EmbeddingEngine(params, cfg, max_batch=4, device="cpu")
    spans = recording()
    (init,) = [s for s in spans if s.name == "engine.init"]
    prep = [s for s in spans if s.name == "engine.prepare"]
    assert sorted(s.attrs["tower"] for s in prep) == ["img", "txt"]
    assert all(s.parent == init.id for s in prep)
    for s in prep:
        leaves = []
        stack = [params[s.attrs["tower"]]]
        while stack:
            t = stack.pop()
            if isinstance(t, dict):
                stack += list(t.values())
            elif isinstance(t, list):
                stack += t
            else:
                leaves.append(t)
        assert s.counts == {"bytes": sum(t.numel() * t.element_size() for t in leaves)}
