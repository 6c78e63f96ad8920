"""The port's flat index and search batcher against the JAX package's.

``FlatIndex.search`` answers as the JAX ``FlatIndex`` does on the same
fp16 corpus (ids equal, scores within 1e-5: both sum fp32 products of
the same fp16 rows, in different orders); ``IndexHandle.swap``; the
three ``SearchBatcher`` behaviours the JAX tests hold
(tests/test_wire_and_ingest.py:285-420); and the repair the port
carries: ``max_inflight=0`` answers (the JAX batcher never dispatches).
"""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from meme_search_engine_tpu.index.flat import FlatIndex as JaxFlatIndex
from meme_search_engine_tpu_torch.index.flat import FlatIndex, IndexHandle
from meme_search_engine_tpu_torch.ingest.filename import Actual
from meme_search_engine_tpu_torch.serving.query_server import SearchBatcher


def _index(rng, n, d):
    """Unit-norm fp16 rows, as the index holds embeddings."""
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs = (vecs / np.linalg.norm(vecs, axis=1, keepdims=True)).astype(np.float16)
    return vecs, FlatIndex.build(vecs, [Actual(f"f{i}") for i in range(n)], device="cpu")


@pytest.mark.parametrize("n,d,b,k", [(1000, 64, 3, 20), (40_000, 128, 2, 1000), (50, 16, 1, 80)])
def test_flat_search_matches_jax(n, d, b, k):
    """Several 16,384-row tiles, k past a tile's share, and k past N."""
    rng = np.random.default_rng(n)
    vecs, index = _index(rng, n, d)
    assert len(index) == n and index.d_emb == d
    assert index.vectors.dtype == torch.float16 and index.vectors.device.type == "cpu"
    jindex = JaxFlatIndex.build(vecs, [Actual(f"f{i}") for i in range(n)])
    q = rng.standard_normal((b, d)).astype(np.float32)
    s, i = index.search(q, k)
    js, ji = jindex.search(q, k)
    assert s.dtype == np.float32 and i.dtype == np.int32
    assert s.shape == i.shape == js.shape == (b, min(k, n))
    np.testing.assert_allclose(s, js, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(i, ji)
    # one query as a vector, as execute_query passes it
    s1, i1 = index.search(q[0], k)
    np.testing.assert_array_equal(i1[0], i[0])


def test_flat_build_refuses_mismatched_filenames_and_a_missing_card():
    vecs = np.zeros((3, 8), np.float16)
    with pytest.raises(ValueError, match="filenames"):
        FlatIndex.build(vecs, [Actual("a")], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            FlatIndex.build(vecs, [Actual(c) for c in "abc"])  # cuda by default


def test_index_handle_swap():
    rng = np.random.default_rng(1)
    _, a = _index(rng, 10, 8)
    _, b = _index(rng, 20, 8)
    handle = IndexHandle()
    assert handle.index is None
    assert handle.swap(a) is None and handle.index is a
    assert handle.swap(b) is a and handle.index is b


def test_search_batcher_fuses_concurrent_dispatches():
    """Queries that arrive while a dispatch is in flight ride one device
    call; batch rows and k are powers of two; each caller gets its own
    exact top-k rows and the snapshot it searched."""
    rng = np.random.default_rng(0)
    n, d = 256, 32
    vecs, index = _index(rng, n, d)
    calls = []
    real_search = index.search

    def counting_search(queries, k):
        calls.append((len(queries), k))
        return real_search(queries, k)

    index.search = counting_search
    batcher = SearchBatcher(IndexHandle(index))
    qs = rng.standard_normal((12, d)).astype(np.float32)
    ks = [5, 20, 3, 20, 7, 20, 5, 3, 20, 7, 5, 3]

    async def run():
        return await asyncio.gather(*[batcher.search(qs[i], ks[i]) for i in range(12)])

    results = asyncio.new_event_loop().run_until_complete(run())
    assert len(calls) < 12, calls
    for b, k in calls:
        assert b & (b - 1) == 0 and k & (k - 1) == 0, calls
    oracle = qs @ vecs.astype(np.float32).T
    for i, (s, idx, snap) in enumerate(results):
        assert snap is index
        assert s.shape == (ks[i],) and idx.shape == (ks[i],)
        assert set(idx.tolist()) == set(np.argsort(-oracle[i])[: ks[i]].tolist())


def test_search_batcher_pipelines_two_inflight():
    """With max_inflight=2 a slow dispatch does not hold back the next
    batch: two run at once, and every caller gets its own rows."""
    rng = np.random.default_rng(1)
    n, d = 128, 16
    vecs, index = _index(rng, n, d)
    concurrent = {"now": 0, "max": 0}
    lock = threading.Lock()
    real_search = index.search

    def slow_search(queries, k):
        with lock:
            concurrent["now"] += 1
            concurrent["max"] = max(concurrent["max"], concurrent["now"])
        time.sleep(0.05)
        try:
            return real_search(queries, k)
        finally:
            with lock:
                concurrent["now"] -= 1

    index.search = slow_search
    batcher = SearchBatcher(IndexHandle(index), max_batch=2, max_inflight=2)
    qs = rng.standard_normal((8, d)).astype(np.float32)

    async def run():
        return await asyncio.gather(*[batcher.search(qs[i], 5) for i in range(8)])

    results = asyncio.new_event_loop().run_until_complete(run())
    assert concurrent["max"] == 2, concurrent
    oracle = qs @ vecs.astype(np.float32).T
    for i, (s, idx, snap) in enumerate(results):
        assert snap is index
        assert set(idx.tolist()) == set(np.argsort(-oracle[i])[:5].tolist())


def test_search_batcher_resolves_waiters_on_any_drain_error():
    """An exception anywhere in the drain resolves every dequeued waiter
    with it, and the batcher keeps answering afterwards."""
    rng = np.random.default_rng(2)
    n, d = 64, 16
    _, index = _index(rng, n, d)
    batcher = SearchBatcher(IndexHandle(index))
    good = rng.standard_normal((d,)).astype(np.float32)
    bad = rng.standard_normal((d + 3,)).astype(np.float32)  # poisons np.stack

    async def run():
        r = await asyncio.gather(batcher.search(good, 5), batcher.search(bad, 5),
                                 return_exceptions=True)
        assert all(x is not None for x in r)
        assert any(isinstance(x, Exception) for x in r)
        s, idx, snap = await asyncio.wait_for(batcher.search(good, 5), 10.0)
        assert snap is index and idx.shape == (5,)

    asyncio.new_event_loop().run_until_complete(run())


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_search_batcher_answers_at_zero_inflight(how, monkeypatch):
    """MSE_SEARCH_INFLIGHT=0 (or max_inflight=0) is clamped to one
    runner: the queries are answered, within a time limit of their own,
    where the JAX batcher starts no drain task and waits forever."""
    rng = np.random.default_rng(3)
    vecs, index = _index(rng, 100, 16)
    if how == "environment":
        monkeypatch.setenv("MSE_SEARCH_INFLIGHT", "0")
        batcher = SearchBatcher(IndexHandle(index))
    else:
        batcher = SearchBatcher(IndexHandle(index), max_inflight=0)
    qs = rng.standard_normal((3, 16)).astype(np.float32)

    async def run():
        return await asyncio.wait_for(
            asyncio.gather(*[batcher.search(q, 4) for q in qs]), timeout=10.0)

    results = asyncio.new_event_loop().run_until_complete(run())
    oracle = qs @ vecs.astype(np.float32).T
    for i, (s, idx, _snap) in enumerate(results):
        assert set(idx.tolist()) == set(np.argsort(-oracle[i])[:4].tolist())


def test_search_batcher_answers_none_on_an_empty_index():
    batcher = SearchBatcher(IndexHandle(FlatIndex.build(np.zeros((0, 8), np.float16), [], device="cpu")))

    async def run():
        return await asyncio.wait_for(batcher.search(np.ones(8, np.float32), 3), 10.0)

    assert asyncio.new_event_loop().run_until_complete(run()) is None
