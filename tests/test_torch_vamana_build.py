"""Port parity, whole builds: meme_search_engine_tpu_torch's build_graph,
robust_stitch and search on the fixtures of tests/test_vamana.py, on the
CPU, held to the JAX tests' own assertions and to the JAX build's recall
on the same input (within 0.03). Builds are judged by recall, as the
reference judges them (diskann/src/main.rs:101-137); two port builds with
one seed must give the same graph.
"""

import numpy as np
import pytest
import torch

from meme_search_engine_tpu.index import vamana as jv
from meme_search_engine_tpu_torch.index import vamana as tv
from meme_search_engine_tpu_torch.ops.mips import mips_topk

CPU = "cpu"
RECALL_GAP = 0.03


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _recall(ids, truth):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / truth.shape[1]
                          for a, b in zip(ids, truth)]))


def _search(x, graph, q, k, cfg):
    return tv.search(x, graph, q, k, cfg, device=CPU)


@pytest.fixture(scope="module")
def built():
    x = _unit(np.random.default_rng(0), 2000, 32)
    kw = dict(r=16, l=48, maxc=96, alpha=1.0, batch_size=256, query_breakpoint=2**31 - 1)
    cfg = tv.VamanaConfig(**kw)
    return x, tv.build_graph(x, cfg, seed=0, device=CPU), cfg, jv.build_graph(x, jv.VamanaConfig(**kw), seed=0)


def test_graph_wellformed_and_deterministic(built):
    x, graph, cfg, _ = built
    n = len(x)
    assert graph.shape == (n, cfg.r) and graph.dtype == np.int32
    assert graph[graph >= 0].max() < n and graph.min() >= -1
    assert (graph >= 0).sum(axis=1).min() >= 1
    assert (graph == np.arange(n)[:, None]).sum() < n * 0.02
    np.testing.assert_array_equal(tv.build_graph(x, cfg, seed=0, device=CPU), graph)


def test_self_recall_and_recall_at_10(built):
    x, graph, cfg, jgraph = built
    _s, ids, steps = _search(x, graph, x[:256], 1, cfg)
    assert (ids[:, 0] == np.arange(256)).mean() > 0.95 and steps > 0
    q = _unit(np.random.default_rng(7), 64, 32)
    truth = np.argsort(-(x @ q.T), axis=0)[:10].T
    got = _recall(_search(x, graph, q, 10, cfg)[1], truth)
    want = _recall(jv.search(x, jgraph, q, 10, jv.VamanaConfig(**vars(cfg)))[1], truth)
    assert got > 0.85, got
    assert got > want - RECALL_GAP, (got, want)


def test_ood_query_vectors_and_stitch():
    """tests/test_vamana.py::test_ood_query_vectors_and_stitch."""
    n_base, n_query = 600, 100
    x = _unit(np.random.default_rng(2), n_base + n_query, 16)
    cfg = tv.VamanaConfig(r=8, l=24, maxc=48, batch_size=128, query_breakpoint=n_base,
                          query_alpha=0.9, max_add_per_stitch_iter=4)
    graph = tv.build_graph(x, cfg, seed=1, device=CPU)
    assert _search(x, graph, x[:32], 5, cfg)[1].max() < n_base
    stitched = tv.robust_stitch(x, graph, cfg, device=CPU)
    assert (stitched[:n_base] >= n_base).sum() == 0
    assert (stitched[:n_base] >= 0).sum() >= (graph[:n_base][graph[:n_base] < n_base] >= 0).sum()
    np.testing.assert_array_equal(stitched[n_base:], graph[n_base:])


def test_mixed_batch_base_nodes_link_query_nodes():
    """tests/test_vamana.py::test_mixed_batch_base_nodes_link_query_nodes."""
    n_base, n_query = 300, 100
    x = _unit(np.random.default_rng(7), n_base + n_query, 16)
    cfg = tv.VamanaConfig(r=8, l=24, maxc=48, batch_size=64, query_breakpoint=n_base, query_alpha=0.9)
    graph = tv.build_graph(x, cfg, seed=3, device=CPU)
    assert int((graph[:n_base] >= n_base).sum()) > 0
    assert _search(x, graph, x[:16], 5, cfg)[1].max() < n_base


def test_int8_corpus_build_recall_parity():
    """tests/test_vamana.py::test_int8_corpus_build_recall_parity, with the
    port's mips_topk as the oracle, and the int8 build against JAX's."""
    rng = np.random.default_rng(11)
    n, d = 2000, 128
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    qs = vecs[rng.permutation(n)[:64]]
    oracle = mips_topk(torch.from_numpy(vecs), torch.from_numpy(qs), 10, tile=512)[1].numpy()
    recalls = {}
    for dtype in ("bf16", "int8"):
        cfg = tv.VamanaConfig(r=16, l=48, maxc=96, batch_size=256, corpus_dtype=dtype)
        recalls[dtype] = _recall(_search(vecs, tv.build_graph(vecs, cfg, seed=0, device=CPU), qs, 10, cfg)[1],
                                 oracle)
    assert recalls["int8"] > recalls["bf16"] - 0.05, recalls
    assert recalls["int8"] > 0.8, recalls
    jcfg = jv.VamanaConfig(r=16, l=48, maxc=96, batch_size=256, corpus_dtype="int8")
    jrecall = _recall(jv.search(vecs, jv.build_graph(vecs, jcfg, seed=0), qs, 10, jcfg)[1], oracle)
    assert recalls["int8"] > jrecall - RECALL_GAP, (recalls, jrecall)


def test_overflow_flush_window_recall_parity():
    """tests/test_vamana.py::test_overflow_flush_window_recall_parity: the
    immediate (1) and deferred (8) re-prune; build_graph checks its device
    mirror on the way."""
    x = _unit(np.random.default_rng(3), 2000, 32)
    qs = x[:200]
    exact = np.argsort(-(qs @ x.T), axis=1)[:, :10]
    recalls = {}
    for flush in (1, 8):
        cfg = tv.VamanaConfig(r=16, l=48, maxc=96, alpha=1.0, batch_size=256, overflow_flush_rounds=flush)
        recalls[flush] = _recall(_search(x, tv.build_graph(x, cfg, seed=0, device=CPU), qs, 10, cfg)[1], exact)
    assert recalls[8] > recalls[1] - 0.05, recalls
    assert recalls[8] > 0.8, recalls
