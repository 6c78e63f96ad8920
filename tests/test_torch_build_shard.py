"""Port parity: the per-shard build of meme_search_engine_tpu_torch
(pipeline/build_shard.py and its copy of pipeline/formats.py) against the
JAX package's, on one shard input file, on the CPU (msgpack is here; the
GPU machine has none, so the file side is tested here only).
"""

import numpy as np
import pytest
import torch

from meme_search_engine_tpu.index import vamana as jv
from meme_search_engine_tpu.pipeline import build_shard as jbs
from meme_search_engine_tpu.pipeline import formats as jformats
from meme_search_engine_tpu_torch.index import vamana as tv
from meme_search_engine_tpu_torch.ops.mips import mips_topk
from meme_search_engine_tpu_torch.pipeline import build_shard as tbs
from meme_search_engine_tpu_torch.pipeline import formats as tformats

N_BASE, N_QUERY, D = 600, 50, 32
PARAMS = dict(r=16, l=32, maxc=64, batch_size=128, seed=3, pad_to=128)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """One shard input written by the port, built by both packages."""
    d = tmp_path_factory.mktemp("shard")
    base = _unit(np.random.default_rng(0), N_BASE, D)
    queries = _unit(np.random.default_rng(1), N_QUERY, D)
    ids = 1000 + 7 * np.arange(N_BASE)
    inp = str(d / "shard_0.msgpack")
    tformats.write_shard_input(inp, tformats.ShardInputHeader(id=5, centroid=[0.5] * D),
                               zip(ids.tolist(), base))
    out = {}
    out["jax"] = jbs.build_shard(inp, str(d / "jax.graph"), query_vectors=queries, **PARAMS)
    out["port"] = tbs.build_shard(inp, str(d / "port.graph"), query_vectors=queries, device="cpu", **PARAMS)
    return d, base, ids, out


def _graph(adjacency, r):
    g = np.full((len(adjacency), r), -1, np.int32)
    for i, row in enumerate(adjacency):
        g[i, : len(row)] = row
    return g


def test_headers_match_jax(shard):
    d, base, ids, out = shard
    th, jh = out["port"], out["jax"]
    assert (th.id, th.max, th.centroid, th.mapping) == (jh.id, jh.max, jh.centroid, jh.mapping)
    assert th.max == N_BASE and th.mapping == ids.tolist()
    assert th.medioid == jh.medioid < N_BASE
    head, adj = jformats.read_shard_output(str(d / "port.graph"))
    assert head.medioid == th.medioid and len(adj) == N_BASE
    assert all(len(row) and row.max() < N_BASE for row in adj)  # no base->query edges


def test_recall_matches_jax(shard):
    d, base, _ids, _out = shard
    fp16 = base.astype(np.float16).astype(np.float32)  # the shard file's vectors
    q = fp16[np.random.default_rng(2).permutation(N_BASE)[:64]]
    truth = mips_topk(torch.from_numpy(fp16), torch.from_numpy(q), 10)[1].numpy()
    cfg = tv.VamanaConfig(r=PARAMS["r"], l=PARAMS["l"])
    recall = {}
    for name in ("jax", "port"):
        head, adj = tformats.read_shard_output(str(d / f"{name}.graph"))
        ids = tv.search(fp16, _graph(adj, cfg.r), q, 10, cfg, start=head.medioid, device="cpu")[1]
        recall[name] = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, truth)]))
    assert recall["port"] > 0.8 and recall["port"] > recall["jax"] - 0.03, recall


def test_build_shard_graph_returns_the_stitched_graph():
    """The array entry point: OOD rows and pad rows kept, base rows
    stitched, as the file path writes them."""
    base = _unit(np.random.default_rng(4), 300, D)
    queries = _unit(np.random.default_rng(5), 20, D)
    graph, med = tbs.build_shard_graph(base, queries, r=8, l=16, maxc=32, batch_size=64,
                                       pad_to=64, device="cpu")
    assert graph.shape == (320, 8) and 0 <= med < 300
    assert not (graph[:300] >= 300).any() and graph.max() < 320
    assert ((graph[:300] >= 0).sum(axis=1) >= 1).all()
    assert med == jv.medioid_dev(jv._corpus_on_device(np.concatenate([base, queries]), "bf16"), 300)


def test_formats_round_trip_between_packages(tmp_path):
    rng = np.random.default_rng(6)
    vecs = _unit(rng, 5, 16)
    for writer, reader in ((tformats, jformats), (jformats, tformats)):
        p = str(tmp_path / f"in_{writer.__name__}.msgpack")
        writer.write_shard_input(p, writer.ShardInputHeader(id=2, centroid=[1.0, 2.0]), zip(range(5), vecs))
        head, recs = reader.read_shard_input(p)
        assert (head.id, head.centroid) == (2, [1.0, 2.0])
        np.testing.assert_array_equal(np.stack([v for _i, v in recs]), vecs.astype(np.float16).astype(np.float32))
        o = str(tmp_path / f"out_{writer.__name__}.graph")
        adj = [np.array([1, 2], np.uint32), np.array([], np.uint32), np.array([0], np.uint32)]
        writer.write_shard_output(o, writer.ShardHeader(id=2, max=3, centroid=[1.0], medioid=1, offsets=[],
                                                        mapping=[9, 8, 7]), adj)
        head, got = reader.read_shard_output(o)
        assert (head.max, head.medioid, head.mapping, head.offsets) == (3, 1, [9, 8, 7], [0, 8, 8, 12])
        assert [g.tolist() for g in got] == [a.tolist() for a in adj]
    entry = tformats.PackedIndexEntry(id=3, vector=vecs[0], vertices=[1, 2], timestamp=9, dimensions=(4, 5),
                                      scores=[0.5], url="u", shards=[1])
    assert entry.pack() == jformats.PackedIndexEntry(**vars(entry)).pack()
    assert jformats.PackedIndexEntry.unpack(entry.pack()).vertices == [1, 2]
