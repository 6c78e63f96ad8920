"""Port parity for the small tools, each against the JAX tool's output on
the same inputs: ``vec_dist``'s SVG, ``content_hash``, ``dump_tool
stats`` and ``sample``, its index chain (``kmeans``, ``shard``,
``build-shards``, ``pack``), ``get_embedding`` and ``load_embedding`` through
a live test server (aiohttp's test utilities) of the port's clip server,
``perf_test`` against a test server, and ``serve_synthetic``'s app
answering a search (both apps taken from their ``main`` with
``aiohttp.web.run_app`` replaced).
"""

import argparse
import asyncio
import json

import numpy as np
import pytest

from meme_search_engine_tpu.ingest.db import IngestDB as JaxIngestDB
from meme_search_engine_tpu.pipeline.dump import DumpWriter, OriginalImageMetadata, ProcessedEntry
from meme_search_engine_tpu.tools import content_hash as jhash
from meme_search_engine_tpu.tools import dump_tool as jdump_tool
from meme_search_engine_tpu.tools import get_embedding as jget
from meme_search_engine_tpu.tools import load_embedding as jload
from meme_search_engine_tpu.tools import perf_test as jperf
from meme_search_engine_tpu.tools import serve_synthetic as jsynth
from meme_search_engine_tpu.tools import vec_dist as jvec
from meme_search_engine_tpu_torch.ingest.db import IngestDB
from meme_search_engine_tpu_torch.models import siglip as ts
from meme_search_engine_tpu_torch.serving import clip_server
from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine
from meme_search_engine_tpu_torch.tools import content_hash as thash
from meme_search_engine_tpu_torch.tools import dump_tool as tdump_tool
from meme_search_engine_tpu_torch.tools import get_embedding as tget
from meme_search_engine_tpu_torch.tools import load_embedding as tload
from meme_search_engine_tpu_torch.tools import perf_test as tperf
from meme_search_engine_tpu_torch.tools import serve_synthetic as tsynth
from meme_search_engine_tpu_torch.tools import vec_dist as tvec


def test_vec_dist_svg_equals_jax(tmp_path):
    data = np.random.default_rng(0).standard_normal((500, 16)).astype(np.float16)
    vectors = tmp_path / "v.bin"
    data.tofile(str(vectors))
    svgs = []
    for tool, tag in ((jvec, "jax"), (tvec, "torch")):
        out = tmp_path / f"{tag}.svg"
        tool.main(["--vectors", str(vectors), "--d-emb", "16", "--output", str(out)])
        svgs.append(out.read_text())
    assert svgs[0] == svgs[1]
    assert svgs[1].startswith("<svg") and "<rect" in svgs[1]


def test_content_hash_equals_jax(tmp_path, capsys):
    paths = []
    for i, payload in enumerate((b"hello", b"", bytes(range(256)) * 40)):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(payload)
        paths.append(str(p))
    jhash.main(paths)
    want = capsys.readouterr().out
    thash.main(paths)
    assert capsys.readouterr().out == want
    assert thash.content_hash(b"hello") == jhash.content_hash(b"hello")


def test_dump_tool_stats_and_sample_equal_jax(tmp_path, capsys):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "000000001.dump.zst")
    with DumpWriter(path) as w:
        for i in range(7):
            emb = rng.standard_normal(16).astype(np.float32)
            w.write(ProcessedEntry(
                url=f"u{i % 5}", id=f"i{i}", title="t", subreddit="s", author="a", timestamp=i,
                embedding=emb, metadata=OriginalImageMetadata("image/png", 1, (2, 2), f"f{i}")))
    outs = []
    for tool in (jdump_tool, tdump_tool):
        tool.main(["stats", "--dumps", path])
        outs.append(json.loads(capsys.readouterr().out.strip()))
    assert outs[0] == outs[1] and outs[1]["entries"] == 7
    samples = []
    for tool, tag in ((jdump_tool, "jax"), (tdump_tool, "torch")):
        out = tmp_path / f"{tag}.bin"
        tool.main(["sample", "--dumps", path, "--fraction", "1.0", "--output", str(out)])
        samples.append(np.fromfile(str(out), np.float16))
    capsys.readouterr()
    np.testing.assert_array_equal(samples[0], samples[1])


def test_dump_tool_index_chain_equals_jax(tmp_path, capsys):
    """sample -> kmeans -> shard -> build-shards -> pack through both
    tools' ``main`` (the port's with ``--device cpu``) on a 300-entry dump,
    as test_scale_bench_matches_jax holds the same stages. The port's
    k-means and graph builds draw their own noise and break near ties their
    own way, so they are held as tests/test_torch_{kmeans,build_shard}.py
    hold them: unit centroids whose largest top-1 cluster is within 10% of
    the JAX run's, and graphs with the JAX build's headers and in-range
    edges of at most r a node. Given the JAX run's centroids the split is
    the JAX tool's byte for byte (manifest and shard inputs), and given
    its graphs as well, so are the packed index files."""
    from meme_search_engine_tpu.index.opq import ProductQuantizer
    from meme_search_engine_tpu_torch.index.kmeans import load_centroids
    from meme_search_engine_tpu_torch.pipeline.formats import read_shard_output

    d, r, rng = 16, 8, np.random.default_rng(2)
    dump = str(tmp_path / "000000001.dump.zst")
    with DumpWriter(dump) as w:
        for i in range(300):
            emb = rng.standard_normal(d).astype(np.float32)
            w.write(ProcessedEntry(
                url=f"u{i}", id=f"i{i}", title="t", subreddit="s", author="a", timestamp=i,
                embedding=emb / np.linalg.norm(emb),
                metadata=OriginalImageMetadata("image/png", 1, (2, 2), f"f{i}")))
    rot, _ = np.linalg.qr(rng.standard_normal((d, d)))
    opq = tmp_path / "opq.msgpack"
    opq.write_bytes(ProductQuantizer(rng.standard_normal((16, d)).astype(np.float32),
                                     rot.astype(np.float32), 4, d).to_msgpack())
    jw, tw = tmp_path / "jax", tmp_path / "torch"
    dims = ["--d-emb", str(d)]
    for tool, w, dev in ((jdump_tool, jw, []), (tdump_tool, tw, ["--device", "cpu"])):
        w.mkdir()
        tool.main(["sample", "--dumps", dump, "--fraction", "1.0", "--output", str(w / "sample.bin")])
        tool.main(["kmeans", "--sample", str(w / "sample.bin"), *dims, "--clusters", "3", "--max-iter", "20",
                   "--output", str(w / "centroids.bin"), *dev])
        tool.main(["shard", "--dumps", dump, "--centroids", str(jw / "centroids.bin"), *dims,
                   "--out-dir", str(w / "shards")])
        tool.main(["build-shards", "--shard-dir", str(w / "shards"), *dims, "--r", str(r), "--l", "16",
                   "--maxc", "32", "--batch-size", "128", *dev])
        tool.main(["pack", "--shard-dir", str(w / "shards"), "--out-dir", str(w / "index"),
                   "--opq", str(opq), *dev])
        assert "packed 300 nodes (0 dead)" in capsys.readouterr().out

    sample = np.fromfile(str(tw / "sample.bin"), np.float16).reshape(-1, d).astype(np.float32)
    counts = []
    for w in (jw, tw):
        c = load_centroids(str(w / "centroids.bin"), d)
        assert c.shape == (3, d)
        np.testing.assert_allclose(np.linalg.norm(c, axis=1), 1.0, atol=1e-3)
        counts.append(np.bincount((sample @ c.T).argmax(1), minlength=3).max())
    assert abs(counts[1] - counts[0]) <= 0.1 * counts[0], counts

    for s in range(3):
        graph = f"shards/shard_{s}.graph"
        (jh, _), (th, adj) = (read_shard_output(str(w / graph)) for w in (jw, tw))
        assert (th.id, th.max, th.centroid, th.mapping, th.medioid) == (jh.id, jh.max, jh.centroid,
                                                                        jh.mapping, jh.medioid)
        assert len(adj) == th.max and all(0 < len(row) <= r and row.max() < th.max for row in adj)
        (tw / graph).write_bytes((jw / graph).read_bytes())
    tdump_tool.main(["pack", "--shard-dir", str(tw / "shards"), "--out-dir", str(tw / "index"),
                     "--opq", str(opq), "--device", "cpu"])
    capsys.readouterr()

    names = ["sample.bin", "shards/manifest.json"] + [f"shards/shard_{s}.msgpack" for s in range(3)]
    names += [f"index/{p.name}" for p in sorted((jw / "index").iterdir())]
    assert "index/index.bin" in names
    for name in names:
        assert (tw / name).read_bytes() == (jw / name).read_bytes(), name


def test_dump_tool_pack_score_model_equals_jax(tmp_path, capsys):
    """``pack --score-model``: both tools pack one split (the JAX tool's
    sample, kmeans, shard and build-shards on a 300-entry dump) with one
    wide model (the port's export of a JAX ``init_ensemble`` at d 16,
    E 4, written by the port). Each scores every record, takes the CDFs
    of its scores and timestamps and buckets them: the descriptor codes
    and the headers must be equal, but where a score lies within 1e-6 of
    a CDF boundary (the two packages' fp32 sums differ in order), where a
    code may differ by one; the CDFs within 1e-6."""
    import jax

    from meme_search_engine_tpu.index.opq import ProductQuantizer
    from meme_search_engine_tpu.models import score_model as jsm
    from meme_search_engine_tpu_torch.models import score_model as tsm
    from meme_search_engine_tpu_torch.pipeline.formats import IndexHeader, read_shard_input

    d, rng = 16, np.random.default_rng(3)
    dump = str(tmp_path / "000000001.dump.zst")
    with DumpWriter(dump) as w:
        for i in range(300):
            emb = rng.standard_normal(d).astype(np.float32)
            w.write(ProcessedEntry(
                url=f"u{i}", id=f"i{i}", title="t", subreddit="s", author="a", timestamp=1000 + 7 * i,
                embedding=emb / np.linalg.norm(emb),
                metadata=OriginalImageMetadata("image/png", 1, (2, 2), f"f{i}")))
    rot, _ = np.linalg.qr(rng.standard_normal((d, d)))
    opq = tmp_path / "opq.msgpack"
    opq.write_bytes(ProductQuantizer(rng.standard_normal((16, d)).astype(np.float32),
                                     rot.astype(np.float32), 4, d).to_msgpack())
    cfg = dict(d_emb=d, n_hidden=1, n_ensemble=4, output_channels=3)
    tree = jax.tree.map(np.asarray, jsm.init_ensemble(jax.random.PRNGKey(1), jsm.ScoreModelConfig(**cfg)))
    wide = tsm.export_wide(tsm.params_from_jax(tree, device="cpu"), tsm.ScoreModelConfig(**cfg))
    model = str(tmp_path / "model.safetensors")
    wide.save_safetensors(model)
    dims, shards = ["--d-emb", str(d)], str(tmp_path / "shards")
    jdump_tool.main(["sample", "--dumps", dump, "--fraction", "1.0", "--output", str(tmp_path / "s.bin")])
    jdump_tool.main(["kmeans", "--sample", str(tmp_path / "s.bin"), *dims, "--clusters", "3",
                     "--max-iter", "20", "--output", str(tmp_path / "c.bin")])
    jdump_tool.main(["shard", "--dumps", dump, "--centroids", str(tmp_path / "c.bin"), *dims,
                     "--out-dir", shards])
    jdump_tool.main(["build-shards", "--shard-dir", shards, *dims, "--r", "8", "--l", "16",
                     "--maxc", "32", "--batch-size", "128"])
    for tool, tag, dev in ((jdump_tool, "jax", []), (tdump_tool, "torch", ["--device", "cpu"])):
        tool.main(["pack", "--shard-dir", shards, "--out-dir", str(tmp_path / tag), "--opq", str(opq),
                   "--score-model", model, *dev])
        assert "packed 300 nodes (0 dead)" in capsys.readouterr().out

    jh, th = (IndexHeader.load(str(tmp_path / tag / "index.msgpack")) for tag in ("jax", "torch"))
    assert len(th.descriptor_cdfs) == 4 and all(len(c) == 255 for c in th.descriptor_cdfs)
    np.testing.assert_allclose(th.descriptor_cdfs, jh.descriptor_cdfs, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(th.descriptor_cdfs[3], jh.descriptor_cdfs[3])  # timestamps
    cdfs = np.asarray(jh.descriptor_cdfs)
    th.descriptor_cdfs = jh.descriptor_cdfs = None
    assert th == jh
    name = "index.pq-codes.bin"
    assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    codes = [np.fromfile(str(tmp_path / tag / "index.descriptor-codes.bin"), np.uint8).reshape(300, 4)
             for tag in ("jax", "torch")]
    assert codes[1].max() > 200 and codes[1].min() < 50  # codes spread over the buckets
    # the scores packed: the corpus in id order, as pack builds it
    vectors = np.zeros((300, d), np.float32)
    for s in range(3):
        for rid, vec in read_shard_input(f"{shards}/shard_{s}.msgpack")[1]:
            vectors[rid] = vec
    scores = wide.score_batch(vectors, device="cpu")
    rows, cols = np.nonzero(codes[0] != codes[1])
    near = [c < 3 and np.abs(cdfs[c] - scores[r, c]).min() <= 1e-6 for r, c in zip(rows, cols)]
    steps = np.abs(codes[0][rows, cols].astype(int) - codes[1][rows, cols])
    assert all(near) and np.all(steps == 1), (
        f"{len(rows)} codes differ, {sum(near)} of them at a boundary tie within 1e-6")


def test_dump_tool_compute_subcommands_refuse_a_missing_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: k-means would run there")
    sample = tmp_path / "s.bin"
    np.zeros((8, 4), np.float16).tofile(str(sample))
    with pytest.raises(RuntimeError, match="cuda"):
        tdump_tool.main(["kmeans", "--sample", str(sample), "--d-emb", "4", "--clusters", "2",
                         "--output", str(tmp_path / "c.bin")])


def _tiny_clip_app():
    cfg = ts.tiny_test_config()
    import torch

    engine = EmbeddingEngine(ts.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), cfg,
                             max_batch=4, device="cpu")
    return engine, clip_server.make_app(engine, {"max_batch_size": 4})


def test_get_and_load_embedding_equal_jax(tmp_path, capsys):
    """Both packages' get_embedding against one live clip server (the
    port's, tiny weights on the CPU) print the same permalink; both
    load_embedding tools store it alike."""
    from aiohttp.test_utils import TestServer
    from PIL import Image

    engine, app = _tiny_clip_app()
    image = tmp_path / "x.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (30, 20, 3), dtype=np.uint8)).save(image)

    async def run():
        server = TestServer(app, host="127.0.0.1")
        await server.start_server()
        url = f"http://127.0.0.1:{server.port}"
        loop = asyncio.get_running_loop()
        try:
            outs = {}
            for tool, tag in ((jget, "jax"), (tget, "torch")):
                for kind, arg in (("text", "a cat"), ("image", str(image))):
                    argv = ["--server", url, f"--{kind}", arg,
                            "--output", str(tmp_path / f"{tag}_{kind}.bin")]
                    await loop.run_in_executor(None, tool.main, argv)
                    outs[tag, kind] = capsys.readouterr().out.strip()
            return outs
        finally:
            await server.close()

    outs = asyncio.run(run())
    for kind in ("text", "image"):
        assert outs["jax", kind] == outs["torch", kind]
        assert (tmp_path / f"jax_{kind}.bin").read_bytes() == (tmp_path / f"torch_{kind}.bin").read_bytes()
    want = engine.embed_texts(["a cat"])[0]
    got = np.frombuffer((tmp_path / "torch_text.bin").read_bytes(), np.float16).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=1e-3)

    link = "https://host/?e=" + outs["torch", "text"].rstrip("=")
    jload.main(["--db", str(tmp_path / "jax.db"), "--name", "Cat", "--url", link])
    tload.main(["--db", str(tmp_path / "torch.db"), "--name", "Cat", "--url", link])
    capsys.readouterr()
    stored_j = JaxIngestDB(str(tmp_path / "jax.db")).predefined_embeddings()
    stored_t = IngestDB(str(tmp_path / "torch.db")).predefined_embeddings()
    assert set(stored_j) == set(stored_t) == {"Cat"}
    np.testing.assert_array_equal(stored_t["Cat"], stored_j["Cat"])
    np.testing.assert_allclose(stored_t["Cat"], got, atol=0)


def _synthetic_app(tool, monkeypatch, argv):
    """The app a serve_synthetic ``main`` would serve, with ``run_app``
    replaced so that nothing listens."""
    from aiohttp import web

    captured = {}

    def run_app(app, **kwargs):
        captured["app"] = app
        kwargs["loop"].close()

    monkeypatch.setattr(web, "run_app", run_app)
    tool.main(argv)
    return captured["app"]


def test_serve_synthetic_answers_a_search_as_jax(monkeypatch, capsys):
    from aiohttp.test_utils import TestClient, TestServer

    jax_app = _synthetic_app(jsynth, monkeypatch, ["--n", "600", "--d", "16", "--cpu"])
    port_app = _synthetic_app(tsynth, monkeypatch, ["--n", "600", "--d", "16", "--device", "cpu"])
    capsys.readouterr()
    q = np.random.default_rng(3).standard_normal(16).astype(np.float32)
    body = {"terms": [{"embedding": q.tolist()}], "k": 20}

    async def ask(app):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            resp = await client.post("/", json=body)
            assert resp.status == 200
            return await resp.json()
        finally:
            await client.close()

    want, got = asyncio.run(ask(jax_app)), asyncio.run(ask(port_app))
    assert [m[1] for m in got["matches"]] == [m[1] for m in want["matches"]]
    np.testing.assert_allclose([m[0] for m in got["matches"]], [m[0] for m in want["matches"]],
                               rtol=1e-5)
    assert len(got["matches"]) == 20


def test_serve_synthetic_refuses_a_missing_card(monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the index would live there")
    with pytest.raises(RuntimeError, match="cuda"):
        _synthetic_app(tsynth, monkeypatch, ["--n", "10", "--d", "4"])


def test_perf_test_against_a_test_server_reports_as_jax(monkeypatch, capsys):
    from aiohttp.test_utils import TestServer

    app = _synthetic_app(tsynth, monkeypatch, ["--n", "300", "--d", "16", "--device", "cpu"])
    capsys.readouterr()

    async def run():
        server = TestServer(app, host="127.0.0.1")
        await server.start_server()
        url = f"http://127.0.0.1:{server.port}"
        try:
            reports = []
            for tool in (jperf, tperf):
                await tool.run(argparse.Namespace(server=url, n=24, concurrency=4, d=16))
                reports.append(json.loads(capsys.readouterr().out.strip()))
            return reports
        finally:
            await server.close()

    jrep, trep = asyncio.run(run())
    assert set(trep) == set(jrep) == {"n", "qps", "p50_ms", "p95_ms", "p99_ms"}
    assert trep["n"] == jrep["n"] == 24
    assert trep["qps"] > 0 and 0 < trep["p50_ms"] <= trep["p95_ms"] <= trep["p99_ms"]
