"""The port's query servers over HTTP on the CPU (aiohttp's test client):
the disk query server (serving/disk_query_server.py) against the JAX
package's on one index behind one stub embedder, JSON for JSON; the
small-scale server's routes for the SPA and its search body round trip
(tests/test_frontend.py:95, :135) against the port's ``make_app`` +
``attach_frontend``; and the port's guard on ``MSE_SEARCH_INFLIGHT``.
"""

import asyncio
import base64
import os
import re

import numpy as np
import pytest

from meme_search_engine_tpu.index.disk_index import DiskIndex as JaxDiskIndex
from meme_search_engine_tpu.serving import disk_query_server as jserver
from meme_search_engine_tpu_torch.index.disk_index import DiskIndex
from meme_search_engine_tpu_torch.serving import disk_query_server as tserver
from meme_search_engine_tpu_torch.tools import synth_disk_index

N, D = 2000, 64


class _StubEmbedder:
    """Unit vectors drawn from each text, fp16 on the wire."""

    class config:
        embedding_size = D
        batch = 8
        image_size = (8, 8)

    async def embed_texts(self, texts):
        out = []
        for t in texts:
            v = np.random.default_rng(sum(t.encode()) + len(t)).standard_normal(D).astype(np.float32)
            out.append(v / np.linalg.norm(v))
        return np.stack(out).astype(np.float16).astype(np.float32)

    async def embed_image_bytes(self, images):
        raise NotImplementedError


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("disk_server") / "index")
    synth_disk_index.main(["--out", out, "--n", str(N), "--d", str(D), "--r", "8", "--shards", "3",
                           "--chunks", "8", "--device", "cpu"])
    return out


BODIES = [
    {"terms": [{"text": "a cat"}]},
    {"terms": [{"text": "a frog meme"}], "k": 5},
    {"terms": [{"text": "gpu"}, {"text": "funny dog", "weight": 0.5},
               {"embedding": [0.1] * D, "weight": -1.0}], "k": 12},
    {"terms": [{"text": "reaction image"}, {"predefined_embedding": "Meme", "weight": 0.5},
               {"predefined_embedding": "Aesthetic", "weight": -2.0}], "k": 10, "debug_enabled": True},
    {"terms": [{"embedding": [0.25] * D}, {"predefined_embedding": "Useful"}], "k": 8},
    {"terms": [{"text": "reaction image"}], "k": 10, "debug_enabled": True},  # [3] without sliders
]


def _drive(app):
    from aiohttp.test_utils import TestClient, TestServer

    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            got = {"init": await (await client.get("/")).json()}
            rsps = await asyncio.gather(*[client.post("/", json=b) for b in BODIES])
            got["queries"] = [await r.json() for r in rsps]
            got["statuses"] = [r.status for r in rsps]
            got["telemetry"] = (await client.post("/telemetry", json={"event": "search"})).status
            opt = await client.options("/")
            got["options"] = (opt.status, opt.headers.get("Access-Control-Allow-Origin"))
            return got
        finally:
            await client.close()

    return asyncio.new_event_loop().run_until_complete(run())


def test_disk_server_json_equals_jax(index_dir, tmp_path):
    """frontend_init, text, fused and slider queries, debug fields: the
    port's server answers the JAX package's JSON over one index."""
    embedder = _StubEmbedder()
    got = _drive(tserver.make_app(DiskIndex(index_dir), embedder, search_list=200,
                                  telemetry_path=str(tmp_path / "t.msgpack")))
    want = _drive(jserver.make_app(JaxDiskIndex(index_dir), embedder, search_list=200,
                                   telemetry_path=str(tmp_path / "j.msgpack")))
    assert got == want
    assert got["init"] == {"n_total": N, "predefined_embedding_names": tserver.DESCRIPTOR_NAMES, "d_emb": D}
    assert got["statuses"] == [200] * len(BODIES) and got["telemetry"] == 204
    assert [len(q["matches"]) for q in got["queries"]] == [20, 5, 12, 10, 8, 10]
    assert got["queries"][3]["matches"][0][5]["shards"] is not None
    # the sliders move the ranking
    assert [m[1] for m in got["queries"][3]["matches"]] != [m[1] for m in got["queries"][5]["matches"]]


def test_disk_server_metrics_and_telemetry(index_dir, tmp_path):
    pytest.importorskip("prometheus_client")
    from aiohttp.test_utils import TestClient, TestServer

    path = str(tmp_path / "t.msgpack")
    app = tserver.make_app(DiskIndex(index_dir), _StubEmbedder(), search_list=100, telemetry_path=path)

    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            for body in BODIES[:2]:
                assert (await client.post("/", json=body)).status == 200
            await client.post("/telemetry", json={"event": "search", "n": 1})
            return await (await client.get("/metrics")).text()
        finally:
            await client.close()

    text = asyncio.new_event_loop().run_until_complete(run())
    assert re.search(r"^mse_disk_queries_total 2\.0$", text, re.M)
    assert re.search(r"^mse_disk_node_reads_total [1-9]", text, re.M)
    assert re.search(r"^mse_disk_query_time_count 2\.0$", text, re.M)
    import msgpack

    with open(path, "rb") as f:  # the writer thread closed with the app
        assert list(msgpack.Unpacker(f, raw=False)) == [{"event": "search", "n": 1}]


# -- the small-scale server and the SPA (tests/test_frontend.py) -------------

F_N, F_D = 64, 32


class _RawOnlyEmbedder:
    class config:
        embedding_size = F_D

    async def embed_texts(self, texts):
        v = np.random.default_rng(len(texts)).standard_normal((len(texts), F_D)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    async def embed_image_bytes(self, blobs):
        raise RuntimeError("not used")


@pytest.fixture(scope="module")
def spa_html():
    from meme_search_engine_tpu_torch.serving.frontend import FRONTEND_DIR

    with open(os.path.join(FRONTEND_DIR, "index.html")) as f:
        return f.read()


@pytest.fixture(scope="module")
def small_app():
    from meme_search_engine_tpu_torch.index.flat import FlatIndex, IndexHandle
    from meme_search_engine_tpu_torch.ingest.filename import Actual
    from meme_search_engine_tpu_torch.serving.frontend import attach_frontend
    from meme_search_engine_tpu_torch.serving.query_server import make_app

    vecs = np.random.default_rng(0).standard_normal((F_N, F_D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    index = FlatIndex.build(vecs.astype(np.float16), [Actual(f"img{i}.png") for i in range(F_N)], device="cpu")
    app = make_app(IndexHandle(index), _RawOnlyEmbedder(), predefined={"aesthetic": vecs[0]},
                   formats=["jpegl", "VIDEO"], extensions={"jpegl": "jpg"})
    attach_frontend(app)
    return app


def test_every_spa_endpoint_is_routed(spa_html, small_app):
    paths = set(re.findall(r'fetch\(CONFIG\.backend \+ "([^"]*)"', spa_html)) | set(
        re.findall(r'sendBeacon\?\.\(CONFIG\.backend \+ "([^"]*)"', spa_html))
    assert paths >= {"/", "/telemetry"}
    routed = {r.resource.canonical for r in small_app.router.routes()}
    assert not [p for p in paths if p not in routed]
    assert "/ui" in routed


def _decode_embedding_js_port(b64: str) -> np.ndarray:
    """The SPA's decodeEmbedding/f16ToF32 (tests/test_frontend.py)."""
    raw = base64.b64decode(b64.replace("-", "+").replace("_", "/"))
    out = []
    for i in range(0, len(raw), 2):
        h = raw[i] | (raw[i + 1] << 8)
        s = -1.0 if h & 0x8000 else 1.0
        e, m = (h >> 10) & 0x1F, h & 0x3FF
        if e == 0:
            out.append(s * m * 2.0**-24)
        elif e == 31:
            out.append(float("nan") if m else s * float("inf"))
        else:
            out.append(s * (1 + m / 1024.0) * 2.0 ** (e - 15))
    return np.asarray(out, np.float32)


def test_spa_search_roundtrip_and_fields(small_app):
    """The body the SPA's search() builds, and every field it reads back."""
    from aiohttp.test_utils import TestClient, TestServer

    async def run():
        client = TestClient(TestServer(small_app))
        await client.start_server()
        try:
            init = await (await client.get("/")).json()
            assert init == {"n_total": F_N, "predefined_embedding_names": ["aesthetic"], "d_emb": F_D}
            emb = np.random.default_rng(5).standard_normal(F_D).astype(np.float16)
            qvec = _decode_embedding_js_port(base64.urlsafe_b64encode(emb.tobytes()).decode())
            np.testing.assert_array_equal(qvec, emb.astype(np.float32))
            out = await (await client.post("/", json={
                "terms": [{"weight": 1.0, "embedding": qvec.tolist()}], "k": 1000,
                "include_video": False, "debug_enabled": False})).json()
            assert out["formats"] == ["jpegl", "VIDEO"] and out["extensions"] == {"jpegl": "jpg"}
            assert 0 < len(out["matches"]) <= 1000
            score, fname, _key, mask, _dims = out["matches"][0][:5]
            assert isinstance(score, float) and fname.startswith("img") and isinstance(mask, int)
            scores = [m_[0] for m_ in out["matches"]]
            assert scores == sorted(scores, reverse=True)
            one = await (await client.post("/", json={"terms": [{"embedding": qvec.tolist()}], "k": 1})).json()
            assert len(one["matches"]) == 1
            rsp = await client.post("/telemetry", json={"event": "search", "data": {"terms": 1},
                                                        "instance": "t", "correlation": "t", "time": 0})
            assert rsp.status in (200, 204)
            page = await client.get("/ui")
            html = await page.text()
            assert page.status == 200 and "window.FRONTEND_CONFIG" in html and 'id="results"' in html
        finally:
            await client.close()

    asyncio.new_event_loop().run_until_complete(run())


@pytest.mark.parametrize("value,want", [("two", 2), ("", 2), ("1.5", 2), ("0", 1), ("3", 3), (None, 2)])
def test_search_inflight_parse_is_guarded(monkeypatch, value, want):
    """``MSE_SEARCH_INFLIGHT`` that is not an integer means the default (2)
    instead of raising at construction; the batcher still answers."""
    from meme_search_engine_tpu_torch.index.flat import FlatIndex, IndexHandle
    from meme_search_engine_tpu_torch.ingest.filename import Actual
    from meme_search_engine_tpu_torch.serving.query_server import SearchBatcher

    if value is None:
        monkeypatch.delenv("MSE_SEARCH_INFLIGHT", raising=False)
    else:
        monkeypatch.setenv("MSE_SEARCH_INFLIGHT", value)
    idx = FlatIndex.build(np.eye(4, dtype=np.float16), [Actual(str(i)) for i in range(4)], device="cpu")
    batcher = SearchBatcher(IndexHandle(idx))
    assert batcher._max_inflight == want
    _s, ids, _snap = asyncio.new_event_loop().run_until_complete(
        batcher.search(np.array([0, 1, 0, 0], np.float32), 1))
    assert ids.tolist() == [1]
