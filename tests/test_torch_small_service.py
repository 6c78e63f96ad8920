"""The small-scale service end to end, the port against the JAX package,
as tests/test_e2e_small.py runs the JAX one: one folder of six images is
ingested by both packages with the tiny test config's weights (the JAX
``init_params`` from seed 0, carried to the port through
``convert.params_from_numpy``), each builds its flat index, and both
query APIs answer the same requests.

Tolerances: the stored embeddings agree at cos >= 0.999 (the engines'
own tolerance, tests/test_torch_serving.py); query scores within 1e-2
(sums of those embeddings); everything else (file names and their order,
formats, dims, the wire and DB bytes) is equal.
"""

import asyncio
import os
import subprocess
import sys

import jax
import msgpack
import numpy as np
import pytest

from meme_search_engine_tpu.ingest import db as jdb
from meme_search_engine_tpu.ingest import filename as jfilename
from meme_search_engine_tpu.ingest import thumbnailer as jthumb
from meme_search_engine_tpu.ingest.pipeline import IngestService as JaxIngestService
from meme_search_engine_tpu.models import siglip as js
from meme_search_engine_tpu.serving import query_server as jqs
from meme_search_engine_tpu.serving import wire as jwire
from meme_search_engine_tpu.utils import fp16 as jfp16
from meme_search_engine_tpu_torch.ingest import db as tdb
from meme_search_engine_tpu_torch.ingest import filename as tfilename
from meme_search_engine_tpu_torch.ingest import thumbnailer as tthumb
from meme_search_engine_tpu_torch.ingest.pipeline import IngestService
from meme_search_engine_tpu_torch.models import convert
from meme_search_engine_tpu_torch.models import siglip as ts
from meme_search_engine_tpu_torch.serving import query_server as tqs
from meme_search_engine_tpu_torch.serving import wire as twire
from meme_search_engine_tpu_torch.serving.client import InProcessEmbedder
from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine
from meme_search_engine_tpu_torch.utils import fp16 as tfp16

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _library(path, n=6):
    from PIL import Image

    path.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)).save(path / f"img{i}.png")
    return path


def _config(tmp, lib, tag):
    return {
        "files": str(lib), "db_path": str(tmp / f"{tag}.db"), "thumbs_path": str(tmp / f"thumbs_{tag}"),
        "enable_thumbs": True, "tiny_model": True, "max_batch_size": 4, "device": "cpu",
    }


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    """(JAX service, port service, tmp dir, reload statuses), both reloaded."""
    tmp = tmp_path_factory.mktemp("small_service")
    lib = _library(tmp / "memes")
    jcfg = js.tiny_test_config()
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, js.init_params(jax.random.PRNGKey(0), jcfg)),
        ts.tiny_test_config(), "cpu")
    engine = EmbeddingEngine(tparams, ts.tiny_test_config(), max_batch=4, device="cpu")
    pconfig = _config(tmp, lib, "port")
    port = IngestService(pconfig, tdb.IngestDB(pconfig["db_path"]), InProcessEmbedder(engine))

    async def build():
        jsvc = await JaxIngestService.create(_config(tmp, lib, "jax"))
        return jsvc, await jsvc.reload(), await port.reload()

    jsvc, jstatus, pstatus = asyncio.new_event_loop().run_until_complete(build())
    return jsvc, port, tmp, (jstatus, pstatus)


def test_both_packages_index_the_library(services):
    jsvc, port, _, (jstatus, pstatus) = services
    assert "indexed 6 items" in jstatus and "indexed 6 items" in pstatus
    assert len(port.handle.index) == len(jsvc.handle.index) == 6
    assert port.handle.index.vectors.device.type == "cpu"
    assert port.formats == jsvc.formats and port.extensions == jsvc.extensions


def test_db_embeddings_agree(services):
    jsvc, port, _, _ = services
    want = {fn: (e, meta) for fn, e, _t, meta in jsvc.db.iter_indexable()}
    got = {fn: (e, meta) for fn, e, _t, meta in port.db.iter_indexable()}
    assert set(got) == set(want) and len(got) == 6
    for fn, (e, meta) in got.items():
        w, wmeta = want[fn]
        assert meta == wmeta == {"dimension": [48, 64]}
        assert float(e @ w / np.linalg.norm(e) / np.linalg.norm(w)) >= 0.999


def _ask(app_pair, bodies):
    """POST each body to both apps; returns [(jax json, port json)]."""
    from aiohttp.test_utils import TestClient, TestServer

    async def run():
        clients = [TestClient(TestServer(app)) for app in app_pair]
        for c in clients:
            await c.start_server()
        try:
            out = [[await (await c.get("/")).json() for c in clients]]
            for body in bodies:
                out.append([await (await c.post("/", json=body)).json() for c in clients])
            return out
        finally:
            for c in clients:
                await c.close()

    return asyncio.run(run())


def _apps(jsvc, port):
    return (
        jqs.make_app(jsvc.handle, jsvc.embedder, predefined=jsvc.predefined_embeddings,
                     formats=jsvc.formats, extensions=jsvc.extensions),
        tqs.make_app(port.handle, port.embedder, predefined=port.predefined_embeddings,
                     formats=port.formats, extensions=port.extensions),
    )


def test_query_api_agrees(services):
    """FrontendInit, then text, negative-weight, raw and mixed queries: the
    same files in the same order (swaps only between scores within the
    tolerance), scores within 1e-2, the same formats, masks and dims."""
    jsvc, port, _, _ = services
    d = port.embedder.config.embedding_size
    raw = np.random.default_rng(7).standard_normal(d)
    raw = (raw / np.linalg.norm(raw)).tolist()
    bodies = [
        {"terms": [{"text": "a cat"}], "k": 3},
        {"terms": [{"text": "a cat", "weight": -1.0}], "k": 6},
        {"terms": [{"embedding": raw}], "k": 6},
        {"terms": [{"text": "a cat"}, {"text": "dog", "weight": 0.5}, {"embedding": raw, "weight": -1.0}]},
    ]
    answers = _ask(_apps(jsvc, port), bodies)
    (jinit, pinit), replies = answers[0], answers[1:]
    assert pinit == jinit and pinit["n_total"] == 6 and pinit["d_emb"] == d
    for body, (want, got) in zip(bodies, replies):
        assert got["formats"] == want["formats"] and got["extensions"] == want["extensions"]
        assert len(got["matches"]) == len(want["matches"]) == body.get("k", 6)
        ws, gs = [m[0] for m in want["matches"]], [m[0] for m in got["matches"]]
        np.testing.assert_allclose(gs, ws, atol=1e-2)
        assert gs == sorted(gs, reverse=True)
        for pos, (gm, wm) in enumerate(zip(got["matches"], want["matches"])):
            assert gm[2:] == wm[2:] or gm[1] != wm[1]  # thumb key, mask, dims of the same file
            if gm[1] != wm[1]:  # a swap of two scores within the tolerance
                other = [m[1] for m in want["matches"]].index(gm[1])
                assert abs(ws[other] - ws[pos]) <= 1e-2, (body, got["matches"], want["matches"])
        assert {m[1] for m in got["matches"]} <= {f"img{i}.png" for i in range(6)}
        assert all(m[4] == [48, 64] for m in got["matches"])
    # the negative weight reverses the ranking of the positive one
    assert replies[1][1]["matches"][-1][1] == replies[0][1]["matches"][0][1]


def test_metrics_and_reload_endpoints(services):
    """/metrics serves the service's own registry (the JAX names, counted
    by the queries and the ingest), /reload runs the reingest."""
    pytest.importorskip("prometheus_client")
    from aiohttp.test_utils import TestClient, TestServer

    _, port, _, _ = services
    app = tqs.make_app(port.handle, port.embedder, reload_fn=port.reload,
                       formats=port.formats, extensions=port.extensions)

    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            await client.post("/", json={"terms": [{"text": "a cat"}], "k": 2})
            body = await (await client.get("/metrics")).text()
            reload = await (await client.post("/reload")).json()
            return body, reload
        finally:
            await client.close()

    body, reload = asyncio.run(run())
    assert "mse_queries_total" in body and 'mse_terms_total{type="text"}' in body
    assert 'mse_ingested_items_total{stage="embed"}' in body
    assert reload["status"].startswith("indexed 6 items")


def test_reingest_is_idempotent_and_thumbnails_written(services):
    _, port, tmp, _ = services
    stats = asyncio.new_event_loop().run_until_complete(port.ingest())
    assert stats.embedded == 0 and stats.deleted == 0 and stats.errors == 0
    thumbs = sorted(os.listdir(tmp / "thumbs_port"))
    assert len(thumbs) >= 6
    assert thumbs == sorted(os.listdir(tmp / "thumbs_jax"))  # same names, same formats


def test_databases_are_interchangeable(services):
    """Each package reads the other's SQLite state: the same rows."""
    jsvc, port, tmp, _ = services

    def rows(db):
        return sorted((fn, e.tobytes(), thumbs and sorted(thumbs), meta)
                      for fn, e, thumbs, meta in db.iter_indexable())

    assert rows(tdb.IngestDB(str(tmp / "jax.db"))) == rows(jsvc.db)
    assert rows(jdb.IngestDB(str(tmp / "port.db"))) == rows(port.db)
    assert [r[0] for r in rows(port.db)] == [r[0] for r in rows(jsvc.db)]


def test_copied_modules_agree_bit_for_bit():
    names = [tfilename.Actual("memes/a cat.png"), tfilename.Actual("ü/ß.jpg"),
             tfilename.VideoFrame("clips/v.mp4", 7), tfilename.VideoFrame("x.webm", 0)]
    for t in names:
        j = (jfilename.Actual(t.path) if isinstance(t, tfilename.Actual)
             else jfilename.VideoFrame(t.container, t.frame))
        raw = tfilename.encode_filename(t)
        assert raw == jfilename.encode_filename(j)
        assert tfilename.decode_filename(raw) == t
        assert tfilename.container_of(t) == jfilename.container_of(j)
        assert tthumb.thumbnail_hash_key(t.path if hasattr(t, "path") else t.container) == \
            jthumb.thumbnail_hash_key(t.path if hasattr(t, "path") else t.container)
    with pytest.raises(ValueError):
        tfilename.encode_filename(tfilename.Actual("\x00x"))
    v = np.random.default_rng(1).standard_normal(37).astype(np.float32)
    assert tfp16.encode_fp16_buffer(v) == jfp16.encode_fp16_buffer(v)
    np.testing.assert_array_equal(tfp16.decode_fp16_buffer(tfp16.encode_fp16_buffer(v)),
                                  jfp16.decode_fp16_buffer(jfp16.encode_fp16_buffer(v)))
    formats = sorted(tthumb.IMAGE_FORMATS) + [tthumb.VIDEO_FORMAT_NAME]
    assert formats == sorted(jthumb.IMAGE_FORMATS) + [jthumb.VIDEO_FORMAT_NAME]
    for picks in ([], formats[:1], formats[1:3] + [formats[-1]], formats):
        assert tthumb.format_bitmask(picks, formats) == jthumb.format_bitmask(picks, formats)
    body = {"terms": [{"text": "a", "weight": 0.5}, {"embedding": [0.25, -1.0]},
                      {"image": "aGk=", "predefined_embedding": "p"}],
            "k": 7, "include_video": True, "debug_enabled": False}
    treq, jreq = twire.parse_query_request(body), jwire.parse_query_request(body)
    assert repr(treq) == repr(jreq).replace("meme_search_engine_tpu.", "meme_search_engine_tpu_torch.")
    matches = [(0.5, "a.png", "key", 3, (48, 64)), (0.25, "b.png", "k2", 0, None)]
    assert twire.query_result_to_json(twire.QueryResult(matches, ["f"], {"f": ".x"})) == \
        jwire.query_result_to_json(jwire.QueryResult(matches, ["f"], {"f": ".x"}))
    assert twire.frontend_init_to_json(twire.FrontendInit(5, ["p"], 64)) == \
        jwire.frontend_init_to_json(jwire.FrontendInit(5, ["p"], 64))
    cfg = twire.InferenceServerConfig(batch=4, image_size=(28, 28), embedding_size=64, model="m")
    jcfg = jwire.InferenceServerConfig(batch=4, image_size=(28, 28), embedding_size=64, model="m")
    assert msgpack.packb(cfg.to_msgpack_dict()) == msgpack.packb(jcfg.to_msgpack_dict())


def test_service_modules_import_without_optional_packages():
    """In a fresh process where aiohttp, msgpack, PIL, zstandard and
    prometheus_client cannot be imported, every module of the small-scale
    service and of the disk deployment's serving path imports, plain file
    names encode, and the batcher answers over a CPU index."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('aiohttp', 'msgpack', 'PIL', 'zstandard', 'prometheus_client'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import asyncio\n"
        "import numpy as np\n"
        "import meme_search_engine_tpu_torch.index.flat as flat\n"
        "import meme_search_engine_tpu_torch.ingest.pipeline\n"
        "import meme_search_engine_tpu_torch.ingest.ocr\n"
        "import meme_search_engine_tpu_torch.ingest.video\n"
        "import meme_search_engine_tpu_torch.serving.client\n"
        "import meme_search_engine_tpu_torch.serving.frontend\n"
        "import meme_search_engine_tpu_torch.serving.query_server as qs\n"
        "import meme_search_engine_tpu_torch.serving.disk_query_server\n"
        "import meme_search_engine_tpu_torch.index.disk_index\n"
        "import meme_search_engine_tpu_torch.pipeline.processor\n"
        "import meme_search_engine_tpu_torch.pipeline.dump\n"
        "import meme_search_engine_tpu_torch.tools.scale_bench\n"
        "import meme_search_engine_tpu_torch.tools.generate_queries_bin\n"
        "from meme_search_engine_tpu_torch.ingest.filename import Actual, encode_filename, decode_filename\n"
        "assert decode_filename(encode_filename(Actual('a.png'))) == Actual('a.png')\n"
        "idx = flat.FlatIndex.build(np.eye(4, dtype=np.float16), [Actual(str(i)) for i in range(4)], device='cpu')\n"
        "b = qs.SearchBatcher(flat.IndexHandle(idx), max_inflight=0)\n"
        "s, i, _ = asyncio.run(b.search(np.array([0, 0, 1, 0], np.float32), 1))\n"
        "assert i.tolist() == [2]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('aiohttp', 'msgpack', 'PIL', 'jax', 'zstandard',\n"
        "                                                    'prometheus_client')\n"
        "       or m == 'meme_search_engine_tpu' or m.startswith('meme_search_engine_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
