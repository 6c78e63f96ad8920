"""Port serving: the engine against the JAX engine on the same weights,
the clip server's msgpack wire contract (tests/test_e2e_small.py), and
the port's import hygiene (no JAX, no JAX package, no optional
dependencies for the engine and the inference worker)."""

import asyncio
import dataclasses
import io
import os
import shutil
import subprocess
import sys

import jax
import msgpack
import numpy as np
import pytest
import torch

from meme_search_engine_tpu.models import siglip as js
from meme_search_engine_tpu.serving.engine import EmbeddingEngine as JaxEngine
from meme_search_engine_tpu_torch.models import convert
from meme_search_engine_tpu_torch.models import siglip as ts
from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine, pow2_buckets
from meme_search_engine_tpu_torch.utils.fp16 import decode_fp16_buffer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_cfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["param_dtype"] = torch.bfloat16
    return ts.SigLIPConfig(**fields)


def test_pow2_buckets():
    assert pow2_buckets(1, 128) == [1]
    assert pow2_buckets(128, 128) == [128]
    assert pow2_buckets(100, 128) == [64, 32, 4]
    assert pow2_buckets(300, 128) == [128, 128, 32, 8, 4]
    assert sum(pow2_buckets(77, 16)) == 77 and max(pow2_buckets(77, 16)) <= 16
    assert pow2_buckets(5, 4) == [4, 1]


def test_engine_matches_jax_engine():
    """A 5-image request (buckets 4 + 1) gives the JAX engine's
    embeddings, as fp32 unit-norm numpy, with the same weights."""
    jcfg = dataclasses.replace(js.tiny_fat_test_config("fat_interpret"), d_emb=112)
    params = js.init_params(jax.random.PRNGKey(11), jcfg)
    imgs = np.random.default_rng(12).integers(0, 256, (5, 28, 28, 3), dtype=np.uint8)
    want = JaxEngine(params, jcfg, max_batch=4).embed_image_arrays(imgs)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, {"img": params["img"]}), _port_cfg(jcfg), "cpu"
    )
    engine = EmbeddingEngine(tparams, _port_cfg(jcfg), max_batch=4, device="cpu")
    got = engine.embed_image_arrays(imgs)
    assert got.dtype == np.float32 and got.shape == (5, 112)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=5e-2)
    assert ((got * want).sum(-1)).min() > 0.999
    # bucketed split equals the parts run alone
    parts = np.concatenate([engine.embed_image_arrays(imgs[:4]), engine.embed_image_arrays(imgs[4:])])
    np.testing.assert_allclose(got, parts, rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.embed_texts(["hello"])


@pytest.fixture(scope="module")
def tiny_engine():
    cfg = ts.tiny_test_config()
    params = ts.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return EmbeddingEngine(params, cfg, max_batch=4, device="cpu")


def test_clip_server_wire_contract(tiny_engine):
    from aiohttp.test_utils import TestClient, TestServer
    from PIL import Image

    from meme_search_engine_tpu_torch.serving.clip_server import make_app

    engine = tiny_engine

    async def run():
        app = make_app(engine, {"max_batch_size": 4, "model_name": "tiny"})
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            resp = await client.get("/config")
            cfg = msgpack.unpackb(await resp.read(), raw=False)
            assert cfg["embedding_size"] == engine.cfg.d_emb
            assert cfg["batch"] == 4 and cfg["image_size"] == [28, 28]

            resp = await client.get("/")
            assert resp.status == 204

            buf = io.BytesIO()
            Image.new("RGB", (30, 30), (255, 0, 0)).save(buf, "PNG")
            resp = await client.post("/", data=msgpack.packb({"images": [buf.getvalue()] * 2}))
            assert resp.status == 200
            out = msgpack.unpackb(await resp.read(), raw=False)
            assert len(out) == 2
            emb = decode_fp16_buffer(out[0])
            assert emb.shape == (engine.cfg.d_emb,)
            np.testing.assert_allclose(np.linalg.norm(emb), 1.0, atol=1e-2)

            # text waits for the text tower: the error path answers 500
            resp = await client.post("/", data=msgpack.packb({"text": ["hello world"]}))
            assert resp.status == 500
            assert "not ported" in msgpack.unpackb(await resp.read(), raw=False)

            # oversized batch -> 500 with error string
            resp = await client.post("/", data=msgpack.packb({"images": [buf.getvalue()] * 5}))
            assert resp.status == 500
            assert "max batch size" in msgpack.unpackb(await resp.read(), raw=False)

            resp = await client.get("/metrics")
            assert resp.status in (200, 501)
            if resp.status == 200:
                assert "modelserver_total_items" in await resp.text()
        finally:
            await client.close()

    asyncio.run(run())


def test_inference_worker_reports_errors_and_stops(tiny_engine):
    import queue

    from meme_search_engine_tpu_torch.serving.clip_server import InferenceWorker

    worker = InferenceWorker(tiny_engine)
    done = queue.Queue()
    worker.submit("image", np.zeros((3, 28, 28, 3), np.uint8), lambda ok, v: done.put((ok, v)))
    worker.submit("text", ["x"], lambda ok, v: done.put((ok, v)))
    ok, v = done.get(timeout=60)
    assert ok and v.shape == (3, 64)
    ok, v = done.get(timeout=60)
    assert not ok and "not ported" in v
    worker.stop(timeout=10)
    assert not worker._thread.is_alive()


def test_port_imports_no_jax_and_no_optional_packages():
    """In a fresh process (tests/conftest.py imports jax here), the port's
    modules and chip_smoke.py pull in neither JAX nor the JAX package, and
    the engine and inference worker need none of msgpack, aiohttp, PIL or
    prometheus_client."""
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine\n"
        "from meme_search_engine_tpu_torch.serving.clip_server import InferenceWorker\n"
        "import meme_search_engine_tpu_torch.models.convert\n"
        "import meme_search_engine_tpu_torch.ops._build\n"
        "lazy = [m for m in ('msgpack', 'aiohttp', 'PIL', 'prometheus_client') if m in sys.modules]\n"
        "assert not lazy, lazy\n"
        "import meme_search_engine_tpu_torch.serving.clip_server as cs\n"
        "cs.make_app\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'\n"
        "       or m == 'meme_search_engine_tpu' or m.startswith('meme_search_engine_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_cuda_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the engine would run there")
    cfg = ts.tiny_test_config()
    params = ts.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        EmbeddingEngine(params, cfg, max_batch=4)  # device defaults to "cuda"
    from meme_search_engine_tpu_torch.serving.clip_server import build_engine

    with pytest.raises(RuntimeError, match="cuda"):
        build_engine({"model_name": "tiny"})
    with pytest.raises(NotImplementedError, match="checkpoint"):
        build_engine({"checkpoint": "/nonexistent", "device": "cpu"})


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for cwd, script in ((ROOT, "chip_smoke.py"), (str(tmp_path), str(alone))):
        out = subprocess.run(
            [sys.executable, script], cwd=cwd, capture_output=True, text=True, timeout=120
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
