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


TEXTS = ["a cat on a mat", "Two DOGS", "", "memes about tpus and gpus", "x " * 80]


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's, max_batch 4, on the same weights."""
    jcfg = dataclasses.replace(js.tiny_fat_test_config("fat_interpret"), d_emb=112, text_width=112)
    params = js.init_params(jax.random.PRNGKey(11), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params), _port_cfg(jcfg), "cpu")
    engine = EmbeddingEngine(tparams, _port_cfg(jcfg), max_batch=4, device="cpu")
    return JaxEngine(params, jcfg, max_batch=4), engine


def _assert_unit_and_close(got, want, d):
    assert got.dtype == np.float32 and got.shape == (5, d)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=5e-2)
    assert ((got * want).sum(-1)).min() > 0.999


def test_engine_matches_jax_engine(engines):
    """A 5-image request (buckets 4 + 1) gives the JAX engine's
    embeddings, as fp32 unit-norm numpy, with the same weights; so do 5
    texts, through the same buckets."""
    jax_engine, engine = engines
    imgs = np.random.default_rng(12).integers(0, 256, (5, 28, 28, 3), dtype=np.uint8)
    got = engine.embed_image_arrays(imgs)
    _assert_unit_and_close(got, jax_engine.embed_image_arrays(imgs), 112)
    # bucketed split equals the parts run alone
    parts = np.concatenate([engine.embed_image_arrays(imgs[:4]), engine.embed_image_arrays(imgs[4:])])
    np.testing.assert_allclose(got, parts, rtol=1e-5, atol=1e-6)
    got = engine.embed_texts(TEXTS)
    _assert_unit_and_close(got, jax_engine.embed_texts(TEXTS), 112)
    parts = np.concatenate([engine.embed_texts(TEXTS[:4]), engine.embed_texts(TEXTS[4:])])
    np.testing.assert_allclose(got, parts, rtol=1e-5, atol=1e-6)


def test_engine_embed_tokens_matches_jax_engine(engines):
    jax_engine, engine = engines
    toks = np.random.default_rng(13).integers(0, 128, (5, 16))  # int64: cast to int32
    got = engine.embed_tokens(toks)
    _assert_unit_and_close(got, jax_engine.embed_tokens(toks), 112)
    np.testing.assert_array_equal(engine.embed_texts(TEXTS), engine.embed_tokens(engine.tokenizer(TEXTS)))


def test_siglip_tokenizer_copy_gives_the_jax_ids(tmp_path):
    """The tokenizers-backed class on a tiny word-level tokenizer.json
    written here: the same ids, sticky EOS and padding as the JAX copy."""
    tokenizers = pytest.importorskip("tokenizers")
    from meme_search_engine_tpu.serving import tokenizer as jt
    from meme_search_engine_tpu_torch.serving import tokenizer as tt

    vocab = {"[UNK]": 0, "</s>": 1, **{w: i + 2 for i, w in enumerate("a cat on mat two dogs memes x".split())}}
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.save(str(tmp_path / "tokenizer.json"))
    got = tt.load_tokenizer(str(tmp_path), 128, 16)
    assert isinstance(got, tt.SigLIPTokenizer)
    want = jt.load_tokenizer(str(tmp_path), 128, 16)(TEXTS)
    np.testing.assert_array_equal(got(TEXTS), want)
    assert (want[:, -1] == 1).all() and want[0, 0] == vocab["a"]


def test_hash_tokenizer_copy_gives_the_jax_ids():
    from meme_search_engine_tpu.serving import tokenizer as jt
    from meme_search_engine_tpu_torch.serving import tokenizer as tt

    for vocab, seq in ((32_000, 64), (128, 16)):
        np.testing.assert_array_equal(
            tt.HashTokenizer(vocab, seq)(TEXTS), jt.HashTokenizer(vocab, seq)(TEXTS)
        )
    assert isinstance(tt.load_tokenizer(None, 128, 16), tt.HashTokenizer)
    assert isinstance(tt.load_tokenizer("/nonexistent/tokenizer.json"), tt.HashTokenizer)


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

            # text: 200 with the engine's embeddings as fp16 buffers
            resp = await client.post("/", data=msgpack.packb({"text": ["hello world", "x"]}))
            assert resp.status == 200
            out = msgpack.unpackb(await resp.read(), raw=False)
            want = engine.embed_texts(["hello world", "x"]).astype(np.float16)
            assert len(out) == 2
            for b, w in zip(out, want):
                np.testing.assert_array_equal(decode_fp16_buffer(b), w.astype(np.float32))

            # oversized text batch -> 500 with error string
            resp = await client.post("/", data=msgpack.packb({"text": ["x"] * 5}))
            assert resp.status == 500
            assert "max batch size" in msgpack.unpackb(await resp.read(), raw=False)

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
    worker.submit("image", np.zeros((1, 28, 28), np.uint8), lambda ok, v: done.put((ok, v)))
    ok, v = done.get(timeout=60)
    assert ok and v.shape == (3, 64)
    ok, v = done.get(timeout=60)
    assert ok and v.shape == (1, 64)
    np.testing.assert_array_equal(v, tiny_engine.embed_texts(["x"]))
    ok, v = done.get(timeout=60)  # a malformed batch is reported, not raised
    assert not ok and isinstance(v, str)
    worker.stop(timeout=10)
    assert not worker._thread.is_alive()


def test_port_imports_no_jax_and_no_optional_packages():
    """In a fresh process (tests/conftest.py imports jax here), the port's
    modules and chip_smoke.py pull in neither JAX nor the JAX package, and
    the engine, the inference worker, the tokenizer, the checkpoint
    reader, the shard build (its file formats included) and the disk
    deployment's modules (dump, split and pack, the native IO, the disk
    index and server, ChainQ, the disk tools), the training and parallel
    layer (the loss, mesh, train step, sharded search, checkpoints, the
    dry run), the scraper and the small tools need none of msgpack,
    aiohttp, PIL, prometheus_client, tokenizers, safetensors, triton or
    zstandard to import; nothing builds the native library on import."""
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine\n"
        "from meme_search_engine_tpu_torch.serving.clip_server import InferenceWorker\n"
        "import meme_search_engine_tpu_torch.models.convert\n"
        "import meme_search_engine_tpu_torch.models.safetensors_io\n"
        "import meme_search_engine_tpu_torch.ops._build\n"
        "import meme_search_engine_tpu_torch.serving.tokenizer\n"
        "import meme_search_engine_tpu_torch.index.kmeans\n"
        "import meme_search_engine_tpu_torch.index.vamana\n"
        "import meme_search_engine_tpu_torch.ops.gather\n"
        "import meme_search_engine_tpu_torch.ops.mips\n"
        "import meme_search_engine_tpu_torch.pipeline.build_shard\n"
        "import meme_search_engine_tpu_torch.pipeline.dump\n"
        "import meme_search_engine_tpu_torch.pipeline.descriptors\n"
        "import meme_search_engine_tpu_torch.pipeline.processor\n"
        "import meme_search_engine_tpu_torch.index.native_io\n"
        "import meme_search_engine_tpu_torch.index.disk_index\n"
        "import meme_search_engine_tpu_torch.index.chainq\n"
        "import meme_search_engine_tpu_torch.serving.disk_query_server\n"
        "import meme_search_engine_tpu_torch.utils.timer\n"
        "import meme_search_engine_tpu_torch.utils.mallctl\n"
        "from meme_search_engine_tpu_torch.tools import (scale_bench, synth_disk_index, recall_sweep,\n"
        "    disk_serve_bench, ann_bench, generate_queries_bin)\n"
        "from meme_search_engine_tpu_torch.parallel import mesh, train, sharded, checkpoint, dryrun\n"
        "import meme_search_engine_tpu_torch.pipeline.scraper\n"
        "from meme_search_engine_tpu_torch.tools import (serve_synthetic, vec_dist, content_hash,\n"
        "    dump_tool, get_embedding, load_embedding, perf_test)\n"
        "from meme_search_engine_tpu_torch.models.siglip import siglip_loss\n"
        "lazy = [m for m in ('msgpack', 'aiohttp', 'PIL', 'prometheus_client', 'tokenizers',\n"
        "                    'safetensors', 'triton', 'zstandard') if m in sys.modules]\n"
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
    # the device is resolved before any checkpoint is read
    with pytest.raises(RuntimeError, match="cuda"):
        build_engine({"model_name": "tiny", "checkpoint": "/nonexistent"})


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
