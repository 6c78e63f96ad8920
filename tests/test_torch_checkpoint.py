"""Port checkpoint loading: the numpy safetensors reader, ``load_hf_siglip``
against the JAX package's loader leaf for leaf, and the port's towers
against HuggingFace ``transformers.SiglipModel`` (as tests/test_hf_parity.py
holds the JAX towers, rtol = atol = 1e-4).

No real checkpoint is available offline, so the tests write their own
files: a HF-layout state dict for the tiny test config made with numpy,
and a tiny random-init ``SiglipModel`` where transformers is installed.
"""

import asyncio
import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

from meme_search_engine_tpu.models import siglip as js
from meme_search_engine_tpu_torch.models import siglip as ts
from meme_search_engine_tpu_torch.models.safetensors_io import read_safetensors


def _port_cfg(jcfg, dtype=torch.bfloat16):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["param_dtype"] = dtype
    return ts.SigLIPConfig(**fields)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _hf_state_dict(cfg, rng):
    """Every tensor the loaders read, in the HF SigLIP layout, fp32."""
    w, tw, m, tm = cfg.width, cfg.text_width, cfg.mlp_dim, cfg.text_mlp_dim

    def rn(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    sd = {}

    def layers(prefix, depth, d, md):
        for i in range(depth):
            p = f"{prefix}.layers.{i}."
            for n in ("layer_norm1", "layer_norm2"):
                sd[p + n + ".weight"], sd[p + n + ".bias"] = 1 + rn(d), rn(d)
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[p + f"self_attn.{n}.weight"], sd[p + f"self_attn.{n}.bias"] = rn(d, d), rn(d)
            sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"] = rn(md, d), rn(md)
            sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"] = rn(d, md), rn(d)

    layers("vision_model.encoder", cfg.depth, w, m)
    layers("text_model.encoder", cfg.text_depth, tw, tm)
    ps, hp = cfg.patch_size, "vision_model.head"
    sd.update({
        "vision_model.embeddings.patch_embedding.weight": rn(w, 3, ps, ps),
        "vision_model.embeddings.patch_embedding.bias": rn(w),
        "vision_model.embeddings.position_embedding.weight": rn(cfg.num_patches, w),
        "vision_model.post_layernorm.weight": 1 + rn(w),
        "vision_model.post_layernorm.bias": rn(w),
        f"{hp}.probe": rn(1, 1, w),
        f"{hp}.attention.in_proj_weight": rn(3 * w, w),
        f"{hp}.attention.in_proj_bias": rn(3 * w),
        f"{hp}.attention.out_proj.weight": rn(w, w),
        f"{hp}.attention.out_proj.bias": rn(w),
        f"{hp}.layernorm.weight": 1 + rn(w),
        f"{hp}.layernorm.bias": rn(w),
        f"{hp}.mlp.fc1.weight": rn(m, w),
        f"{hp}.mlp.fc1.bias": rn(m),
        f"{hp}.mlp.fc2.weight": rn(w, m),
        f"{hp}.mlp.fc2.bias": rn(w),
        "text_model.embeddings.token_embedding.weight": rn(cfg.vocab_size, tw),
        "text_model.embeddings.position_embedding.weight": rn(cfg.text_len, tw),
        "text_model.final_layer_norm.weight": 1 + rn(tw),
        "text_model.final_layer_norm.bias": rn(tw),
        "text_model.head.weight": rn(cfg.d_emb, tw),
        "text_model.head.bias": rn(cfg.d_emb),
        "logit_scale": np.array([2.5], np.float32),
        "logit_bias": np.array([-7.0], np.float32),
    })
    return sd


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    cfg = js.tiny_test_config()
    path = tmp_path_factory.mktemp("ckpt") / "model.safetensors"
    safetensors.numpy.save_file(_hf_state_dict(cfg, np.random.default_rng(0)), str(path))
    return cfg, str(path)


# ---------------------------------------------------------------------------
# The reader
# ---------------------------------------------------------------------------


def test_reader_matches_safetensors_numpy(tmp_path):
    rng = np.random.default_rng(1)
    tensors = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((7,)).astype(np.float16),
        "bf16": rng.standard_normal((2, 3, 4)).astype(ml_dtypes.bfloat16),
        "i64": rng.integers(-(2**40), 2**40, (4, 2)),
        "scalar": np.array(3.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }
    path = str(tmp_path / "x.safetensors")
    safetensors.numpy.save_file(tensors, path, metadata={"format": "np"})
    got = read_safetensors(path)
    assert set(got) == set(tensors)
    for name, want in tensors.items():
        t = got[name]
        assert tuple(t.shape) == want.shape, name
        if name == "bf16":
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.float().numpy(), want.astype(np.float32))
        else:
            assert t.numpy().dtype == want.dtype, name
            assert np.array_equal(t.numpy(), want), name


def test_reader_matches_safetensors_torch(tmp_path):
    g = torch.Generator().manual_seed(2)
    tensors = {
        "f32": torch.randn((4, 3), generator=g),
        "f16": torch.randn((5,), generator=g).half(),
        "bf16": torch.randn((3, 8), generator=g).bfloat16(),
        "i64": torch.randint(-(2**40), 2**40, (6,), generator=g),
    }
    path = str(tmp_path / "t.safetensors")
    safetensors.torch.save_file(tensors, path)
    got = read_safetensors(path)
    assert set(got) == set(tensors)
    for name, want in tensors.items():
        assert got[name].dtype == want.dtype, name
        assert torch.equal(got[name], want), name
    assert torch.equal(read_safetensors(path)["bf16"], safetensors.torch.load_file(path)["bf16"])


def test_reader_refuses_a_truncated_file(tmp_path):
    path = tmp_path / "bad.safetensors"
    safetensors.numpy.save_file({"a": np.ones(16, np.float32)}, str(path))
    data = path.read_bytes()
    path.write_bytes(data[:-8])
    with pytest.raises(ValueError, match="data_offsets"):
        read_safetensors(str(path))


# ---------------------------------------------------------------------------
# load_hf_siglip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_load_hf_siglip_matches_jax_leaf_for_leaf(tiny_checkpoint, dtype):
    jcfg, path = tiny_checkpoint
    jcfg = dataclasses.replace(jcfg, param_dtype=getattr(jax.numpy, dtype))
    want = js.load_hf_siglip(path, jcfg)
    got = ts.load_hf_siglip(path, _port_cfg(jcfg, getattr(torch, dtype)))
    jpaths = dict(_paths(jax.tree.map(np.asarray, want)))
    tpaths = dict(_paths(got))
    assert set(jpaths) == set(tpaths)
    for path_, leaf in jpaths.items():
        t = tpaths[path_]
        assert t.is_contiguous() and t.device.type == "cpu", path_
        assert str(t.dtype).replace("torch.", "") == leaf.dtype.name, path_
        assert tuple(t.shape) == leaf.shape, path_
        assert np.array_equal(t.float().numpy(), np.asarray(leaf, np.float32)), path_
    assert float(got["t"]) == 2.5 and float(got["b"]) == -7.0


def test_load_hf_siglip_reads_a_directory(tiny_checkpoint):
    jcfg, path = tiny_checkpoint
    import os

    a = ts.load_hf_siglip(os.path.dirname(path), _port_cfg(jcfg))
    b = ts.load_hf_siglip(path, _port_cfg(jcfg))
    for (pa, x), (pb, y) in zip(_paths(a), _paths(b)):
        assert pa == pb and torch.equal(x, y)


def test_clip_server_serves_a_checkpoint(tiny_checkpoint):
    """The "checkpoint" config key loads the file; a text POST answers 200
    with the engine's embeddings as fp16 buffers."""
    import msgpack
    from aiohttp.test_utils import TestClient, TestServer

    from meme_search_engine_tpu_torch.serving.clip_server import build_engine, make_app
    from meme_search_engine_tpu_torch.utils.fp16 import decode_fp16_buffer

    jcfg, path = tiny_checkpoint
    engine = build_engine({"checkpoint": path, "device": "cpu", "model_name": "tiny",
                           "max_batch_size": 4})
    want_tree = ts.load_hf_siglip(path, ts.tiny_test_config())
    assert torch.equal(engine.params["txt"]["token_emb"], want_tree["txt"]["token_emb"])
    texts = ["a red car", "two dogs on a beach", "x"]
    want = engine.embed_texts(texts)

    async def run():
        client = TestClient(TestServer(make_app(engine, {"max_batch_size": 4})))
        await client.start_server()
        try:
            resp = await client.post("/", data=msgpack.packb({"text": texts}))
            assert resp.status == 200
            out = msgpack.unpackb(await resp.read(), raw=False)
        finally:
            await client.close()
        return out

    out = asyncio.run(run())
    assert len(out) == 3
    got = np.stack([decode_fp16_buffer(b) for b in out])
    np.testing.assert_array_equal(got, want.astype(np.float16).astype(np.float32))


# ---------------------------------------------------------------------------
# The port's towers against transformers.SiglipModel
# ---------------------------------------------------------------------------

IMG, PATCH, WIDTH, DEPTH, HEADS, MLP = 28, 14, 64, 2, 4, 96
VOCAB, TEXT_LEN = 128, 16


@pytest.fixture(scope="module")
def hf_model_and_params(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.SiglipConfig(
        vision_config=dict(image_size=IMG, patch_size=PATCH, hidden_size=WIDTH,
                           num_hidden_layers=DEPTH, num_attention_heads=HEADS,
                           intermediate_size=MLP),
        text_config=dict(hidden_size=WIDTH, num_hidden_layers=DEPTH,
                         num_attention_heads=HEADS, intermediate_size=MLP,
                         vocab_size=VOCAB, max_position_embeddings=TEXT_LEN),
    )
    torch.manual_seed(0)
    model = transformers.SiglipModel(cfg).eval()
    path = tmp_path_factory.mktemp("hf") / "model.safetensors"
    safetensors.torch.save_file(model.state_dict(), str(path))
    ours = ts.SigLIPConfig(
        image_size=IMG, patch_size=PATCH, width=WIDTH, depth=DEPTH, mlp_dim=MLP,
        num_heads=HEADS, text_width=WIDTH, text_depth=DEPTH, text_mlp_dim=MLP,
        text_num_heads=HEADS, vocab_size=VOCAB, text_len=TEXT_LEN, d_emb=WIDTH,
        param_dtype=torch.float32, attn_impl="xla",
    )
    return model, ts.load_hf_siglip(str(path), ours), ours


def test_image_tower_matches_transformers(hf_model_and_params):
    model, params, cfg = hf_model_and_params
    pix = np.random.default_rng(0).uniform(-1, 1, (3, IMG, IMG, 3)).astype(np.float32)
    with torch.inference_mode():
        want = model.vision_model(pixel_values=torch.from_numpy(pix.transpose(0, 3, 1, 2))).pooler_output
    got = ts.encode_image(params, torch.from_numpy(pix), cfg, normalize=False, preprocessed=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_text_tower_matches_transformers(hf_model_and_params):
    model, params, cfg = hf_model_and_params
    toks = np.random.default_rng(1).integers(0, VOCAB, (3, TEXT_LEN))
    with torch.inference_mode():
        want = model.text_model(input_ids=torch.from_numpy(toks)).pooler_output
    got = ts.encode_text(params, torch.from_numpy(toks.astype(np.int32)), cfg, normalize=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_similarity_matches_transformers(hf_model_and_params):
    """Contrastive logits, logit scale and bias included."""
    model, params, cfg = hf_model_and_params
    rng = np.random.default_rng(2)
    pix = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    toks = rng.integers(0, VOCAB, (2, TEXT_LEN))
    with torch.inference_mode():
        want = model(input_ids=torch.from_numpy(toks),
                     pixel_values=torch.from_numpy(pix.transpose(0, 3, 1, 2))).logits_per_image
    zi = ts.encode_image(params, torch.from_numpy(pix), cfg, preprocessed=True)
    zt = ts.encode_text(params, torch.from_numpy(toks.astype(np.int32)), cfg)
    got = zi @ zt.T * params["t"].exp() + params["b"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
