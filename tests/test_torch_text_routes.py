"""Port parity for the text tower's other routes and the attention
helpers beside them, against the JAX package on the same numpy inputs.

- ``_encoder_text`` (the fused short-sequence encoder) against JAX
  ``_encoder_text(..., interpret=True)`` for each routing of its
  sub-blocks (``MSE_TEXT_QKV``, ``MSE_TEXT_O``, ``MSE_TEXT_MLP``), an odd
  batch too, atol 5e-2 as tests/test_siglip.py:182-262; at SO400M's text
  width the embeddings, atol 5e-2 and cosine > 0.999 (one bf16 ulp of the
  residual stream there is 2**-5: XLA's and torch's fp32 dots sum in
  another order, which may flip a rounding).
- ``encode_text`` under ``attn_impl="fat_interpret"`` against JAX's, in
  the config of tests/test_siglip.py:110-129 (atol 5e-2, cosine > 0.999).
- ``flash_mha`` against JAX ``flash_mha`` and ``mha_xla`` (rtol and atol
  2e-3, tests/test_attention.py:35-39); ``fat_layout_ok`` equal to JAX's.

On the CPU every kernel wrapper takes its plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meme_search_engine_tpu.models import siglip as js
from meme_search_engine_tpu.ops import attention as ja
from meme_search_engine_tpu_torch.models import convert
from meme_search_engine_tpu_torch.models import siglip as ts
from meme_search_engine_tpu_torch.ops import attention as ta
from meme_search_engine_tpu_torch.parallel.mesh import model_shards

ROUTES = {"default": (), "qkv_o": ("QKV", "O"), "all": ("QKV", "O", "MLP")}


def _port_cfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["param_dtype"] = torch.bfloat16
    return ts.SigLIPConfig(**fields)


def _route(monkeypatch, route):
    """Set the JAX package's routing variables; the port's flags."""
    for k in ("QKV", "O", "MLP"):
        monkeypatch.setenv(f"MSE_TEXT_{k}", "fused" if k in ROUTES[route] else "xla")
    return {f"fused_{k.lower()}": k in ROUTES[route] for k in ("QKV", "O", "MLP")}


def _bf16(x):
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("route,batch", [("default", 2), ("qkv_o", 2), ("all", 2),
                                         ("default", 3), ("all", 3)])
def test_encoder_text_matches_jax(monkeypatch, route, batch):
    cfg = js.tiny_test_config()
    blocks = js.init_params(jax.random.PRNGKey(6), cfg)["txt"]["blocks"]
    x = jnp.asarray(np.random.default_rng(7).standard_normal((batch, cfg.text_len, cfg.text_width)),
                    jnp.bfloat16)
    flags = _route(monkeypatch, route)
    want = np.asarray(js._encoder_text(x, blocks, cfg.text_num_heads, interpret=True), np.float32)
    tb = convert.tree_from_numpy(jax.tree.map(np.asarray, blocks))
    got = ts._encoder_text(_bf16(x.astype(jnp.float32)), tb, cfg.text_num_heads, **flags)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2)
    # the same math as the plain encoder (tests/test_siglip.py:198-214)
    np.testing.assert_allclose(
        got.float().numpy(), ts._encoder(_bf16(x.astype(jnp.float32)), tb, cfg.text_num_heads).float().numpy(),
        atol=5e-2)


@pytest.mark.parametrize("route", ["default", "all"])
def test_encoder_text_matches_jax_at_so400m_width(monkeypatch, route):
    """SO400M's text tower (1152 wide, 16 heads of 72, MLP 4304, S=64) at
    depth 2, the MLP padded to 4352 by prepare_params; embeddings through
    the final LN and the head."""
    jcfg = dataclasses.replace(
        js.tiny_test_config(), text_width=1152, text_depth=2, text_mlp_dim=4304,
        text_num_heads=16, text_len=64, vocab_size=128, d_emb=1152,
    )
    params = {"txt": js.init_params(jax.random.PRNGKey(8), jcfg)["txt"]}
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size, (2, jcfg.text_len)).astype(np.int32)
    flags = _route(monkeypatch, route)
    p = params["txt"]
    x = jnp.take(p["token_emb"], jnp.asarray(toks), axis=0) + p["pos_emb"][None]
    x = js._encoder_text(x, p["blocks"], jcfg.text_num_heads, interpret=True)
    e_j = js._dense(js._layer_norm(x, p["ln_final"])[:, -1], p["head"]).astype(jnp.float32)
    e_j = np.asarray(e_j / jnp.linalg.norm(e_j, axis=-1, keepdims=True))
    tcfg = _port_cfg(jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    assert tp["txt"]["blocks"]["mlp"]["fc1"]["w"].shape[-1] == 4352
    qkv = ts._text_layout(tp["txt"], "qkv", 72)
    e_t = ts._embed_text(tp, torch.from_numpy(toks), tcfg, encoder=lambda x: ts._encoder_text(
        x, tp["txt"]["blocks"], 16, qkv, **flags)).numpy()
    np.testing.assert_allclose(e_t, e_j, atol=5e-2)
    assert ((e_t * e_j).sum(-1) > 0.999).all()


def test_encode_text_fat_route_matches_jax():
    """attn_impl="fat_interpret" sends the text tower through the fat
    encoder (every key valid), as the JAX package does; its fat QKV is
    built once, on the route's first use."""
    jcfg = dataclasses.replace(js.tiny_fat_test_config("fat_interpret"), text_width=112,
                               text_num_heads=16, text_len=16)
    params = js.init_params(jax.random.PRNGKey(4), jcfg)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (3, jcfg.text_len)).astype(np.int32)
    e_j = np.asarray(js.encode_text(params, jnp.asarray(toks), jcfg))
    tcfg = _port_cfg(jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    assert tp["txt"]["layouts"] == {}
    e_t = ts.encode_text(tp, torch.from_numpy(toks), tcfg).numpy()
    np.testing.assert_allclose(e_t, e_j, atol=5e-2)
    assert ((e_t * e_j).sum(-1) > 0.999).all()
    (fat,) = tp["txt"]["layouts"]["fat"]
    assert set(fat) == {"ln1", "qkv", "o", "ln2", "fc1", "fc2"}
    assert fat["fc1"] is tp["txt"]["blocks"]["mlp"]["fc1"]  # the MLP is held once
    (wq, bq), (wk, bk), (wv, bv) = jax.vmap(lambda a: js._fat_qkv_weights(a, 16, 7))(
        params["txt"]["blocks"]["attn"])
    np.testing.assert_array_equal(fat["qkv"]["w"].float().numpy(),
                                  np.asarray(jnp.concatenate([wq, wk, wv], axis=2), np.float32))
    ts.encode_text(tp, torch.from_numpy(toks), tcfg)
    assert tp["txt"]["layouts"]["fat"][0] is fat
    # the plain route of the same tree
    xla = dataclasses.replace(tcfg, attn_impl="xla")
    e_x = ts.encode_text(tp, torch.from_numpy(toks), xla).numpy()
    np.testing.assert_allclose(e_x, e_t, atol=5e-2)


def test_fused_text_route_takes_the_card_only(monkeypatch):
    """MSE_TEXT_FUSED=1 routes the text tower to _encoder_text only where
    the weights lie on the card (the JAX package's "on a TPU"): on the CPU
    encode_text runs the plain encoder and builds no layout. The routes'
    layouts need prepare_params."""
    cfg = ts.tiny_test_config()
    source = ts.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tp = ts.prepare_params(source, cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, cfg.text_len)))
    plain = ts.encode_text(tp, toks, cfg)
    monkeypatch.setenv("MSE_TEXT_FUSED", "1")
    monkeypatch.setenv("MSE_TEXT_MLP", "fused")
    assert torch.equal(ts.encode_text(tp, toks, cfg), plain)
    assert tp["txt"]["layouts"] == {}
    with pytest.raises(ValueError, match="prepare_params"):
        ts._text_layout(source["txt"], "qkv", 16)


def test_text_mlp_padded_in_place_of_the_source():
    """prepare_params pads the text MLP's hidden width to the kernels'
    tile in place of the unpadded weights: zero columns of fc1 and zero
    rows of fc2, the plain route's output unchanged."""
    cfg = dataclasses.replace(ts.tiny_test_config(), text_mlp_dim=72)
    source = ts.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    tp = ts.prepare_params(source, cfg)
    fc1, fc2 = tp["txt"]["blocks"]["mlp"]["fc1"], tp["txt"]["blocks"]["mlp"]["fc2"]
    assert fc1["w"].shape[-1] == fc1["b"].shape[-1] == fc2["w"].shape[-2] == 128
    assert not fc1["w"][..., 72:].any() and not fc1["b"][..., 72:].any() and not fc2["w"][:, 72:].any()
    assert torch.equal(fc1["w"][..., :72], source["txt"]["blocks"]["mlp"]["fc1"]["w"])
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (3, cfg.text_len)))
    np.testing.assert_allclose(ts.encode_text(tp, toks, cfg).numpy(),
                               ts.encode_text(ts.prepare_params(source, cfg), toks, cfg).numpy())
    np.testing.assert_allclose(ts.encode_text(tp, toks, cfg).numpy(),
                               ts._embed_text(source, toks, cfg).numpy(), atol=1e-6)


@pytest.mark.parametrize("route", ["default", "all"])
def test_encoder_text_over_model_shards(route):
    """Two model shards (half the heads and half the hidden width each,
    the row-parallel terms chained) give the single tree's encoder output
    within the encoder tests' atol 5e-2 (tests/test_siglip.py:182-262):
    the chain rounds each partial sum to bf16, once more than one tree."""
    cfg = ts.tiny_test_config()
    whole = ts.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    shards = [s["txt"]["blocks"] for s in model_shards({"txt": whole["txt"]}, 2)]
    assert shards[1]["attn"]["o"]["b"].abs().sum() == 0 and shards[0]["attn"]["q"]["w"].shape[-1] == 32
    x = torch.randn((2, cfg.text_len, cfg.text_width), generator=torch.Generator().manual_seed(5)).to(torch.bfloat16)
    flags = {f"fused_{k}": route == "all" for k in ("qkv", "o", "mlp")}
    one = ts._encoder_text(x, whole["txt"]["blocks"], cfg.text_num_heads, **flags).float().numpy()
    two = ts._encoder_text(x, shards, cfg.text_num_heads, **flags).float().numpy()
    np.testing.assert_allclose(two, one, atol=5e-2)


@pytest.mark.parametrize("shape,block", [((2, 24, 4, 16), 8), ((1, 29, 2, 8), 16)],
                         ids=["even", "ragged_last_block"])
def test_flash_mha_matches_jax(shape, block):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    want = np.asarray(ja.flash_mha(jq, jk, jv, block_q=block, block_k=block))
    got = ta.flash_mha(*(torch.from_numpy(t) for t in (q, k, v)), block_q=block, block_k=block)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ja.mha_xla(jq, jk, jv)), rtol=2e-3, atol=2e-3)


def test_fat_layout_ok_equals_jax():
    grid = [(h, d, sp) for h in (1, 2, 4, 8, 12, 16, 32) for d in (7, 8, 15, 16, 64, 72, 80, 128)
            for sp in (16, 24, 64, 200, 736)]
    assert [ta.fat_layout_ok(*g) for g in grid] == [ja.fat_layout_ok(*g) for g in grid]
    assert ta.fat_layout_ok(16, 72, 64) and ta.fat_layout_ok(8, 72, 736)  # SO400M's text, a tp shard
