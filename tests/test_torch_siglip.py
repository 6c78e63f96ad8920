"""Port parity: meme_search_engine_tpu_torch.models against the JAX
package's SigLIP towers, on the same weights, images and token ids.

The JAX side runs as tests/test_siglip.py runs it on the CPU (Pallas in
interpret mode via attn_impl="fat_interpret", or the XLA path; for the
text tower also its TPU route, with ``fused_mha_pallas`` in interpret
mode); the port runs its plain versions. Tolerances as
tests/test_siglip.py:107-109 and :129-131: atol 5e-2 and cosine > 0.999.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meme_search_engine_tpu.models import siglip as js
from meme_search_engine_tpu_torch.models import convert
from meme_search_engine_tpu_torch.models import siglip as ts


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _so400m_width(attn_impl):
    """SO400M's width, heads and mlp_dim at depth 2 and 70 px (25 patches
    -> 32 padded rows), with a shrunken text tower so init stays cheap."""
    return dataclasses.replace(
        js.SO400M_14_384, depth=2, image_size=70, text_width=64, text_depth=1,
        text_mlp_dim=128, text_num_heads=4, vocab_size=128, text_len=16,
        attn_impl=attn_impl,
    )


def _port_cfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["param_dtype"] = torch.bfloat16
    return ts.SigLIPConfig(**fields)


@pytest.fixture(scope="module")
def tiny():
    cfg = js.tiny_fat_test_config("fat_interpret")
    params = js.init_params(jax.random.PRNGKey(2), cfg)
    tree = jax.tree.map(np.asarray, params)
    return cfg, params, tree, convert.params_from_numpy(tree, _port_cfg(cfg), "cpu")


def test_bridge_round_trips_every_leaf(tiny):
    cfg, params, tree, tp = tiny
    converted = convert.tree_from_numpy(tree, "cpu")
    n = 0
    for path, leaf in _paths(tree):
        got = _get(converted, path)
        want = np.asarray(leaf, np.float32)
        assert tuple(got.shape) == want.shape, path
        assert np.array_equal(got.float().numpy(), want), path
        assert (got.dtype == torch.bfloat16) == (leaf.dtype.name == "bfloat16"), path
        n += 1
    assert n == len(jax.tree.leaves(params))
    # the text tower's leaves are among them, and pass prepare_params as they are
    txt_paths = [p for p, _ in _paths(tree) if p[0] == "txt"]
    assert len(txt_paths) == len(jax.tree.leaves(params["txt"])) > 0
    for path in txt_paths:
        assert torch.equal(_get(tp, path), _get(converted, path)), path
    # params_from_numpy is that conversion followed by prepare_params
    prepared = ts.prepare_params(converted, _port_cfg(cfg))
    assert [p for p, _ in _paths(prepared)] == [p for p, _ in _paths(tp)]
    for (path, a), (_, b) in zip(_paths(prepared), _paths(tp)):
        assert torch.equal(a, b), path


def test_fat_layouts_equal_jax_assembly(tiny):
    cfg, params, _, tp = tiny
    blocks = params["img"]["blocks"]
    (wq, bq), (wk, bk), (wv, bv) = jax.vmap(
        lambda a: js._fat_qkv_weights(a, cfg.num_heads, cfg.width // cfg.num_heads)
    )(blocks["attn"])
    pb, pm = tp["img"]["blocks"], tp["img"]["map_head"]
    want_w = np.asarray(jnp.concatenate([wq, wk, wv], axis=2), np.float32)
    want_b = np.asarray(jnp.concatenate([bq, bk, bv], axis=1), np.float32)
    assert np.array_equal(pb["qkv"]["w"].float().numpy(), want_w)
    assert np.array_equal(pb["qkv"]["b"].float().numpy(), want_b)
    mh = params["img"]["map_head"]
    want_kv = np.asarray(jnp.concatenate([mh["k"]["w"], mh["v"]["w"]], axis=1), np.float32)
    assert np.array_equal(pm["kv"]["w"].float().numpy(), want_kv)
    m = cfg.mlp_dim
    w1, w2 = pb["fc1"]["w"], pb["fc2"]["w"]
    assert w1.shape[-1] % 128 == 0
    assert np.array_equal(
        w1[..., :m].float().numpy(), np.asarray(blocks["mlp"]["fc1"]["w"], np.float32)
    )
    assert not w1[..., m:].any() and not w2[:, m:].any()
    # the prepared tree holds each weight once: the unpacked leaves are gone
    assert set(pb) == {"ln1", "qkv", "o", "ln2", "fc1", "fc2"}
    assert set(pm) == {"probe", "q", "kv", "o", "ln", "mlp"}


def test_init_params_has_the_jax_tree_shape():
    jcfg = js.tiny_test_config()
    shapes = jax.eval_shape(lambda k: js.init_params(k, jcfg), jax.random.PRNGKey(0))
    tp = ts.init_params(_port_cfg(jcfg), torch.Generator().manual_seed(0), "cpu")
    jpaths = {p: (tuple(s.shape), s.dtype.name) for p, s in _paths(
        jax.tree.map(lambda s: s, shapes, is_leaf=lambda x: hasattr(x, "shape")))}
    tpaths = {p: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for p, t in _paths(tp)}
    assert jpaths == tpaths
    assert ts.param_count(tp) == js.param_count(js.init_params(jax.random.PRNGKey(0), jcfg))


def _encode_both(jcfg, params, imgs):
    """Both packages' image embeddings; the port's tree is converted for
    jcfg's route (the kernel layouts, or the source tree for "xla")."""
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, params), _port_cfg(jcfg), "cpu")
    e_j = np.asarray(js.encode_image(params, jnp.asarray(imgs), jcfg))
    e_t = ts.encode_image(tp, torch.from_numpy(imgs), _port_cfg(jcfg)).numpy()
    return e_j, e_t


def _assert_embeddings_close(e_t, e_j):
    assert e_t.dtype == np.float32 and e_t.shape == e_j.shape
    np.testing.assert_allclose(e_t, e_j, atol=5e-2)
    cos = (e_t * e_j).sum(-1)
    assert cos.min() > 0.999, cos


@pytest.mark.parametrize("attn_impl", ["fat_interpret", "xla"])
def test_encode_image_matches_jax_tiny(tiny, attn_impl):
    cfg, params, _, _ = tiny
    jcfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    imgs = np.random.default_rng(3).integers(0, 256, (2, 28, 28, 3), dtype=np.uint8)
    e_j, e_t = _encode_both(jcfg, {"img": params["img"]}, imgs)
    _assert_embeddings_close(e_t, e_j)


@pytest.mark.parametrize("attn_impl", ["fat_interpret", "xla"])
def test_encode_image_matches_jax_at_so400m_width(attn_impl):
    jcfg = _so400m_width(attn_impl)
    params = js.init_params(jax.random.PRNGKey(5), jcfg)
    params = {"img": params["img"]}  # the text tower plays no part
    imgs = np.random.default_rng(6).integers(0, 256, (2, 70, 70, 3), dtype=np.uint8)
    e_j, e_t = _encode_both(jcfg, params, imgs)
    _assert_embeddings_close(e_t, e_j)


@pytest.mark.parametrize("shape", [(2, 61, 45, 3), (1, 20, 25, 3)], ids=["down", "up"])
def test_resize_matches_jax_image_resize(shape):
    cfg = ts.tiny_fat_test_config()
    r = cfg.image_size
    x = np.random.default_rng(7).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(
        jax.image.resize(jnp.asarray(x, jnp.float32), (shape[0], r, r, 3), "bilinear", antialias=True)
    )
    want = want / 127.5 - 1.0
    got = ts.preprocess_image(torch.from_numpy(x), cfg).float().numpy()
    # one bf16 ulp at |v| <= 1 is 2**-8
    np.testing.assert_allclose(got, want, atol=2**-8)


def test_encode_image_needs_prepared_params():
    cfg = ts.tiny_fat_test_config()
    p = ts.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="prepare_params"):
        ts.encode_image(p, torch.zeros((1, 28, 28, 3), dtype=torch.uint8), cfg)
    prepared = ts.prepare_params(p, cfg)
    e = ts.encode_image(prepared, torch.zeros((1, 28, 28, 3), dtype=torch.uint8), cfg)
    # the MAP head pools to the tower width (= d_emb at SO400M)
    assert e.shape == (1, cfg.width) and torch.isfinite(e).all()
    # the plain route reads the source tree, which prepare_params leaves be
    xla = dataclasses.replace(cfg, attn_impl="xla")
    assert ts.prepare_params(p, xla)["img"] is p["img"]
    with pytest.raises(ValueError, match="fat-layout"):
        ts.encode_image(prepared, torch.zeros((1, 28, 28, 3), dtype=torch.uint8), xla)
    # the text tower's leaves pass through prepare_params as they are (its
    # MLP width, 128, needs no padding), beside the text routes' empty
    # layouts
    assert set(prepared["txt"]) == set(p["txt"]) | {"layouts"} and prepared["txt"]["layouts"] == {}
    for path, leaf in _paths(p["txt"]):
        assert _get(prepared["txt"], path) is leaf, path


# ---------------------------------------------------------------------------
# Text tower
# ---------------------------------------------------------------------------


def _so400m_text(depth=2):
    """SO400M's text tower (1152 wide, 16 heads of 72, MLP 4304, S=64) cut
    to ``depth`` layers with vocab 128, beside a tiny image tower."""
    return dataclasses.replace(
        js.tiny_test_config(), text_width=1152, text_depth=depth, text_mlp_dim=4304,
        text_num_heads=16, text_len=64, vocab_size=128, d_emb=1152,
    )


def _encode_text_both(jcfg, params, toks):
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, params), _port_cfg(jcfg), "cpu")
    e_j = np.asarray(js.encode_text(params, jnp.asarray(toks), jcfg))
    e_t = ts.encode_text(tp, torch.from_numpy(toks), _port_cfg(jcfg)).numpy()
    return e_j, e_t


@pytest.mark.parametrize("which", ["tiny", "so400m_text_width"])
def test_encode_text_matches_jax(which):
    jcfg = js.tiny_test_config() if which == "tiny" else _so400m_text()
    params = js.init_params(jax.random.PRNGKey(8), jcfg)
    params = {"txt": params["txt"]}
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size, (3, jcfg.text_len)).astype(np.int32)
    e_j, e_t = _encode_text_both(jcfg, params, toks)
    assert e_t.shape == (3, jcfg.d_emb)
    _assert_embeddings_close(e_t, e_j)
    np.testing.assert_allclose(np.linalg.norm(e_t, axis=-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("which", ["tiny", "so400m_text_width"])
def test_encode_text_matches_jax_tpu_route(monkeypatch, which):
    """The JAX text tower as it runs on a TPU: its mha() sends every
    self-attention layer to fused_mha_pallas, here in interpret mode."""
    from meme_search_engine_tpu.ops import attention as ja

    calls = []

    def tpu_mha(q, k, v, *, causal=False):
        assert not causal and q.shape[1] == k.shape[1] > 1
        calls.append(q.shape)
        return ja.fused_mha_pallas(q, k, v, interpret=True)

    monkeypatch.setattr(js, "mha", tpu_mha)
    jax.clear_caches()  # encode_text may have been traced with the XLA route
    jcfg = js.tiny_test_config() if which == "tiny" else _so400m_text()
    params = js.init_params(jax.random.PRNGKey(10), jcfg)
    params = {"txt": params["txt"]}
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size, (2, jcfg.text_len)).astype(np.int32)
    e_j, e_t = _encode_text_both(jcfg, params, toks)
    jax.clear_caches()
    assert calls, "the JAX text tower did not reach the patched mha"
    _assert_embeddings_close(e_t, e_j)


def test_token_ids_out_of_range_follow_jnp_take():
    """ids in [-V, -1] wrap; any other out-of-range id gives a NaN row."""
    jcfg = js.tiny_test_config()
    params = js.init_params(jax.random.PRNGKey(12), jcfg)
    v = jcfg.vocab_size
    toks = np.array([[0, 5, -1, -v, v, -v - 1, 2**20, 7]], np.int32)
    table = params["txt"]["token_emb"]
    want = np.asarray(jnp.take(table, jnp.asarray(toks), axis=0), np.float32)
    got = ts._embed_tokens(convert.tensor_from_numpy(table), torch.from_numpy(toks)).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got[0, :4]).all() and np.isnan(got[0, 4:7]).all()
    assert np.array_equal(got[0, 2], got[0, 2]) and np.array_equal(got[0, 3], got[0, 0])
    # through the whole tower: a NaN row poisons only its own text
    toks = np.ones((2, jcfg.text_len), np.int32)
    toks[1, 3] = v + 9
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, {"txt": params["txt"]}), _port_cfg(jcfg), "cpu")
    e_t = ts.encode_text(tp, torch.from_numpy(toks), _port_cfg(jcfg)).numpy()
    e_j = np.asarray(js.encode_text(params, jnp.asarray(toks), jcfg))
    assert np.isfinite(e_t[0]).all() and np.isnan(e_t[1]).all() and np.isnan(e_j[1]).all()
    np.testing.assert_allclose(e_t[0], e_j[0], atol=5e-2)
