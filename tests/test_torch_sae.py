"""Port parity for the sparse autoencoder (``models/sae.py``) and its
tools (``models/sae_tools.py``), against the JAX package's.

The same parameters (the JAX ``init_sae``, carried across by
``params_from_jax``) and the same numpy rows go through both: the
reconstruction within 1e-5, the activation counts equal. Five training
steps against the JAX package's own step (``make_sae_train_step`` over
``optax.adamw``) on the same batches: every loss within 1e-5 relative,
every parameter within 1e-5 absolute, the counters equal; then
tests/test_score_model_sae.py's checks on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from meme_search_engine_tpu.models import sae as jsae
from meme_search_engine_tpu.models import sae_tools as jtools
from meme_search_engine_tpu_torch.index.flat import FlatIndex
from meme_search_engine_tpu_torch.models import sae as tsae
from meme_search_engine_tpu_torch.models import sae_tools as ttools


def _pair(d_emb, d_hidden, top_k, seed=0):
    jcfg = jsae.SAEConfig(d_emb=d_emb, d_hidden=d_hidden, top_k=top_k)
    params = jsae.init_sae(jax.random.PRNGKey(seed), jcfg)
    tparams = tsae.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, tsae.SAEConfig(d_emb=d_emb, d_hidden=d_hidden, top_k=top_k), tparams


def _structured(n=500, seed=7):
    """Low-rank unit rows, which an SAE reconstructs well."""
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((8, 16)).astype(np.float32)
    codes = np.abs(rng.standard_normal((n, 8)).astype(np.float32))
    x = codes @ basis
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("dims", [(16, 64, 8), (32, 128, 16)], ids=["h64", "h128"])
def test_sae_forward_matches_jax(dims):
    jcfg, jp, tcfg, tp = _pair(*dims)
    x = np.random.default_rng(6).standard_normal((10, dims[0])).astype(np.float32)
    jrecon, jcounts = jsae.sae_forward(jp, x, jcfg)
    recon, counts = tsae.sae_forward(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(jrecon), rtol=1e-5, atol=1e-5)
    assert counts.dtype == torch.int32 and counts.shape == (dims[1],)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert int(counts.sum()) <= 10 * dims[2]
    # tied init
    np.testing.assert_array_equal(tp["down_w"].numpy(), tp["up_w"].numpy().T)


def test_threshold_drops_ties_and_zeros():
    """Strict-greater masking at the (k+1)-th value: a row whose k-th and
    (k+1)-th values tie keeps fewer than k, a row of at most k positive
    values keeps none of its ReLU zeros, as the JAX function does."""
    d_emb, d_hidden, k = 4, 8, 3
    up = np.zeros((d_emb, d_hidden), np.float32)
    up[0] = [5, 4, 3, 3, 1, 0, -1, -2]  # row 0: 4th value ties the 3rd
    up[1] = [2, 1, 0, 0, 0, 0, -1, -1]  # row 1: two positives, then ReLU zeros
    params = {"up_w": up, "down_w": np.eye(d_hidden, d_emb, dtype=np.float32),
              "down_b": np.zeros(d_emb, np.float32)}
    x = np.eye(2, d_emb, dtype=np.float32)
    jcfg = jsae.SAEConfig(d_emb=d_emb, d_hidden=d_hidden, top_k=k)
    tcfg = tsae.SAEConfig(d_emb=d_emb, d_hidden=d_hidden, top_k=k)
    _, jcounts = jsae.sae_forward(jax.tree.map(jnp.asarray, params), x, jcfg)
    _, counts = tsae.sae_forward(tsae.params_from_jax(params, device="cpu"), torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(counts.numpy(), [2, 2, 0, 0, 0, 0, 0, 0])


def test_five_train_steps_match_jax():
    jcfg, jp, tcfg, tp = _pair(16, 128, 16)
    x = _structured()
    lr, steps, batch = 3e-3, 5, 128
    rng = np.random.default_rng(0)
    idx = [rng.integers(0, len(x), batch) for _ in range(steps)]

    opt = optax.adamw(lr)
    jstep = jsae.make_sae_train_step(jcfg, opt)
    state, jcounters, jlosses = opt.init(jp), jnp.zeros((128,), jnp.int32), []
    for i in idx:
        jp, state, loss, jcounters = jstep(jp, state, jnp.asarray(x[i]), jcounters)
        jlosses.append(float(loss))

    params = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tstep = tsae.make_sae_train_step(tcfg, torch.optim.AdamW(list(params.values()), lr=lr, **tsae.ADAMW_DEFAULTS))
    counters, losses = torch.zeros(128, dtype=torch.int32), []
    for i in idx:
        loss, counters = tstep(params, torch.from_numpy(x[i]), counters)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for k in jp:
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(counters.numpy(), np.asarray(jcounters))

    # train_sae draws the same batches from the same seed: the JAX one's
    # initial parameters give its result
    _, k_init = jax.random.split(jax.random.PRNGKey(0))
    start = tsae.params_from_jax(jax.tree.map(np.asarray, jsae.init_sae(k_init, jcfg)), device="cpu")
    jparams, jc = jsae.train_sae(x, jcfg, steps=steps, batch_size=batch, lr=lr, seed=0)
    got, c = tsae.train_sae(x, tcfg, steps=steps, batch_size=batch, lr=lr, seed=0, device="cpu",
                            params=start)
    for k in jparams:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(c, jc)
    assert not start["up_w"].requires_grad  # the start was copied


def test_sae_training_reconstructs():
    """tests/test_score_model_sae.py::test_sae_training_reconstructs on
    the port."""
    cfg = tsae.SAEConfig(d_emb=16, d_hidden=128, top_k=16)
    x = _structured()
    params, counters = tsae.train_sae(x, cfg, steps=300, batch_size=128, lr=3e-3, seed=0, device="cpu")
    recon, _ = tsae.sae_forward(params, torch.from_numpy(x[:100]), cfg)
    rel = float(np.linalg.norm(recon.numpy() - x[:100]) / np.linalg.norm(x[:100]))
    assert rel < 0.5, rel
    assert tsae.decoder_features(params).shape == (128, 16)
    assert counters.dtype == np.int32 and counters.sum() > 0


def test_sae_tools_equal_jax(tmp_path):
    """The memmap and the disk shuffle write what the JAX tools write; the
    exemplars through the port's FlatIndex, and their sheet, equal the
    JAX tools' over the same search."""
    rng = np.random.default_rng(1)
    data = rng.standard_normal((100, 8)).astype(np.float16)
    p_in = str(tmp_path / "e.bin")
    data.tofile(p_in)
    assert ttools.open_embeddings_memmap(p_in, 8).shape == (100, 8)
    outs = []
    for tools in (ttools, jtools):
        out = str(tmp_path / f"s_{tools.__name__.split('.')[0]}.bin")
        tools.shuffle_embeddings_file(p_in, out, 8, chunk=32, seed=0)
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]
    shuffled = np.frombuffer(outs[0], np.float16).reshape(100, 8)
    assert not np.array_equal(shuffled, data)
    assert sorted(map(tuple, shuffled.tolist())) == sorted(map(tuple, data.tolist()))

    _, jp, _, tp = _pair(8, 64, 4)
    library = rng.standard_normal((200, 8)).astype(np.float32)
    library /= np.linalg.norm(library, axis=1, keepdims=True)
    index = FlatIndex.build(library, [f"m{i}.png" for i in range(200)], device="cpu")

    def search(vec, k):
        scores, ids = index.search(vec, k)
        return [(float(s), index.filenames[i]) for s, i in zip(scores[0], ids[0])]

    features = [0, 5, 63]
    got = ttools.feature_exemplars(tp, search, features, k=5)
    assert got == jtools.feature_exemplars(jp, search, features, k=5)
    assert sorted(got) == features and all(len(v["positive"]) == 5 for v in got.values())
    sheet = ttools.exemplar_sheet_html(got, image_prefix="/img/")
    assert sheet == jtools.exemplar_sheet_html(got, image_prefix="/img/")
    assert "feature 63 (negative)" in sheet and 'src="/img/m' in sheet
