"""Port parity: index/chainq.py of meme_search_engine_tpu_torch against the
JAX package's, on the CPU: Viterbi codes equal, optimal against exhaustive
enumeration (tests/test_chainq.py:27), and training's transform."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meme_search_engine_tpu.index import chainq as jc
from meme_search_engine_tpu_torch.index import chainq as tc

CPU = "cpu"
# train_chainq's transform after three Procrustes updates: the port's SVD
# runs in fp64, the JAX package's in fp32
TRANSFORM_TOL = 1e-4


def _chain_codebooks(rng, m, h, d):
    """Codebooks whose supports overlap only between neighbours."""
    dpc = d // m
    cb = np.zeros((m, h, d), np.float32)
    for i in range(m):
        lo, hi = i * dpc, min(d, (i + 2) * dpc)
        cb[i, :, lo:hi] = rng.standard_normal((h, hi - lo))
    return cb


@pytest.mark.parametrize("m,h,d,n", [(3, 4, 12, 16), (6, 16, 48, 500), (8, 32, 64, 300)])
def test_viterbi_codes_equal_jax(m, h, d, n):
    rng = np.random.default_rng(m)
    cb = _chain_codebooks(rng, m, h, d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    want = np.asarray(jc.viterbi_encode(jnp.asarray(x), jnp.asarray(cb)))
    got = tc.viterbi_encode(x, cb, device=CPU)
    assert got.dtype == torch.int32 and got.shape == (n, m)
    np.testing.assert_array_equal(got.numpy(), want)


def test_viterbi_chunks_rows_alike(monkeypatch):
    """The DP in row chunks (bounded (rows, H, H) memory) gives the codes of
    one pass."""
    rng = np.random.default_rng(2)
    cb = _chain_codebooks(rng, 5, 8, 40)
    x = rng.standard_normal((101, 40)).astype(np.float32)
    whole = tc.viterbi_encode(x, cb, device=CPU)
    monkeypatch.setattr(tc, "_STEP_BYTES", 4 * 8 * 8 * 7)  # 7 rows a chunk
    np.testing.assert_array_equal(tc.viterbi_encode(x, cb, device=CPU).numpy(), whole.numpy())


def test_viterbi_is_optimal():
    """The codes minimise ||x - sum c||^2 over all H^M combinations."""
    rng = np.random.default_rng(0)
    m, h, d = 3, 4, 12
    cb = _chain_codebooks(rng, m, h, d)
    x = rng.standard_normal((16, d)).astype(np.float32)
    codes = tc.viterbi_encode(x, cb, device=CPU).numpy()
    for n_i in range(16):
        best = min(np.sum((x[n_i] - sum(cb[i, c[i]] for i in range(m))) ** 2)
                   for c in itertools.product(range(h), repeat=m))
        got = np.sum((x[n_i] - sum(cb[i, codes[n_i, i]] for i in range(m))) ** 2)
        assert got <= best + 1e-4, (n_i, got, best)


def test_train_chainq_matches_jax():
    rng = np.random.default_rng(1)
    d, m, h = 16, 4, 8
    x = rng.standard_normal((256, d)).astype(np.float32)
    want = jc.train_chainq(x, m, h, n_iters=3, seed=0)
    got = tc.train_chainq(x, m, h, n_iters=3, seed=0, device=CPU)
    np.testing.assert_array_equal(got.codebooks, want.codebooks)
    np.testing.assert_allclose(got.transform, want.transform, rtol=0, atol=TRANSFORM_TOL)
    np.testing.assert_allclose(got.transform @ got.transform.T, np.eye(d), atol=1e-3)
    codes = got.encode(x, device=CPU)
    np.testing.assert_array_equal(codes, want.encode(x))
    xt = x @ got.transform.T
    recon = got.reconstruct(codes)
    assert np.mean((recon - xt) ** 2) < np.mean(xt**2)
    q = rng.standard_normal(d).astype(np.float32)
    lut = got.preprocess_query(q)
    np.testing.assert_allclose(lut, want.preprocess_query(q), rtol=0, atol=1e-3)
    adc = lut[np.arange(m)[None, :], codes].sum(1)
    assert np.corrcoef(adc, recon @ (q @ got.transform.T))[0, 1] > 0.99
    back = tc.ChainQuantizer.from_msgpack(got.to_msgpack())
    np.testing.assert_array_equal(back.encode(x[:16], device=CPU), codes[:16])
    jback = jc.ChainQuantizer.from_msgpack(got.to_msgpack())
    np.testing.assert_array_equal(jback.codebooks, got.codebooks)
