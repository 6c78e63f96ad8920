"""Port parity: meme_search_engine_tpu_torch.ops.attention against the
JAX package's fat-layout Pallas kernel (interpret mode) on the same numpy
inputs, at the tiny test geometry and at SO400M's head geometry.

Valid rows only, atol 2e-2, as in tests/test_attention.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from meme_search_engine_tpu.ops import attention as ja
from meme_search_engine_tpu_torch.models.convert import tensor_from_numpy
from meme_search_engine_tpu_torch.ops import attention as ta

GEOMETRIES = [
    # (B, SP, n_valid, H, d)
    pytest.param(2, 16, 11, 16, 7, id="tiny"),
    pytest.param(2, 32, 27, 16, 72, id="so400m_heads"),
]


def _packed(rng, b, sp, n_valid, h, d):
    """Fat-layout packed [q | k | v] as the QKV projection emits it: q
    pre-scaled with const 1, k const 0 on valid rows and pad rows zero
    with -1e30 in the const column, v const 1."""
    c = ta.fat_width(d)
    f = np.zeros((b, sp, 3, h, c), np.float32)
    f[..., :d] = rng.standard_normal((b, sp, 3, h, d))
    f[:, :, 0, :, :d] *= 1.0 / d**0.5
    f[:, :, 0, :, d] = 1.0
    f[:, n_valid:, 1] = 0.0
    f[:, n_valid:, 1, :, d] = -1e30
    f[:, :, 2, :, d] = 1.0
    return f.reshape(b, sp, 3 * h * c).astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("b,sp,n_valid,h,d", GEOMETRIES)
def test_fat_vit_mha_packed_matches_jax(b, sp, n_valid, h, d):
    f = _packed(np.random.default_rng(0), b, sp, n_valid, h, d)
    want = np.asarray(
        ja.fat_vit_mha_packed(jnp.asarray(f), h, d, nq=2, interpret=True), np.float32
    )
    got = ta.fat_vit_mha_packed(tensor_from_numpy(f), h, d)
    assert got.dtype == torch.bfloat16 and got.shape == (b, sp, h * d)
    np.testing.assert_allclose(got.float().numpy()[:, :n_valid], want[:, :n_valid], atol=2e-2)


@pytest.mark.parametrize("b,sp,n_valid,h,d", GEOMETRIES)
def test_fat_vit_mha_matches_jax(b, sp, n_valid, h, d):
    f = _packed(np.random.default_rng(1), b, sp, n_valid, h, d)
    hc = h * ta.fat_width(d)
    q, k, v = (np.ascontiguousarray(f[..., i * hc : (i + 1) * hc]) for i in range(3))
    want = np.asarray(
        ja.fat_vit_mha(*map(jnp.asarray, (q, k, v)), h, d, nq=2, interpret=True), np.float32
    )
    got = ta.fat_vit_mha(*map(tensor_from_numpy, (q, k, v)), h, d)
    np.testing.assert_allclose(got.float().numpy()[:, :n_valid], want[:, :n_valid], atol=2e-2)


def test_fat_vit_mha_matches_masked_softmax():
    """The const-column mask and partition tricks equal plain masked
    attention over the valid keys (fp32 reference)."""
    b, sp, n_valid, h, d = 1, 16, 9, 4, 8
    f = _packed(np.random.default_rng(2), b, sp, n_valid, h, d)
    c = ta.fat_width(d)
    x = np.asarray(f, np.float32).reshape(b, sp, 3, h, c)
    q, k, v = x[:, :, 0, :, :d], x[:, :n_valid, 1, :, :d], x[:, :n_valid, 2, :, :d]
    s = np.einsum("bqhd,bkhd->bhqk", q, k)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v).reshape(b, sp, h * d)
    got = ta.fat_vit_mha_packed(tensor_from_numpy(f), h, d).float().numpy()
    np.testing.assert_allclose(got[:, :n_valid], ref[:, :n_valid], atol=2e-2)


def test_fat_width_and_cpu_path_counts_nothing():
    assert ta.fat_width(72) == 80 and ta.fat_width(7) == 8
    ta.reset_launches()
    f = _packed(np.random.default_rng(3), 1, 16, 11, 16, 7)
    ta.fat_vit_mha_packed(tensor_from_numpy(f), 16, 7)
    assert ta.launches == {"fat_vit_mha": 0}
    with pytest.raises(ValueError):
        ta.fat_vit_mha_packed(torch.empty((1, 16, 384), dtype=torch.bfloat16, device="meta"), 16, 7)
