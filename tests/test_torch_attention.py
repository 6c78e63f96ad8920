"""Port parity: meme_search_engine_tpu_torch.ops.attention against the
JAX package's attention on the same numpy inputs.

- Plain-layout attention (B, S, H, Dh): the fused kernel's plain version
  against ``fused_mha_pallas`` in interpret mode and against ``mha_xla``
  (rtol = atol = 2e-3, as tests/test_attention.py:31), and the ``mha``
  dispatch.
- Fat-layout attention: the JAX fat Pallas kernel (interpret mode) at
  the tiny test geometry and at SO400M's head geometry; valid rows only,
  atol 2e-2, as in tests/test_attention.py. Also the zero-padded layout
  the card kernel reads at the tiny fat widths (``fat_pad``), attended
  with the plain version's cast points, against the unpadded plain
  version and the JAX kernel.
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


def _attend_padded(qf, kf, vf, h, d, cp):
    """The plain fat attention (cast points of fat_vit_mha_plain) over a
    layout whose heads are ``cp`` columns wide: the ones the kernel reads."""
    b, sp, _ = qf.shape
    q, k, v = (t.reshape(b, sp, h, cp).permute(0, 2, 1, 3).float() for t in (qf, kf, vf))
    s = q @ k.transpose(-1, -2)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(torch.bfloat16).float()
    o = p @ v
    o = o[..., :d] / o[..., d : d + 1]
    return o.permute(0, 2, 1, 3).reshape(b, sp, h * d).to(qf.dtype)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("b,sp,n_valid,h,d", GEOMETRIES)
def test_fat_pad_layout_gives_the_same_attention(b, sp, n_valid, h, d, packed):
    """The layout the card kernel reads (``fat_pad``: each head's
    fat_width(d) columns, then zeros up to kernel_width(d)), attended with
    the plain version's cast points, equals the unpadded plain result up
    to one bf16 rounding (rtol = atol = 2**-7: the zero columns change
    only the fp32 sums' order) and the JAX kernel in interpret mode (valid
    rows, atol 2e-2)."""
    f = _packed(np.random.default_rng(3), b, sp, n_valid, h, d)
    c, cp = ta.fat_width(d), ta.kernel_width(d)
    assert cp % 16 == 0 and cp - c < 16
    x = tensor_from_numpy(f)
    padded = ta.fat_pad(x, 3 * h, c, cp)
    heads = padded.reshape(b, sp, 3, h, cp)
    assert padded.shape == (b, sp, 3 * h * cp) and padded.dtype == torch.bfloat16
    assert torch.equal(heads[..., :c], x.reshape(b, sp, 3, h, c))
    assert not heads[..., c:].any()
    hc, hcp = h * c, h * cp
    if packed:
        q, k, v = (padded[..., i * hcp : (i + 1) * hcp] for i in range(3))
        got = _attend_padded(q, k, v, h, d, cp)
        unpadded = ta.fat_vit_mha_packed_plain(x, h, d)
        want = ja.fat_vit_mha_packed(jnp.asarray(f), h, d, nq=2, interpret=True)
    else:
        q, k, v = (x[..., i * hc : (i + 1) * hc] for i in range(3))
        got = _attend_padded(*(ta.fat_pad(t, h, c, cp) for t in (q, k, v)), h, d, cp)
        unpadded = ta.fat_vit_mha_plain(q, k, v, h, d)
        want = ja.fat_vit_mha(*(jnp.asarray(np.ascontiguousarray(f[..., i * hc : (i + 1) * hc]))
                                for i in range(3)), h, d, nq=2, interpret=True)
    assert got.shape == (b, sp, h * d)
    torch.testing.assert_close(got.float(), unpadded.float(), rtol=2**-7, atol=2**-7)
    np.testing.assert_allclose(
        got.float().numpy()[:, :n_valid], np.asarray(want, np.float32)[:, :n_valid], atol=2e-2
    )


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
    assert ta.fat_width(72) == 80 and ta.fat_width(7) == 8 and ta.fat_width(16) == 24
    ta.reset_launches()
    f = _packed(np.random.default_rng(3), 1, 16, 11, 16, 7)
    ta.fat_vit_mha_packed(tensor_from_numpy(f), 16, 7)
    q = torch.zeros((1, 8, 2, 16))
    ta.fused_mha(q, q, q)
    ta.mha(q, q, q)
    assert ta.launches == {"fused_mha": 0, "fat_vit_mha": 0, "fat_vit_mha_packed_proj": 0}
    with pytest.raises(ValueError):
        ta.fat_vit_mha_packed(torch.empty((1, 16, 384), dtype=torch.bfloat16, device="meta"), 16, 7)


# ---------------------------------------------------------------------------
# Plain-layout attention
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qkv():
    """tests/test_attention.py's inputs: (B, S, H, Dh) = (2, 24, 4, 16) fp32."""
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal((2, 24, 4, 16)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("stable", ["row", "scalar", "none"])
def test_fused_mha_plain_matches_jax_pallas(qkv, stable):
    jq = tuple(map(jnp.asarray, qkv))
    want = np.asarray(ja.fused_mha_pallas(*jq, stable=stable, interpret=True))
    ref = np.asarray(ja.mha_xla(*jq))
    got = ta.fused_mha_plain(*map(torch.from_numpy, qkv), stable=stable)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 4, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-3)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(ta.fused_mha(*map(torch.from_numpy, qkv), stable=stable), got)


def test_fused_mha_plain_matches_jax_pallas_bf16():
    """bf16 operands: P is rounded to bf16 before P.V and the output is
    bf16, at the reference's cast points (one bf16 ulp at |o| < 4)."""
    rng = np.random.default_rng(4)
    x = [rng.standard_normal((2, 64, 4, 72)).astype(ml_dtypes.bfloat16) for _ in range(3)]
    want = np.asarray(ja.fused_mha_pallas(*map(jnp.asarray, x), interpret=True), np.float32)
    got = ta.fused_mha_plain(*map(tensor_from_numpy, x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)


def test_mha_dispatch_cpu(qkv):
    """On CPU tensors mha takes the fused kernel's plain version; it agrees
    with the JAX mha (XLA on the CPU) to rtol 1e-5, and to atol 1e-6 where
    the output is near 0 (the deferred division and the scalar shift
    round differently from a softmax)."""
    tq = tuple(map(torch.from_numpy, qkv))
    out = ta.mha(*tq)
    assert torch.equal(out, ta.fused_mha_plain(*tq))
    want = np.asarray(ja.mha(*map(jnp.asarray, qkv)))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ta.mha_xla(*tq).numpy(), np.asarray(ja.mha_xla(*map(jnp.asarray, qkv))), rtol=1e-5, atol=1e-6)


def test_causal_mask():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 6, 2, 8)).astype(np.float32)
    out = ta.mha(*(torch.from_numpy(q),) * 3, causal=True).numpy()
    # position 0 attends only to itself: output == v[0]
    np.testing.assert_allclose(out[0, 0], q[0, 0], rtol=1e-5)
    want = np.asarray(ja.mha(*(jnp.asarray(q),) * 3, causal=True))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    # cross-attention with fewer queries than keys: the mask sits at the end
    got = ta.mha_xla(torch.from_numpy(q[:, 4:]), *(torch.from_numpy(q),) * 2, causal=True).numpy()
    want = np.asarray(ja.mha_xla(jnp.asarray(q[:, 4:]), *(jnp.asarray(q),) * 2, causal=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_mha_takes_the_xla_route_for_one_query_and_causal(monkeypatch):
    """Sq = 1 (the MAP head's probe), Sq != Sk and causal attention run
    mha_xla, as the JAX dispatch does; the fused path is never called."""
    monkeypatch.setattr(ta, "fused_mha", lambda *a, **k: pytest.fail("fused path taken"))
    rng = np.random.default_rng(2)
    kv = torch.from_numpy(rng.standard_normal((2, 9, 4, 16)).astype(np.float32))
    for q, causal in ((kv[:, :1], False), (kv[:, :5], False), (kv, True)):
        assert torch.equal(ta.mha(q, kv, kv, causal=causal), ta.mha_xla(q, kv, kv, causal=causal))


def test_fused_mha_refuses_unknown_stable_mode():
    q = torch.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError, match="stable"):
        ta.fused_mha_plain(q, q, q, stable="rows")
    with pytest.raises(ValueError, match="stable"):
        ta.fused_mha(q, q, q, stable="global")
