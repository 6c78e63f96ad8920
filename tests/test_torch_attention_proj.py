"""Kernel 8, the fat attention fused with the o-projection and the residual
(``fat_vit_mha_packed_proj``): the port's CPU path against the JAX
kernel in interpret mode and against the port's kernels 7 then 2.

Tolerances: atol 1e-4 in fp32 against the JAX kernel, the JAX package's
own test of this kernel (tests/test_attention.py:133); 0.05 in bf16
against the composition, the GEMM kernels' tolerance (tests/test_fused.py).
The card's kernel is held against the plain version in
tests/test_torch_cuda_kernels.py and in chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meme_search_engine_tpu.ops import attention as jattn
from meme_search_engine_tpu_torch.ops import attention, fused


def _qkvf(rng, b, sp, n_valid, h, d, prescale_q=False):
    """Packed fat-layout (B, SP, 3*H*C) fp32: q's constant column 1, k's
    0 on valid rows and -1e30 on pad rows (whose features are 0), v's 1;
    with ``prescale_q`` q's features scaled by 1/sqrt(d), as the QKV
    projection hands them over."""
    c = attention.fat_width(d)
    f = np.zeros((b, sp, 3, h, c), np.float32)
    f[..., :d] = rng.standard_normal((b, sp, 3, h, d))
    if prescale_q:
        f[:, :, 0, :, :d] *= d**-0.5
    f[:, :, 0, :, d] = 1.0
    f[:, n_valid:, 1] = 0.0
    f[:, n_valid:, 1, :, d] = -1e30
    f[:, :, 2, :, d] = 1.0
    return f.reshape(b, sp, 3 * h * c)


# the JAX test's shapes; the tiny fat geometry with pad rows; an SP over two
# of the CUDA kernel's 128-row query blocks with 129 valid rows (the second
# block holds one valid row and seven pad rows; the JAX kernel takes it as
# one block, nq = 1, since 136 / 2 is no multiple of 8), at the tiny and
# tiny fat geometries. The ragged cases take a layer's scales (q
# pre-scaled by 1/sqrt(d), Wo by 1/sqrt(H*d)): with unit ones, P is near
# one-hot over 136 keys and a bf16 rounding of P that XLA's exp and
# torch's place on either side of a tie moves outputs of about 10 by
# 1e-3, past the JAX test's 1e-4.
@pytest.mark.parametrize(
    "b,sp,n_valid,h,d,dm,nq,layer_scales",
    [(2, 16, 16, 4, 8, 24, 2, False), (2, 16, 4, 16, 7, 112, 2, False),
     (1, 136, 129, 4, 16, 64, 1, True), (1, 136, 129, 16, 7, 112, 1, True)],
    ids=["jax_test_shapes", "tiny_fat_pad_rows", "ragged_two_blocks", "tiny_fat_ragged_two_blocks"],
)
def test_proj_matches_jax_kernel_interpret(b, sp, n_valid, h, d, dm, nq, layer_scales):
    """The CPU path (the plain version) equals the JAX kernel run in
    interpret mode, fp32, on the valid rows."""
    rng = np.random.default_rng(3)
    qkvf = _qkvf(rng, b, sp, n_valid, h, d, prescale_q=layer_scales)
    wo = rng.standard_normal((h * d, dm)).astype(np.float32) * ((h * d) ** -0.5 if layer_scales else 1.0)
    bo = rng.standard_normal(dm).astype(np.float32)
    res = rng.standard_normal((b, sp, dm)).astype(np.float32)
    want = np.asarray(jattn.fat_vit_mha_packed_proj(
        jnp.asarray(qkvf), jnp.asarray(wo), jnp.asarray(bo), jnp.asarray(res), h, d,
        nq=nq, interpret=True))
    attention.reset_launches()
    got = attention.fat_vit_mha_packed_proj(*map(torch.from_numpy, (qkvf, wo, bo, res)), h, d)
    assert attention.launches["fat_vit_mha_packed_proj"] == 0  # CPU: no kernel
    assert got.dtype == torch.float32 and got.shape == (b, sp, dm)
    np.testing.assert_allclose(got.numpy()[:, :n_valid], want[:, :n_valid], atol=1e-4)


@pytest.mark.parametrize("h,d", [(4, 16), (16, 7), (16, 72)], ids=["tiny", "tiny_fat", "so400m_heads"])
def test_proj_plain_matches_kernels_7_then_2_in_bf16(h, d):
    """In bf16, the plain version equals the port's plain kernel 7 then
    kernel 2 (the image tower's route), within the GEMM tolerance."""
    rng = np.random.default_rng(4)
    b, sp, n_valid = 2, 24, 19
    qkvf = torch.from_numpy(_qkvf(rng, b, sp, n_valid, h, d)).to(torch.bfloat16)
    dm = h * d
    wo = torch.from_numpy(rng.standard_normal((h * d, dm)).astype(np.float32) * dm**-0.5).to(torch.bfloat16)
    bo = torch.from_numpy(rng.standard_normal(dm).astype(np.float32) * 0.02).to(torch.bfloat16)
    res = torch.from_numpy(rng.standard_normal((b, sp, dm)).astype(np.float32)).to(torch.bfloat16)
    got = attention.fat_vit_mha_packed_proj(qkvf, wo, bo, res, h, d)
    assert got.dtype == torch.bfloat16
    composed = fused.matmul_residual(attention.fat_vit_mha_packed(qkvf, h, d), wo, bo, res)
    torch.testing.assert_close(got[:, :n_valid].float(), composed[:, :n_valid].float(),
                               rtol=0.05, atol=0.05)


def test_proj_wrapper_refusals(monkeypatch):
    """What the CUDA path refuses, checked before any launch: tensors on
    other devices, dtypes other than bf16, shapes that do not fit, fat
    widths, head counts and head or output widths the kernel is not
    compiled for. Past the checks it launches or raises: here, with no
    card, the build raises."""
    h, d, sp = 4, 16, 16
    c = attention.fat_width(d)
    bf = torch.bfloat16
    qkvf, wo = torch.zeros((1, sp, 3 * h * c), dtype=bf), torch.zeros((h * d, 64), dtype=bf)
    bo, res = torch.zeros(64, dtype=bf), torch.zeros((1, sp, 64), dtype=bf)
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        attention.fat_vit_mha_packed_proj(qkvf.to("meta"), wo, bo, res, h, d)
    monkeypatch.setattr(attention, "_on_cpu", lambda *ts: False)  # take the CUDA path's checks
    cases = [
        ((qkvf.float(), wo, bo, res, h, d), TypeError, "bfloat16"),
        ((qkvf, wo, bo, res.float(), h, d), TypeError, "bfloat16"),
        ((qkvf, wo[:32], bo, res, h, d), ValueError, "shape"),
        ((qkvf, wo, bo[:32], res, h, d), ValueError, "shape"),
        ((qkvf, wo, bo, res[:, :8], h, d), ValueError, "shape"),
        ((qkvf, wo, bo, res, h, 8), ValueError, "width"),
        ((qkvf[0], wo, bo, res, h, d), ValueError, "expected"),
        ((torch.zeros((1, 8, 3 * 4 * 48), dtype=bf), torch.zeros((160, 64), dtype=bf), bo,
          torch.zeros((1, 8, 64), dtype=bf), 4, 40), ValueError, "compiled for"),
        ((qkvf, torch.zeros((h * d, 60), dtype=bf), torch.zeros(60, dtype=bf),
          torch.zeros((1, sp, 60), dtype=bf), h, d), ValueError, "multiple of 8"),
        # the cluster kernel: two heads a CTA, at most 8 CTAs, and the
        # head and output widths each fat width is compiled for
        ((torch.zeros((1, sp, 3 * 16), dtype=bf), torch.zeros((8, 64), dtype=bf), bo, res, 1, 8),
         ValueError, "even head count"),
        ((torch.zeros((1, sp, 3 * 3 * c), dtype=bf), torch.zeros((3 * d, 48), dtype=bf),
          torch.zeros(48, dtype=bf), torch.zeros((1, sp, 48), dtype=bf), 3, d), ValueError, "even head count"),
        ((torch.zeros((1, sp, 3 * 18 * c), dtype=bf), torch.zeros((18 * d, 64), dtype=bf), bo, res, 18, d),
         ValueError, "at most 8"),
        ((qkvf, torch.zeros((h * d, 128), dtype=bf), torch.zeros(128, dtype=bf),
          torch.zeros((1, sp, 128), dtype=bf), h, d), ValueError, "compiled for 32"),
        ((torch.zeros((1, sp, 3 * 2 * 72), dtype=bf), torch.zeros((128, 128), dtype=bf),
          torch.zeros(128, dtype=bf), torch.zeros((1, sp, 128), dtype=bf), 2, 64), ValueError, "compiled for 72"),
    ]
    for args, exc, match in cases:
        with pytest.raises(exc, match=match):
            attention.fat_vit_mha_packed_proj(*args)
    with pytest.raises(RuntimeError, match="is_available"):
        attention.fat_vit_mha_packed_proj(qkvf, wo, bo, res, h, d)
    assert attention.launches["fat_vit_mha_packed_proj"] == 0


def test_encoder_fat_through_kernel_8_equals_kernels_7_then_2(monkeypatch):
    """The image tower's fat encoder with kernel 8 in the place of kernels 7
    then 2 gives bit-equal output on the CPU, at tiny_fat_test_config in
    bf16: kernel 8's plain version is kernel 2's on kernel 7's output, with
    the same casts. (On the card the encoder keeps 7 then 2, which ran
    faster on an H100; PERF.md.)"""
    from meme_search_engine_tpu_torch.models import siglip

    cfg = siglip.tiny_fat_test_config()
    params = siglip.prepare_params(siglip.init_params(cfg, torch.Generator().manual_seed(5), "cpu"), cfg)
    blocks, h = params["img"]["blocks"], cfg.num_heads
    dh, n_valid = cfg.width // h, cfg.num_patches
    sp = (n_valid + 15) // 16 * 16
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, sp, cfg.width)).astype(np.float32)).to(torch.bfloat16)
    want = siglip._encoder_fat(x, blocks, h, n_valid)
    fused_calls = []

    def proj(qkvf, w, b, res):  # kernel 2's place, on what kernel 7's place passed on
        fused_calls.append(qkvf.shape)
        return attention.fat_vit_mha_packed_proj(qkvf, w, b, res, h, dh)

    monkeypatch.setattr(siglip, "fat_vit_mha_packed", lambda qkvf, n_heads, head_dim: qkvf)
    monkeypatch.setattr(siglip, "matmul_residual", proj)
    got = siglip._encoder_fat(x, blocks, h, n_valid)
    assert len(fused_calls) == cfg.depth and got.dtype == torch.bfloat16
    assert torch.equal(got, want)
