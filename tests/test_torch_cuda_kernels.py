"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips on a host without a GPU. These shapes
are chosen to hit the kernels' edges (rows and columns that do not fill a
tile, ragged key tiles, narrow heads); chip_smoke.py checks the SO400M
shapes. This file imports neither JAX nor the JAX package, so on the GPU
machine it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from meme_search_engine_tpu_torch.ops import attention, fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rn(gen, *shape, std=1.0, mean=0.0):
    return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(torch.bfloat16)


def _assert_close(got, want, tol):
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,sp,k,n", [(1, 40, 64, 136), (3, 736, 1152, 384), (2, 24, 200, 8)])
@pytest.mark.parametrize("act", [None, "gelu"])
def test_ln_matmul_kernel(gen, b, sp, k, n, act):
    x, g, be = _rn(gen, b, sp, k), _rn(gen, k, std=0.1, mean=1.0), _rn(gen, k, std=0.1)
    w, bias = _rn(gen, k, n, std=k**-0.5), _rn(gen, n, std=0.1)
    fused.reset_launches()
    got = fused.ln_matmul(x, g, be, w, bias, act=act)
    assert fused.launches["ln_matmul"] == 1
    _assert_close(got, fused.ln_matmul_plain(x, g, be, w, bias, act=act), 0.05)


def test_ln_matmul_kernel_key_mask(gen):
    b, sp, n_valid, h, c, d, k = 2, 48, 37, 4, 24, 16, 64
    x, g, be = _rn(gen, b, sp, k), _rn(gen, k, mean=1.0, std=0.1), _rn(gen, k)
    w, bias = _rn(gen, k, 3 * h * c, std=k**-0.5), _rn(gen, 3 * h * c)
    km = (n_valid, h, c, d)
    got = fused.ln_matmul(x, g, be, w, bias, k_mask=km)
    torch.cuda.synchronize()
    want = fused.ln_matmul_plain(x, g, be, w, bias, k_mask=km)
    assert torch.equal(got[:, n_valid:, h * c : 2 * h * c], want[:, n_valid:, h * c : 2 * h * c])
    _assert_close(got, want, 0.05)


@pytest.mark.parametrize("b,sp,k,n", [(1, 40, 64, 136), (2, 736, 1152, 1152)])
def test_matmul_residual_kernel(gen, b, sp, k, n):
    x, w, bias, res = _rn(gen, b, sp, k), _rn(gen, k, n, std=k**-0.5), _rn(gen, n), _rn(gen, b, sp, n)
    _assert_close(fused.matmul_residual(x, w, bias, res), fused.matmul_residual_plain(x, w, bias, res), 0.05)


def test_ln_mlp_residual_kernel(gen):
    b, sp, d, m = 2, 50, 128, 200
    x, g, be = _rn(gen, b, sp, d), _rn(gen, d, mean=1.0, std=0.1), _rn(gen, d)
    w1, b1 = _rn(gen, d, m, std=d**-0.5), _rn(gen, m)
    w2, b2 = _rn(gen, m, d, std=m**-0.5), _rn(gen, d)
    pw1, pb1, pw2 = (t.contiguous() for t in fused.pad_hidden(w1, b1, w2))
    with pytest.raises(ValueError, match="pad_hidden"):
        fused.ln_mlp_residual(x, g, be, w1, b1, w2, b2)
    got = fused.ln_mlp_residual(x, g, be, pw1, pb1, pw2, b2)
    _assert_close(got, fused.ln_mlp_residual_plain(x, g, be, w1, b1, w2, b2), 0.05)


@pytest.mark.parametrize("b,sp,n_valid,h,d", [(2, 16, 11, 16, 7), (2, 100, 90, 4, 72), (2, 736, 729, 16, 72)])
def test_fat_attention_kernel(gen, b, sp, n_valid, h, d):
    c = attention.fat_width(d)
    f = torch.randn((b, sp, 3, h, c), generator=gen, device="cuda")
    f[..., d:] = 0
    f[:, :, 0, :, :d] *= d**-0.5
    f[:, :, 0, :, d] = 1
    f[:, n_valid:, 1] = 0
    f[:, n_valid:, 1, :, d] = -1e30
    f[:, :, 2, :, d] = 1
    qkvf = f.reshape(b, sp, 3 * h * c).to(torch.bfloat16)
    attention.reset_launches()
    got = attention.fat_vit_mha_packed(qkvf, h, d)
    want = attention.fat_vit_mha_packed_plain(qkvf, h, d)
    _assert_close(got[:, :n_valid], want[:, :n_valid], 2e-2)
    q, k, v = (qkvf[..., i * h * c : (i + 1) * h * c].contiguous() for i in range(3))
    _assert_close(attention.fat_vit_mha(q, k, v, h, d)[:, :n_valid], want[:, :n_valid], 2e-2)
    assert attention.launches["fat_vit_mha"] == 2


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x, w, b = _rn(gen, 1, 8, 64), _rn(gen, 64, 64), _rn(gen, 64)
    with pytest.raises(TypeError):
        fused.matmul_residual(x.float(), w, b, x)
    with pytest.raises(ValueError):
        fused.matmul_residual(x.transpose(1, 2).contiguous().transpose(1, 2), w, b, x)
    with pytest.raises(ValueError):
        fused.ln_matmul(_rn(gen, 1, 8, 60), b[:60].contiguous(), b[:60].contiguous(), w[:60].contiguous(), b)
    with pytest.raises(ValueError):
        fused.matmul_residual(x, w, b, x.cpu())
    with pytest.raises(ValueError, match="compiled for"):  # head_dim 16: fat width 24
        attention.fat_vit_mha_packed(_rn(gen, 1, 8, 3 * 4 * 24), 4, 16)
