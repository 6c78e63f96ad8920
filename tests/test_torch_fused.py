"""Port parity: meme_search_engine_tpu_torch.ops.fused against the JAX
package's Pallas kernels (interpret mode) on the same numpy inputs.

On the CPU the port's wrappers take their plain versions; tolerance
rtol/atol 0.05 as in tests/test_fused.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from meme_search_engine_tpu.ops import fused as jf
from meme_search_engine_tpu_torch.models.convert import tensor_from_numpy
from meme_search_engine_tpu_torch.ops import _build
from meme_search_engine_tpu_torch.ops import fused as tf

TOL = 0.05


def _bf16(rng, *shape, scale=0.5, offset=0.0):
    return (rng.standard_normal(shape) * scale + offset).astype(ml_dtypes.bfloat16)


def _both(a):
    return jnp.asarray(a), tensor_from_numpy(a)


def _close(got_torch, want_jax, tol=TOL):
    np.testing.assert_allclose(
        got_torch.float().numpy(), np.asarray(want_jax, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("act", [None, "gelu"])
@pytest.mark.parametrize("masked", [False, True])
def test_ln_matmul_matches_jax(act, masked):
    rng = np.random.default_rng(0)
    b, sp, d, h, c, dh, n_valid = 2, 16, 128, 4, 8, 7, 11
    n = 3 * h * c
    x, g, bb = _bf16(rng, b, sp, d), _bf16(rng, d, scale=0.1, offset=1.0), _bf16(rng, d)
    w, bias = _bf16(rng, d, n, scale=d**-0.5), _bf16(rng, n)
    k_mask = (n_valid, h, c, dh) if masked else None
    (xj, xt), (gj, gt), (bj, bt), (wj, wt), (biasj, biast) = map(_both, (x, g, bb, w, bias))
    want = jf.ln_matmul(xj, gj, bj, wj, biasj, act=act, nq=2, interpret=True, k_mask=k_mask)
    got = tf.ln_matmul(xt, gt, bt, wt, biast, act=act, k_mask=k_mask)
    assert got.dtype == torch.bfloat16 and got.shape == (b, sp, n)
    _close(got, want)
    if masked:
        # pad rows of the K section are exactly the mask constant
        k_pad = got[:, n_valid:, h * c : 2 * h * c].float().reshape(b, sp - n_valid, h, c)
        assert bool((k_pad[..., dh] == torch.tensor(-1e30, dtype=torch.bfloat16).float()).all())
        assert bool((k_pad[..., :dh] == 0).all())


def test_matmul_residual_matches_jax():
    rng = np.random.default_rng(1)
    b, sp, din, n = 2, 16, 128, 64
    arrs = (_bf16(rng, b, sp, din), _bf16(rng, din, n, scale=din**-0.5),
            _bf16(rng, n), _bf16(rng, b, sp, n))
    (xj, xt), (wj, wt), (bj, bt), (rj, rt) = map(_both, arrs)
    want = jf.matmul_residual(xj, wj, bj, rj, nq=2, interpret=True)
    _close(tf.matmul_residual(xt, wt, bt, rt), want)


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("m", [192, 4304])
def test_ln_mlp_residual_matches_both_jax_variants(resident, m):
    """One port function against the resident and the streamed Pallas
    variants, at hidden widths that are not multiples of the tile."""
    rng = np.random.default_rng(2)
    b, sp, d = 1, 16, 128
    arrs = (
        _bf16(rng, b, sp, d), _bf16(rng, d, scale=0.1, offset=1.0), _bf16(rng, d),
        _bf16(rng, d, m, scale=d**-0.5), _bf16(rng, m),
        _bf16(rng, m, d, scale=m**-0.5), _bf16(rng, d),
    )
    js, ts = zip(*map(_both, arrs))
    mh = 128 if m < 2176 else 2176
    want = jf.ln_mlp_residual(*js, nq=1, mh=mh, resident=resident, interpret=True)
    _close(tf.ln_mlp_residual(*ts), want)


def test_pad_hidden_is_exact():
    rng = np.random.default_rng(3)
    d, m = 64, 200
    x, g, bb = (tensor_from_numpy(a) for a in (_bf16(rng, 1, 8, d), _bf16(rng, d, offset=1.0), _bf16(rng, d)))
    w1, b1 = tensor_from_numpy(_bf16(rng, d, m)), tensor_from_numpy(_bf16(rng, m))
    w2, b2 = tensor_from_numpy(_bf16(rng, m, d)), tensor_from_numpy(_bf16(rng, d))
    pw1, pb1, pw2 = tf.pad_hidden(w1, b1, w2)
    assert pw1.shape == (d, 256) and pb1.shape == (256,) and pw2.shape == (256, d)
    assert torch.equal(
        tf.ln_mlp_residual(x, g, bb, w1, b1, w2, b2),
        tf.ln_mlp_residual(x, g, bb, pw1, pb1, pw2, b2),
    )


def test_cpu_path_never_counts_launches():
    tf.reset_launches()
    rng = np.random.default_rng(4)
    x = tensor_from_numpy(_bf16(rng, 1, 8, 16))
    w, b = tensor_from_numpy(_bf16(rng, 16, 16)), tensor_from_numpy(_bf16(rng, 16))
    g = torch.ones(16, dtype=torch.bfloat16)
    tf.ln_matmul(x, g, b, w, b)
    tf.matmul_residual(x, w, b, x)
    tf.ln_mlp_residual(x, g, b, w, b, w, b)
    assert tf.launches == {"ln_matmul": 0, "matmul_residual": 0, "ln_mlp_residual": 0}


def test_no_silent_fallback():
    """Tensors that are not on the CPU never take the plain version: a
    device the kernels do not serve raises, and so does asking for the
    CUDA kernels on a host without CUDA."""
    x = torch.empty((1, 8, 16), dtype=torch.bfloat16, device="meta")
    w = torch.empty((16, 16), dtype=torch.bfloat16, device="meta")
    b = torch.empty((16,), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        tf.ln_matmul(x, b, b, w, b)
    with pytest.raises(ValueError):
        tf.matmul_residual(x, w, b, x)
    with pytest.raises(ValueError):  # mixed devices
        tf.matmul_residual(torch.zeros((1, 8, 16), dtype=torch.bfloat16), w, b, x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _build.library("gemm")
    assert tf.launches["ln_matmul"] == 0 and tf.launches["matmul_residual"] == 0
