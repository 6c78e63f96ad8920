"""Port parity: gather_rows of meme_search_engine_tpu_torch against the JAX
package's Pallas gather (interpret mode) and against plain indexing, on
the CPU, where the wrapper takes its plain version. A gather is exact:
every comparison is bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meme_search_engine_tpu.ops import gather as jgather
from meme_search_engine_tpu_torch.ops import gather as tgather


def _corpus(dtype, n=500, d=256, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return rng.integers(-127, 128, (n, d), dtype=np.int8)
    return rng.standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("shape", [(3, 50), (1, 1)], ids=["ragged", "one_row"])
def test_gather_rows_matches_jax_interpret(dtype, shape):
    """(500, 256) x (3, 50): M = 150 ids, not a multiple of the TPU
    kernel's 128-row group; and a single id."""
    x = _corpus(dtype)
    idx = np.random.default_rng(1).integers(0, len(x), shape, dtype=np.int32)
    jx = jnp.asarray(x, jnp.bfloat16) if dtype == "bf16" else jnp.asarray(x)
    want = np.asarray(jgather.gather_rows(jx, jnp.asarray(idx), interpret=True))
    tx = torch.from_numpy(x).to(torch.bfloat16) if dtype == "bf16" else torch.from_numpy(x)
    tgather.reset_launches()
    got = tgather.gather_rows(tx, torch.from_numpy(idx))
    assert got.shape == (*shape, x.shape[1]) and got.dtype == tx.dtype
    assert tgather.launches["gather_rows"] == 0  # the CPU takes the plain version
    if dtype == "bf16":
        got, want = got.view(torch.int16).numpy(), want.view(np.int16)
    else:
        got = got.numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (tx.view(torch.int16) if dtype == "bf16" else tx)[idx].numpy())


@pytest.mark.parametrize("d", [16, 32, 72])
def test_gather_rows_narrow_rows_and_clamped_ids(d):
    """Widths the TPU kernel refused (D % 128 != 0); ids out of range come
    back clamped into [0, N - 1], as XLA's gather clamps them."""
    x = torch.from_numpy(_corpus("int8", n=40, d=d))
    idx = torch.tensor([[0, 39, 5], [-3, 40, 2**31 - 1]], dtype=torch.int32)
    got = tgather.gather_rows(x, idx)
    want = x[torch.tensor([[0, 39, 5], [0, 39, 39]])]
    assert torch.equal(got, want)
    assert torch.equal(tgather.gather_rows_plain(x, idx), want)


def test_gather_rows_empty_and_refusals():
    x = torch.from_numpy(_corpus("bf16", n=10, d=8)).to(torch.bfloat16)
    assert tgather.gather_rows(x, torch.zeros((0, 5), dtype=torch.int32)).shape == (0, 5, 8)
    assert tgather.gather_rows(x[:0], torch.zeros((4, 0), dtype=torch.int32)).shape == (4, 0, 8)
    with pytest.raises(TypeError, match="int32"):
        tgather.gather_rows(x, torch.zeros((2, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\(B, K\)"):
        tgather.gather_rows(x, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="empty corpus"):
        tgather.gather_rows(x[:0], torch.zeros((1, 1), dtype=torch.int32))
