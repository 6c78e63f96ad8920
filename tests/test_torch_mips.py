"""Port parity: ops/mips.py of meme_search_engine_tpu_torch (the build's
evaluation oracle) against the JAX package on the same numpy inputs, on
the CPU. Scores within 1e-5 (fp32 sums in another order); ids equal,
including lax.top_k's tie order (the lower index first).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meme_search_engine_tpu.ops import mips as jmips
from meme_search_engine_tpu_torch.ops import mips as tmips


def _corpus(n=1000, d=128, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, d), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float16)


@pytest.mark.parametrize(
    "n,k,tile", [(1000, 10, 256), (1000, 50, 384), (8, 100, 256), (1000, 300, 128)],
    ids=["tiles", "ragged_tile", "k_past_n", "k_past_tile"],
)
def test_mips_topk_matches_jax(n, k, tile):
    x = _corpus(n)
    q = np.random.default_rng(1).standard_normal((4, 128)).astype(np.float32)
    js, ji = jmips.mips_topk(jnp.asarray(x), jnp.asarray(q), k, tile=tile)
    ts, ti = tmips.mips_topk(torch.from_numpy(x), torch.from_numpy(q), k, tile=tile)
    assert ts.shape == ti.shape == (4, min(k, n)) and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)


def test_mips_topk_tie_order_matches_lax_top_k():
    """Duplicate rows score exactly alike: the lower index comes first,
    within a tile and across the merge of two tiles."""
    base = _corpus(40, 128, seed=2)
    x = np.concatenate([base, base[::-1], base])  # every row three times
    q = np.random.default_rng(3).standard_normal((3, 128)).astype(np.float32)
    js, ji = jmips.mips_topk(jnp.asarray(x), jnp.asarray(q), 30, tile=32)
    ts, ti = tmips.mips_topk(torch.from_numpy(x), torch.from_numpy(q), 30, tile=32)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    assert (ts[:, 0::3] == ts[:, 1::3]).all()  # the three copies of a row tie exactly


def test_streamed_mips_topk_matches_resident():
    x = _corpus()
    q = np.random.default_rng(3).standard_normal((5, 128)).astype(np.float32)
    _, ref = tmips.mips_topk(torch.from_numpy(x), torch.from_numpy(q), 20, tile=256)

    def slabs():
        for s0 in range(0, 1000, 300):  # uneven final slab
            yield x[s0 : s0 + 300], s0

    s, i = tmips.streamed_mips_topk(slabs(), q, 20, tile=128, device="cpu")
    np.testing.assert_array_equal(i, ref.numpy())
    assert np.all(np.diff(s, axis=1) <= 0)
    js, ji = jmips.streamed_mips_topk(slabs(), q, 20, tile=128)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=0, atol=1e-5)


def test_exact_scores_matches_jax():
    x = _corpus(300)
    q = np.random.default_rng(4).standard_normal((6, 128)).astype(np.float32)
    want = np.asarray(jmips.exact_scores(jnp.asarray(x), jnp.asarray(q)))
    got = tmips.exact_scores(torch.from_numpy(x), torch.from_numpy(q)).numpy()
    assert got.shape == (6, 300) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _chain():
    """tests/test_mips.py::test_dedup_matches_greedy_chain: A > B > C with
    sim(A, B) and sim(B, C) above 0.95, sim(A, C) below."""
    a = np.zeros(8, np.float32)
    a[0] = 1.0
    b = np.array([np.cos(0.25), np.sin(0.25)] + [0] * 6, np.float32)
    c = np.array([np.cos(0.5), np.sin(0.5)] + [0] * 6, np.float32)
    return np.stack([a, b, c]), np.array([3.0, 2.0, 1.0], np.float32)


def _near_far():
    base = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    base /= np.linalg.norm(base)
    near = base + 0.01 * np.random.default_rng(4).standard_normal(64).astype(np.float32)
    return np.stack([base, near, -base]), np.array([3.0, 2.0, 1.0], np.float32)


def _shuffled():
    e = np.random.default_rng(5).standard_normal((24, 16)).astype(np.float32)
    e[5] = e[2] + 0.01
    e[17] = e[9] * 2.0
    return e, np.random.default_rng(6).permutation(24).astype(np.float32)


@pytest.mark.parametrize("case", [_chain, _near_far, _shuffled], ids=["greedy_chain", "near_far", "shuffled"])
def test_dedup_matches_matches_jax(case):
    e, s = case()
    want = np.asarray(jmips.dedup_matches(jnp.asarray(e), jnp.asarray(s), 0.95))
    got = tmips.dedup_matches(torch.from_numpy(e), torch.from_numpy(s), 0.95).numpy()
    np.testing.assert_array_equal(got, want)
    if case is _chain:
        assert got.tolist() == [True, False, True]
