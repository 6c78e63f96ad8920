"""Port parity: balanced k-means of meme_search_engine_tpu_torch against
the JAX package on the same numpy inputs, on the CPU.

Assignments and counts must be equal; one Lloyd step's centroids agree
within 1e-5 (the port sums a 0/1 membership matrix times x, the JAX
package scatter-adds: the same fp32 terms in another order). The trained
centroids are held by quality, not bits: the annealing noise comes from
torch.Generator in the port and jax.random in the JAX package.
"""

import numpy as np
import pytest
import torch

from meme_search_engine_tpu.index import kmeans as jkm
from meme_search_engine_tpu_torch.index import kmeans as tkm


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_assign_top_k_matches_jax():
    rng = np.random.default_rng(0)
    x = _unit(rng, 3000, 32)
    c = rng.standard_normal((12, 32)).astype(np.float32)
    c[7] = c[3] * 2.0  # the same direction twice: every row ties there
    want = np.asarray(jkm.assign_top_k(x, c))
    got = tkm.assign_top_k(torch.from_numpy(x), c)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tkm.assign_top_k(torch.from_numpy(x), c, 3).numpy(),
                                  np.asarray(jkm.assign_top_k(x, c, 3)))


def test_lloyd_step_and_fitness_match_jax():
    rng = np.random.default_rng(1)
    x = _unit(rng, 2000, 16)
    c = x[rng.choice(2000, 8, replace=False)]
    # three centroids of one direction tie on every row: the two lower ids
    # take the ties, so cluster 5 stays empty and keeps its place
    c[4] = c[5] = c[3]
    jc, jn = jkm._lloyd_step(x, c, 8)
    tc, tn = tkm._lloyd_step(torch.from_numpy(x), torch.from_numpy(c), 8)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    assert tn[5] == 0 and torch.equal(tc[5], torch.from_numpy(c[5]))
    jf, jw = jkm._fitness(x, c, 8, jkm.SPILL_K)
    tf, tw = tkm._fitness(torch.from_numpy(x), torch.from_numpy(c), 8, tkm.SPILL_K)
    assert float(tf) == float(jf) and int(tw) == int(jw)


@pytest.mark.parametrize("seed", [0, 1])
def test_balanced_kmeans_balance_matches_jax(seed):
    """tests/test_quantizers2.py::test_balanced_kmeans_balance's fixture and
    bound; the top-1 max count within 10% of the JAX build's."""
    x = _unit(np.random.default_rng(3), 2000, 16)
    k = 8
    got = tkm.balanced_kmeans(x, k, max_iter=150, seed=seed, target_frac=0.3, device="cpu")
    want = jkm.balanced_kmeans(x, k, max_iter=150, seed=seed, target_frac=0.3)
    assert got.shape == (k, 16) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    idx = tkm.assign_top_k(torch.from_numpy(x), got).numpy()
    assert (idx[:, 0] != idx[:, 1]).all()
    counts = np.bincount(idx[:, 0], minlength=k)
    assert counts.max() < 2.5 * (2000 / k), counts
    jcounts = np.bincount(np.asarray(jkm.assign_top_k(x, want))[:, 0], minlength=k)
    assert abs(counts.max() - jcounts.max()) <= 0.1 * jcounts.max(), (counts, jcounts)


def test_centroids_file_round_trip(tmp_path):
    c = _unit(np.random.default_rng(4), 6, 24)
    path = str(tmp_path / "centroids.bin")
    tkm.save_centroids(c, path)
    np.testing.assert_array_equal(tkm.load_centroids(path, 24), jkm.load_centroids(path, 24))
    np.testing.assert_allclose(tkm.load_centroids(path, 24), c, atol=1e-3)
    jpath = str(tmp_path / "jax.bin")
    jkm.save_centroids(c, jpath)
    assert open(jpath, "rb").read() == open(path, "rb").read()
