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


# -- the gathered dots: gather_dot and gather_gram ---------------------------
#
# Their plain versions against the JAX package's expressions on the gathered
# rows (index/vamana.py: the hop's einsum("bd,brd->br") after the Pallas
# gather in interpret mode and an fp32 upcast, and the prune's bf16 or int8
# einsum("bcd,bed->bce") with preferred_element_type=f32). Tolerance: 1e-5
# with bf16 rows of unit vectors, as the build holds them (fp32 sums of the
# same exact products in another order); exact with int8 rows, whose sums
# are integers below 2^24.


def _dot_inputs(dtype, shape, n=500, d=256, seed=3):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        x = rng.integers(-127, 128, (n, d), dtype=np.int8)
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    idx = rng.integers(0, n, shape, dtype=np.int32)
    # int8: the build's queries are rows of the same corpus, so every
    # product, and every sum, is an integer
    if dtype == "int8":
        q = rng.integers(-127, 128, (shape[0], d)).astype(np.float32)
    else:
        q = (rng.standard_normal((shape[0], d)) / np.sqrt(d)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16) if dtype == "bf16" else jnp.asarray(x)
    tx = torch.from_numpy(x).to(torch.bfloat16) if dtype == "bf16" else torch.from_numpy(x)
    return jx, tx, idx, q


def _assert_dots(got, want, dtype):
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


SHAPES = [(3, 50), (1, 1), (4, 37)]
SHAPE_IDS = ["ragged", "one_row", "ragged_c"]


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_gather_dot_matches_jax_interpret(dtype, shape):
    jx, tx, idx, q = _dot_inputs(dtype, shape)
    rows = jgather.gather_rows(jx, jnp.asarray(idx), interpret=True).astype(jnp.float32)
    want = np.asarray(jnp.einsum("bd,brd->br", jnp.asarray(q), rows, preferred_element_type=jnp.float32))
    tgather.reset_launches()
    got = tgather.gather_dot(tx, torch.from_numpy(idx), torch.from_numpy(q))
    assert got.shape == shape and got.dtype == torch.float32
    assert tgather.launches == {"gather_rows": 0, "gather_dot": 0, "gather_gram": 0}
    _assert_dots(got.numpy(), want, dtype)
    _assert_dots(tgather.gather_dot_plain(tx, torch.from_numpy(idx), torch.from_numpy(q)).numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_gather_gram_matches_jax_interpret(dtype, shape):
    jx, tx, idx, _ = _dot_inputs(dtype, shape)
    rows = jgather.gather_rows(jx, jnp.asarray(idx), interpret=True)
    want = np.asarray(jnp.einsum("bcd,bed->bce", rows, rows, preferred_element_type=jnp.float32))
    tgather.reset_launches()
    got = tgather.gather_gram(tx, torch.from_numpy(idx))
    assert got.shape == (*shape, shape[1]) and got.dtype == torch.float32
    assert tgather.launches == {"gather_rows": 0, "gather_dot": 0, "gather_gram": 0}
    _assert_dots(got.numpy(), want, dtype)
    _assert_dots(tgather.gather_gram_plain(tx, torch.from_numpy(idx)).numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_gathered_dots_clamp_ids(dtype):
    """Ids past both ends score as the first and last rows, as gather_rows
    clamps them."""
    _, tx, _, q = _dot_inputs(dtype, (2, 4), n=40)
    idx = torch.tensor([[0, 39, -3, 40], [2**31 - 1, -(2**31), 5, 39]], dtype=torch.int32)
    clamped = torch.tensor([[0, 39, 0, 39], [39, 0, 5, 39]], dtype=torch.int32)
    qt = torch.from_numpy(q)
    assert torch.equal(tgather.gather_dot(tx, idx, qt), tgather.gather_dot(tx, clamped, qt))
    assert torch.equal(tgather.gather_gram(tx, idx), tgather.gather_gram(tx, clamped))


def test_gather_dot_plain_in_chunks_equals_one_product(monkeypatch):
    """The plain dot takes its queries in chunks (the stitch scores every
    in-neighbour at once): every row is scored, and only the last bits of
    an fp32 sum may move (torch.bmm's CPU kernel sums in an order that
    depends on the batch)."""
    _, tx, idx, q = _dot_inputs("bf16", (9, 20))
    whole = tgather.gather_dot_plain(tx, torch.from_numpy(idx), torch.from_numpy(q))
    monkeypatch.setattr(tgather, "_PLAIN_DOT_ELEMS", 2 * 20 * 256)
    chunked = tgather.gather_dot_plain(tx, torch.from_numpy(idx), torch.from_numpy(q))
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-6)


def test_gathered_dots_empty_and_refusals():
    x = torch.from_numpy(_corpus("bf16", n=10, d=8)).to(torch.bfloat16)
    q = torch.zeros((2, 8))
    assert tgather.gather_dot(x, torch.zeros((2, 0), dtype=torch.int32), q).shape == (2, 0)
    assert tgather.gather_gram(x, torch.zeros((3, 0), dtype=torch.int32)).shape == (3, 0, 0)
    with pytest.raises(TypeError, match="int32"):
        tgather.gather_dot(x, torch.zeros((2, 2), dtype=torch.int64), q)
    with pytest.raises(TypeError, match="int32"):
        tgather.gather_gram(x, torch.zeros((2, 2), dtype=torch.int64))
    with pytest.raises(TypeError, match="fp32"):
        tgather.gather_dot(x, torch.zeros((2, 2), dtype=torch.int32), q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="queries"):
        tgather.gather_dot(x, torch.zeros((2, 2), dtype=torch.int32), q[:1])
    with pytest.raises(ValueError, match="empty corpus"):
        tgather.gather_gram(x[:0], torch.zeros((1, 1), dtype=torch.int32))


def test_vamana_on_cpu_takes_the_plain_versions(monkeypatch):
    """A CPU build (hops, prunes, re-prunes, the stitch) scores through the
    plain versions of the gathered dots and launches no kernel."""
    from meme_search_engine_tpu_torch.index import vamana as tv

    calls = {"gather_dot_plain": 0, "gather_gram_plain": 0}
    for name in calls:
        real = getattr(tgather, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(tgather, name, counted)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    cfg = tv.VamanaConfig(r=8, l=16, maxc=32, batch_size=64, query_breakpoint=260,
                          overflow_flush_rounds=2)
    tgather.reset_launches()
    graph = tv.build_graph(x, cfg, seed=0, device="cpu")
    graph = tv.robust_stitch(x, graph, cfg, device="cpu")
    assert tgather.launches == {"gather_rows": 0, "gather_dot": 0, "gather_gram": 0}
    assert calls["gather_dot_plain"] > 0 and calls["gather_gram_plain"] > 0, calls
    assert graph.shape == (300, 8) and not (graph[:260] >= 260).any()
