"""Port parity, component by component: the Vamana build's pieces in
meme_search_engine_tpu_torch against the JAX package on the same numpy
inputs, on the CPU (the gather takes its plain version there).

Tolerances: scores within 1e-5 (fp32 sums of the same exact products in
another order); with an int8 corpus every score is an exact integer, so
ties are true ties and the results must be equal. With a bf16 corpus a
pool may differ only where two scores lie within that 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meme_search_engine_tpu.index import vamana as jv
from meme_search_engine_tpu_torch.index import vamana as tv

CPU = "cpu"
INVALID = 2**31 - 1


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_random_fill_matches_jax():
    np.testing.assert_array_equal(tv.random_fill(300, 12, seed=5), jv.random_fill(300, 12, seed=5))


def test_corpus_on_device_matches_jax():
    x = _unit(np.random.default_rng(4), 100, 48) * 0.3
    np.testing.assert_array_equal(
        tv._corpus_on_device(x, "int8", CPU).numpy(), np.asarray(jv._corpus_on_device(x, "int8"))
    )
    np.testing.assert_array_equal(
        tv._corpus_on_device(x, "bf16", CPU).float().numpy(),
        np.asarray(jv._corpus_on_device(x, "bf16")).astype(np.float32),
    )
    with pytest.raises(ValueError):
        tv._corpus_on_device(x, "fp8", CPU)


def test_medioid_and_medioid_dev_match_jax():
    """The fixture of tests/test_vamana.py::test_medioid_dev_matches_host."""
    rng = np.random.default_rng(3)
    x = _unit(rng, 500, 32)
    ref = jv.medioid(x)
    x[ref] = x[ref] * 0.5 + 0.5 * x.mean(axis=0) / np.linalg.norm(x.mean(axis=0))
    ref = jv.medioid(x)
    assert tv.medioid(x, CPU) == ref
    for dtype in ("bf16", "int8"):
        dev = tv._corpus_on_device(x, dtype, CPU)
        assert tv.medioid_dev(dev) == jv.medioid_dev(jv._corpus_on_device(x, dtype)) == ref
    assert tv.medioid_dev(tv._corpus_on_device(x, "bf16", CPU), 400) == jv.medioid(x[:400])


def test_insert_back_edges_matches_jax():
    rng = np.random.default_rng(8)
    n, r = 400, 8
    graph = rng.integers(-1, n, (n, r)).astype(np.int32)
    degrees = rng.integers(0, r + 1, n).astype(np.int32)
    batch = rng.permutation(n)[:64].astype(np.int32)
    new_neigh = rng.integers(-1, n, (64, r)).astype(np.int32)
    gj, dj = graph.copy(), degrees.copy()
    gt, dt = graph.copy(), degrees.copy()
    oj, aj = jv._insert_back_edges(gj, dj, batch, new_neigh, r)
    ot, at = tv._insert_back_edges(gt, dt, batch, new_neigh, r)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(ot, oj)
    for a, b in zip(at, aj):
        np.testing.assert_array_equal(a, b)
    assert len(oj) and len(aj[0])  # both outcomes exercised


def _search_inputs(dtype, seed=6):
    """A random graph with -1 holes, OOD rows past the breakpoint and a
    batch that mixes base and query nodes."""
    rng = np.random.default_rng(seed)
    n, d, r = 700, 32, 8
    x = _unit(rng, n, d)
    graph = jv.random_fill(n, r, seed)
    graph[rng.random(graph.shape) < 0.1] = -1
    batch = rng.permutation(n)[:96].astype(np.int32)
    bp = 600
    return x, graph, batch, bp, dtype


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("expand", [1, 2])
def test_greedy_search_matches_jax(dtype, expand):
    x, graph, batch, bp, dtype = _search_inputs(dtype)
    l, maxc, max_steps = 24, 48, 24
    jdev = jv._corpus_on_device(x, dtype)
    base_only = batch >= bp
    med = jv.medioid_dev(jdev, bp)
    js, ji, jsteps = jv._batched_greedy_search(
        jdev, jnp.asarray(graph), jdev[jnp.asarray(batch)], jnp.int32(med), jnp.int32(bp),
        jnp.asarray(base_only), l=l, maxc=maxc, max_steps=max_steps, expand=expand,
    )
    js, ji = np.asarray(js), np.asarray(ji)
    tdev = tv._corpus_on_device(x, dtype, CPU)
    ts, ti, tsteps = tv._batched_greedy_search(
        tdev, _t(graph), tdev[_t(batch).long()], med, bp, _t(base_only),
        l=l, maxc=maxc, max_steps=max_steps, expand=expand,
    )
    ts, ti = ts.numpy(), ti.numpy()
    assert tsteps == int(jsteps)
    assert ti.dtype == np.int32 and ti.shape == ji.shape == (len(batch), maxc)
    if dtype == "int8":
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)
        return
    same = [set(ti[i]) == set(ji[i]) for i in range(len(batch))]
    assert np.mean(same) >= 0.99, np.mean(same)
    for i in range(len(batch)):
        common, a, b = np.intersect1d(ti[i], ji[i], return_indices=True)
        keep = common != INVALID
        np.testing.assert_allclose(ts[i][a[keep]], js[i][b[keep]], rtol=0, atol=1e-5)


def _prune_inputs(seed, ood):
    """A best-first candidate pool per node, with INVALID padding, a
    duplicate-free id row and (with ``ood``) query candidates."""
    rng = np.random.default_rng(seed)
    n, d, c, b = 500, 24, 40, 64
    x = _unit(rng, n, d)
    nodes = rng.permutation(n)[:b].astype(np.int32)
    cand = np.stack([rng.permutation(n)[:c] for _ in range(b)]).astype(np.int32)
    cand[:, 0] = nodes  # a self-candidate, which must never be selected
    cand[rng.random(cand.shape) < 0.15] = INVALID
    bp = 400 if ood else INVALID
    return x, nodes, cand, bp


@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("ood", [False, True], ids=["base", "ood_query_alpha"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_score_sort_prune_matches_jax(saturate, ood, dtype):
    """_score_sort_prune scores and sorts the candidates, then runs
    _batched_robust_prune: both ports against JAX on the same pools."""
    x, nodes, cand, bp = _prune_inputs(11, ood)
    r = 8
    sat = np.full(len(nodes), saturate)
    sat[::5] = True  # rows that saturate in either case, as query nodes do
    jdev = jv._corpus_on_device(x, dtype)
    want = np.asarray(jv._score_sort_prune(
        jdev, jnp.asarray(nodes), jnp.asarray(cand), jnp.float32(1.2), jnp.float32(0.9),
        jnp.int32(bp), jnp.asarray(sat), r=r,
    ))
    tdev = tv._corpus_on_device(x, dtype, CPU)
    got = tv._score_sort_prune(tdev, _t(nodes), _t(cand), 1.2, 0.9, bp, _t(sat), r=r).numpy()
    assert got.dtype == np.int32 and got.shape == (len(nodes), r)
    np.testing.assert_array_equal(got, want)
    assert not (got == nodes[:, None]).any()


@pytest.mark.parametrize("saturate", [False, True])
def test_robust_prune_matches_jax_on_a_search_pool(saturate):
    """The build's order: a greedy-search pool, merged with the existing
    neighbours, then pruned; the same pool into both prunes."""
    x, graph, batch, bp, _ = _search_inputs("int8", seed=9)
    jdev = jv._corpus_on_device(x, "int8")
    med = jv.medioid_dev(jdev, bp)
    q = jdev[jnp.asarray(batch)]
    ps, pi, _ = jv._batched_greedy_search(
        jdev, jnp.asarray(graph), q, jnp.int32(med), jnp.int32(bp),
        jnp.asarray(batch >= bp), l=24, maxc=48, max_steps=24, expand=2,
    )
    existing = graph[batch]
    esafe = np.where(existing >= 0, existing, 0)
    escores = np.asarray(jnp.einsum("bd,brd->br", q, jdev[esafe], preferred_element_type=jnp.float32))
    escores = np.where(existing >= 0, escores, -np.inf).astype(np.float32)
    eids = np.where(existing >= 0, esafe, INVALID).astype(np.int32)
    ji, js = jv._merge_pool(pi, ps, jnp.asarray(eids), jnp.asarray(escores), 48)
    ti, ts = tv._merge_pool(_t(np.asarray(pi)), _t(np.asarray(ps)), _t(eids), _t(escores), 48)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    sat = np.logical_or(saturate, batch >= bp)
    want = np.asarray(jv._batched_robust_prune(
        jdev, jnp.asarray(batch), ji, js, jnp.float32(1.0), jnp.float32(0.9),
        jnp.int32(bp), jnp.asarray(sat), r=8,
    ))
    got = tv._batched_robust_prune(
        tv._corpus_on_device(x, "int8", CPU), _t(batch), ti, ts, 1.0, 0.9, bp, _t(sat), r=8,
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_dedupe_by_id_matches_jax():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 20, (6, 30)).astype(np.int32)
    scores = rng.standard_normal((6, 30)).astype(np.float32)
    js, ji = jv._dedupe_by_id(jnp.asarray(scores), jnp.asarray(ids))
    ts, ti = tv._dedupe_by_id(_t(scores), _t(ids))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _stitch_fixture():
    """tests/test_vamana.py::test_stitch_refill_vectorised_matches_sequential."""
    rng = np.random.default_rng(7)
    n_base, n_query, d, r = 120, 24, 16, 8
    n = n_base + n_query
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    cfg = dict(r=r, l=16, maxc=32, alpha=1.0, batch_size=64, query_breakpoint=n_base,
               max_add_per_stitch_iter=2)
    graph = np.full((n, r), -1, np.int32)
    for i in range(n_base):
        n_b = rng.integers(2, 5)
        base_e = rng.choice(n_base, n_b, replace=False)
        n_q = rng.integers(1, 4)
        query_e = n_base + rng.choice(n_query, n_q, replace=False)
        edges = np.concatenate([base_e, query_e])[:r]
        graph[i, : len(edges)] = edges
    pool = rng.choice(n_base, 12, replace=False)
    for q in range(n_base, n):
        edges = rng.choice(pool, rng.integers(4, 9), replace=False)
        graph[q, : len(edges)] = edges
    return x, graph, cfg, n_base


def test_robust_stitch_matches_jax_sequential():
    x, graph, cfg, n_base = _stitch_fixture()
    want = jv.robust_stitch(x, graph, jv.VamanaConfig(**cfg), _force_sequential=True)
    got = tv.robust_stitch(x, graph, tv.VamanaConfig(**cfg), device=CPU)
    np.testing.assert_array_equal(got, want)
    assert not np.any(got[:n_base] >= n_base)
    # the build's reduced-width corpus in place of an fp32 copy
    dev = tv._corpus_on_device(x, "bf16", CPU)
    want = jv.robust_stitch(x, graph, jv.VamanaConfig(**cfg), _force_sequential=True,
                            corpus_dev=jv._corpus_on_device(x, "bf16"))
    np.testing.assert_array_equal(tv.robust_stitch(x, graph, tv.VamanaConfig(**cfg), corpus_dev=dev), want)
    # no query nodes: the graph comes back as it is
    cfg_all_base = dict(cfg, query_breakpoint=len(x))
    assert tv.robust_stitch(x, graph, tv.VamanaConfig(**cfg_all_base), device=CPU) is graph


def test_search_on_a_jax_graph_matches_jax():
    rng = np.random.default_rng(0)
    x = _unit(rng, 2000, 32)
    cfg = dict(r=16, l=48, maxc=96, alpha=1.0, batch_size=256)
    graph = jv.build_graph(x, jv.VamanaConfig(**cfg), seed=0)
    q = _unit(np.random.default_rng(7), 64, 32)
    js, ji, jsteps = jv.search(x, graph, q, 10, jv.VamanaConfig(**cfg))
    ts, ti, tsteps = tv.search(x, graph, q, 10, tv.VamanaConfig(**cfg), device=CPU)
    assert ti.shape == (64, 10) and ti.dtype == np.int32
    assert (ti == ji).mean() >= 0.99, (ti == ji).mean()
    assert abs(tsteps - jsteps) <= 1
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)


def test_greedy_search_keeps_node_0_seen():
    """The JAX package's seen-bitmap scatter (vamana.py:253-257) sends the
    slots of invalid candidates to node 0 and writes ``seen | valid``
    there; on the CPU the last write lands, so a newly seen node 0 loses
    its mark when an invalid slot follows it, and is scored again later.
    The port writes True at valid slots only. Here the start node 1 links
    to [0, 1] (node 0 new, node 1 seen) and node 0 to itself: the JAX
    pool holds node 0 twice, the port's once, and otherwise they agree."""
    x = _unit(np.random.default_rng(1), 6, 4)
    graph = np.array([[0, 2], [0, 1], [3, -1], [-1, -1], [5, -1], [-1, -1]], np.int32)
    q = x[4:5]
    jdev = jv._corpus_on_device(x, "int8")
    _js, ji, _ = jv._batched_greedy_search(
        jdev, jnp.asarray(graph), jnp.asarray(q), jnp.int32(1), jnp.int32(INVALID),
        jnp.zeros((1,), bool), l=4, maxc=8, max_steps=6,
    )
    _ts, ti, _ = tv._batched_greedy_search(
        tv._corpus_on_device(x, "int8", CPU), _t(graph), _t(q), 1, INVALID,
        torch.zeros(1, dtype=torch.bool), l=4, maxc=8, max_steps=6,
    )
    jids = np.asarray(ji)[0]
    tids = ti.numpy()[0]
    jids, tids = jids[jids != INVALID], tids[tids != INVALID]
    assert sorted(tids.tolist()) == [0, 1, 2, 3]
    assert sorted(jids.tolist()) == [0, 0, 1, 2, 3]
