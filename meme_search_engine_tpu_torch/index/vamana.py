"""Vamana (DiskANN) graph construction and search, batched on the device.

Counterpart of ``meme_search_engine_tpu/index/vamana.py``, whose docstring
describes the design: greedy best-first search, alpha-RNG robust prune,
OOD query vectors (query_breakpoint / query_alpha), RobustStitch, random
fill and medioid selection (diskann/src/lib.rs:183-387), run in batched
synchronous rounds. The JAX package's functions, arguments and defaults
carry over; entry points take ``device`` ("cuda" unless the caller asks
for the CPU), and ``build_graph`` and ``robust_stitch`` also take a corpus
already on a device (``corpus_dev``).

What differs in means, not in result:

- The greedy search's hop loop is a Python loop; the JAX package runs
  ``lax.while_loop`` on the device. Each hop ends with one host sync to
  test whether any beam entry is left unvisited.
- Every top-k keeps ``lax.top_k``'s tie order (the lower index first)
  through a stable descending sort, every ``argsort`` is stable, and each
  ``lexsort`` is two stable sorts (``_lexsort``).
- Dot products of bf16 or int8 rows are fp32 sums of exact products, as
  ``preferred_element_type=f32`` makes them in the JAX package: a bf16
  product would round its result to bf16 and move the prune's
  ``alpha * dot >= score`` test.
- The seen bitmap has one more column, a sink that the slots of invalid
  candidates write to, so every write to a real column writes True. The
  JAX package redirects them to node 0 and writes ``seen | valid`` there;
  when a valid node-0 slot and an invalid slot meet in one scatter, which
  write lands is left open, and node 0 can lose its mark.
- Scatters that the JAX package pads with an out-of-range row and drops
  (``mode="drop"``) take only the real rows here.
- ``robust_stitch`` always runs the reference's exact refill loop in the
  shared native library (``native_io.native_stitch_refill``), as the
  JAX package does by default; it has no Python fallback, and the JAX
  package's ``_force_sequential=True`` loop is the tests' oracle.

**The gathered dots.** Wherever the JAX package gathers rows to multiply
them (each greedy-search hop, the merge of a node's existing neighbours,
the robust prune's candidate block, the overflow re-prune, the stitch),
the port calls a kernel that reads the rows straight into the product, on
every CUDA tensor, with no switch: ``ops.gather.gather_dot`` for the
(B, K) dots of rows with their query, ``ops.gather.gather_gram`` for the
prune's (B, C, C) candidate Gram. Neither writes the gathered (B, K, D)
block out, which the JAX package leaves to XLA to fuse into its einsum.
CPU tensors take their plain versions (gather, upcast, fp32 ``bmm``). Every
other gather stays torch indexing, as it is XLA's gather in the JAX
package on every route.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import gather as _gather
from .native_io import native_stitch_refill
from ..ops.mips import top_k

__all__ = ["VamanaConfig", "build_graph", "medioid", "random_fill", "robust_stitch", "search"]

INVALID = 2**31 - 1
NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class VamanaConfig:
    """Build parameters (reference defaults: lib.rs:41-52,
    generate_index_shard.rs:22-37); the JAX package's fields and defaults,
    whose comments there explain them."""

    r: int = 64  # max out-degree
    l: int = 192  # search list size
    maxc: int = 750  # prune candidate pool
    alpha: float = 65536 / 65536  # RNG diversity factor (fixed-point /2^16)
    saturate_graph: bool = False
    query_breakpoint: int = 2**31 - 1  # ids >= this are OOD query vectors
    query_alpha: float = 1.0
    max_add_per_stitch_iter: int = 16
    batch_size: int = 1024  # nodes per synchronous build round
    max_search_steps: int = 0  # 0 -> auto
    build_expand: int = 2  # beam entries popped per hop during build
    corpus_dtype: str = "bf16"  # device corpus for build-time dots: "bf16" or "int8"
    overflow_flush_rounds: int = 8  # rounds a back-edge overflow waits for its re-prune


def _corpus_on_device(vectors: np.ndarray, dtype: str, device="cuda") -> torch.Tensor:
    """bf16, or int8 with one global scale (every score comparison is
    scale-invariant, so nothing rescales)."""
    if dtype == "int8":
        scale = 127.0 / max(1e-9, float(np.abs(vectors).max()))
        q = np.clip(np.rint(vectors * scale), -127, 127).astype(np.int8)
        return torch.from_numpy(q).to(device)
    if dtype != "bf16":
        raise ValueError(f"corpus_dtype {dtype!r}: 'bf16' or 'int8'")
    return torch.as_tensor(np.asarray(vectors, np.float32)).to(device).to(torch.bfloat16)


def _argmax_mean_dot(x: torch.Tensor) -> int:
    x = x.float()
    return int(torch.argmax(x @ x.mean(dim=0)))


def medioid(vectors: np.ndarray, device="cuda") -> int:
    """Entry point = argmax dot with the corpus mean (lib.rs:54-68)."""
    return _argmax_mean_dot(torch.as_tensor(np.asarray(vectors, np.float32)).to(device))


def medioid_dev(corpus_dev: torch.Tensor, count: Optional[int] = None) -> int:
    """medioid() over a corpus already on the device (its first ``count``
    rows), in fp32 from the build's bf16 or int8 copy; the reduced width
    only perturbs genuine near-ties."""
    return _argmax_mean_dot(corpus_dev[: int(count)] if count is not None else corpus_dev)


def random_fill(n: int, r: int, seed: int = 0) -> np.ndarray:
    """Random R-regular init (lib.rs:376-387), (N, R) int32. Draws with
    replacement, as the reference, so a row can hold an id twice."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, (n, r), dtype=np.int32)


# ---------------------------------------------------------------------------
# device-side primitives
# ---------------------------------------------------------------------------


def _lexsort(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Row-wise order by ``primary``, then ``secondary``, both ascending:
    ``jnp.lexsort((secondary, primary))`` as two stable sorts."""
    o1 = torch.argsort(secondary, dim=1, stable=True)
    o2 = torch.argsort(primary.gather(1, o1), dim=1, stable=True)
    return o1.gather(1, o2)


def _dedupe_by_id(scores, ids):
    """Sort each row by id and mark duplicate ids (-inf, INVALID); the
    first in the row's order (the best, for a best-first row) stays."""
    order = torch.argsort(ids, dim=1, stable=True)
    ids_s = ids.gather(1, order)
    scores_s = scores.gather(1, order)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    return scores_s.masked_fill(dup, NEG_INF), ids_s.masked_fill(dup, INVALID)


def _batched_greedy_search(
    vectors,  # (N, D) bf16/int8/f32 on the device
    graph,  # (N, R) int32, -1 padded
    queries,  # (B, D)
    start: int,
    query_breakpoint: int,
    base_only_mask,  # (B,) bool: rows that skip OOD query nodes
    l: int,
    maxc: int,
    max_steps: int,
    expand: int = 1,
    collect_pool: bool = True,
):
    """Lockstep greedy search for B queries (lib.rs:183-211 semantics).

    Each hop pops the best ``expand`` unvisited beam entries, gathers their
    adjacency rows, scores the neighbours (``gather_dot``), and merges the
    new ones into the (B, l) beam with one top-l.
    ``base_only_mask`` rows never admit OOD query nodes. With
    ``collect_pool`` every scored neighbour is logged for the robust prune.

    Returns (scores (B, P), ids (B, P), steps) where P = maxc (pool mode)
    or l (buffer mode), best-first.
    """
    b = queries.shape[0]
    n, r = graph.shape
    dev = vectors.device
    width = expand * r
    qf = queries.float()
    s0 = qf @ vectors[start].float()

    buf_ids = torch.full((b, l), INVALID, dtype=torch.int32, device=dev)
    buf_ids[:, 0] = start
    buf_scores = torch.full((b, l), NEG_INF, device=dev)
    buf_scores[:, 0] = s0
    buf_visited = torch.zeros((b, l), dtype=torch.bool, device=dev)
    # the reference's visited set (lib.rs:195-199): a neighbour is scored at
    # most once per search. Column n is the sink for invalid slots.
    seen = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
    seen[:, start] = True
    # the scored-neighbour log, written at each hop's offset; allocated once
    pool_n = max_steps * width if collect_pool else 1
    pool_ids = torch.full((b, pool_n), INVALID, dtype=torch.int32, device=dev)
    pool_scores = torch.full((b, pool_n), NEG_INF, device=dev)
    not_base_only = ~base_only_mask[:, None]
    fresh = torch.zeros((b, width), dtype=torch.bool, device=dev)

    steps = 0
    while steps < max_steps:
        # pop the best `expand` unvisited slots (the beam is best-first)
        unvisited = ~buf_visited & (buf_ids != INVALID)
        slots = torch.argsort((~unvisited).to(torch.uint8), dim=1, stable=True)[:, :expand]
        slot_ok = unvisited.gather(1, slots)
        cur = torch.where(slot_ok, buf_ids.gather(1, slots), 0)
        buf_visited.scatter_(1, slots, buf_visited.gather(1, slots) | slot_ok)

        neigh = graph[cur.long()].reshape(b, width)
        valid = neigh >= 0
        neigh_safe = torch.where(valid, neigh, 0)
        nscores = _gather.gather_dot(vectors, neigh_safe, qf)
        valid &= not_base_only | (neigh < query_breakpoint)
        valid &= slot_ok.repeat_interleave(r, dim=1)
        neigh_long = neigh_safe.long()
        valid &= ~seen.gather(1, neigh_long)
        seen.scatter_(1, torch.where(valid, neigh_long, n), True)
        # the same node from two expanded parents: the first slot keeps it
        # (duplicates within one parent's row stay, as in the reference)
        for a in range(1, expand):
            for c in range(a):
                eq = (neigh[:, a * r : (a + 1) * r, None] == neigh[:, None, c * r : (c + 1) * r]).any(2)
                valid[:, a * r : (a + 1) * r] &= ~eq
        nscores = nscores.masked_fill(~valid, NEG_INF)
        nids = neigh.masked_fill(~valid, INVALID)

        # merge into the beam: ids are unique by construction, so one top-l
        m_ids = torch.cat([buf_ids, nids], dim=1)
        m_visited = torch.cat([buf_visited, fresh], dim=1)
        buf_scores, pos = top_k(torch.cat([buf_scores, nscores], dim=1), l)
        buf_ids = m_ids.gather(1, pos)
        buf_visited = m_visited.gather(1, pos)
        if collect_pool:
            pool_ids[:, steps * width : (steps + 1) * width] = nids
            pool_scores[:, steps * width : (steps + 1) * width] = nscores
        steps += 1
        if not bool((~buf_visited & (buf_ids != INVALID)).any()):
            break

    if not collect_pool:
        return buf_scores, buf_ids, steps
    # rank the log and the seed; ids are unique by construction
    p_ids = torch.cat([pool_ids, torch.full((b, 1), start, dtype=torch.int32, device=dev)], 1)
    p_scores = torch.cat([pool_scores, s0[:, None]], 1)
    pool_scores, pos = top_k(p_scores, min(maxc, p_scores.shape[1]))
    return pool_scores, p_ids.gather(1, pos), steps


def _merge_pool(pool_ids, pool_scores, add_ids, add_scores, maxc):
    p_ids = torch.cat([pool_ids, add_ids], dim=1)
    p_scores = torch.cat([pool_scores, add_scores], dim=1)
    p_scores, p_ids = _dedupe_by_id(p_scores, p_ids)
    order = _lexsort(-p_scores, p_ids)
    return p_ids.gather(1, order)[:, :maxc], p_scores.gather(1, order)[:, :maxc]


def _saturate_fill(selected, cand_ids, p_nodes, r):
    """Selected edges first, then the remaining candidates best-first
    (lib.rs:274-284): dedupe by id keeping the lowest rank, drop INVALID
    and self, keep r."""
    b, c = cand_ids.shape
    m_ids = torch.cat([selected, cand_ids], dim=1)
    rank = torch.cat([
        torch.zeros((b, r), dtype=torch.int32, device=m_ids.device),
        torch.arange(1, c + 1, dtype=torch.int32, device=m_ids.device).expand(b, c),
    ], dim=1)
    # by id, lowest rank first: rank already ascends along each row, so one
    # stable sort by id gives jnp.lexsort((rank, m_ids))
    order = torch.argsort(m_ids, dim=1, stable=True)
    m_ids_s = m_ids.gather(1, order)
    rank_s = rank.gather(1, order)
    dup = torch.zeros_like(m_ids_s, dtype=torch.bool)
    dup[:, 1:] = m_ids_s[:, 1:] == m_ids_s[:, :-1]
    keep = ~dup & (m_ids_s != INVALID) & (m_ids_s != p_nodes[:, None])
    m_ids_s = m_ids_s.masked_fill(~keep, INVALID)
    rank_s = rank_s.masked_fill(~keep, 2**30)
    return m_ids_s.gather(1, _lexsort(rank_s, m_ids_s))[:, :r]


def _batched_robust_prune(
    vectors,  # (N, D)
    p_nodes,  # (B,) int32 node being pruned
    cand_ids,  # (B, C) int32 sorted best-first, INVALID padded
    cand_scores,  # (B, C) f32
    alpha: float,
    query_alpha: float,
    query_breakpoint: int,
    saturate,  # (B,) bool (saturate_graph or p is a query node)
    r: int,
):
    """alpha-RNG prune, ParlayANN flavour (lib.rs:227-285), batched.

    All candidate-pair dots come first, as one fp32 (B, C, C) Gram of the
    gathered candidate rows (``gather_gram``). Then r rounds each pick
    the best remaining candidate p* and suppress every candidate c with
    alpha_c * dot(c, p*) >= dot(c, p), alpha_c being query_alpha for OOD
    query candidates (lib.rs:261-265). Returns (B, r) int32, -1 padded.
    """
    b, c = cand_ids.shape
    dev = cand_ids.device
    is_cand = cand_ids != INVALID
    # self-edges are never selected (p_star == p skip, lib.rs:241)
    alive = is_cand & (cand_ids != p_nodes[:, None])
    pair = _gather.gather_gram(vectors, torch.where(is_cand, cand_ids, 0))
    alpha_c = torch.where(
        cand_ids >= query_breakpoint,
        torch.tensor(query_alpha, dtype=torch.float32, device=dev),
        torch.tensor(alpha, dtype=torch.float32, device=dev),
    )

    selected = torch.full((b, r), INVALID, dtype=torch.int32, device=dev)
    n_selected = torch.zeros(b, dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    for i in range(r):
        any_alive = alive.any(dim=1)
        pick = alive.to(torch.uint8).argmax(dim=1)  # the first alive slot
        do_pick = any_alive & (n_selected < r)
        selected[:, i] = torch.where(do_pick, cand_ids[rows, pick], INVALID)
        n_selected += do_pick.int()
        dominated = alpha_c * pair[rows, pick] >= cand_scores
        alive = torch.where(do_pick[:, None], alive & ~dominated, alive)
        # the pick itself always leaves the pool
        alive[rows, pick] &= ~do_pick

    # compact the INVALID gaps left by exhausted rows
    selected = torch.sort(selected, dim=1, stable=True).values
    selected = torch.where(saturate[:, None], _saturate_fill(selected, cand_ids, p_nodes, r), selected)
    return selected.masked_fill(selected == INVALID, -1)


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------


def _empty_edges():
    return (
        np.empty((0, 2), np.int32),
        (np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, np.int32)),
    )


def _insert_back_edges(graph, degrees, batch, new_neigh, r):
    """Vectorised back-edge insertion (lib.rs:311-322 semantics), host
    numpy as in the JAX package.

    For every new edge u -> v, append u to v's adjacency if there is room
    and the edge isn't already present; returns the (v, u) pairs whose
    target rows overflowed R, and the accepted (target, slot, source).
    """
    b, rr = new_neigh.shape
    tgt = new_neigh.ravel()
    src = np.repeat(batch.astype(np.int32), rr)
    ok = tgt >= 0
    tgt, src = tgt[ok], src[ok]
    if len(tgt) == 0:
        return _empty_edges()
    # drop edges already present in the target's row
    present = (graph[tgt] == src[:, None]).any(axis=1)
    tgt, src = tgt[~present], src[~present]
    if len(tgt) == 0:
        return _empty_edges()
    # sort by (v, u); dedupe exact pairs
    key = tgt.astype(np.int64) * (graph.shape[0] + 1) + src
    order = np.argsort(key, kind="stable")
    key_s, tgt, src = key[order], tgt[order], src[order]
    first = np.ones(len(key_s), bool)
    first[1:] = key_s[1:] != key_s[:-1]
    tgt, src = tgt[first], src[first]
    # position within each target group -> free slot index
    newgrp = np.ones(len(tgt), bool)
    newgrp[1:] = tgt[1:] != tgt[:-1]
    starts = np.flatnonzero(newgrp)
    gidx = np.cumsum(newgrp) - 1
    pos = np.arange(len(tgt)) - starts[gidx]
    slot = degrees[tgt] + pos
    accept = slot < r
    graph[tgt[accept], slot[accept]] = src[accept]
    uniq, cnt = np.unique(tgt[accept], return_counts=True)
    degrees[uniq] += cnt.astype(np.int32)
    overflow = np.stack([tgt[~accept], src[~accept]], axis=1).astype(np.int32)
    accepted = (
        tgt[accept].astype(np.int32),
        slot[accept].astype(np.int32),
        src[accept].astype(np.int32),
    )
    return overflow, accepted


def _long(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64)).to(device)


def build_graph(
    vectors: np.ndarray,
    config: VamanaConfig = VamanaConfig(),
    seed: int = 0,
    graph: Optional[np.ndarray] = None,
    verbose: bool = False,
    corpus_dev: Optional[torch.Tensor] = None,
    device="cuda",
) -> np.ndarray:
    """Build the Vamana graph (lib.rs:287-324 flow, batched rounds).

    vectors: (N, D); rows >= config.query_breakpoint are OOD query vectors
    (appended after base data, generate_index_shard.rs:71-94). Returns
    adjacency (N, R) int32, -1 padded. corpus_dev: the output of
    ``_corpus_on_device(vectors, config.corpus_dtype)``, for callers that
    upload once for several passes; the build then runs on its device.
    """
    n, d = vectors.shape
    cfg = config
    rng = np.random.default_rng(seed)
    # 2*l hop budget, divided by the entries each hop visits
    max_steps = cfg.max_search_steps or -(-2 * cfg.l // cfg.build_expand)
    vec_dev = corpus_dev if corpus_dev is not None else _corpus_on_device(vectors, cfg.corpus_dtype, device)
    dev = vec_dev.device
    if graph is None:
        graph = random_fill(n, cfg.r, seed)
    graph = np.asarray(graph, np.int32)
    degrees = np.full((n,), graph.shape[1], np.int32)
    med = medioid_dev(vec_dev, min(n, cfg.query_breakpoint))
    sigmas = rng.permutation(n).astype(np.int32)
    # the graph lives on the device for the whole build; each round's row
    # updates are mirrored onto it in place
    graph_dev = torch.from_numpy(graph.copy()).to(dev)

    pending_overflow = []  # deferred (target, source) back-edge pairs
    rounds_since_flush = 0
    for round_start in range(0, n, cfg.batch_size):
        batch = sigmas[round_start : round_start + cfg.batch_size]
        b = len(batch)
        batch_p = np.pad(batch, (0, cfg.batch_size - b), constant_values=0)
        batch_dev = _long(batch_p, dev)
        queries = vec_dev[batch_dev]
        is_query_node = batch_p >= cfg.query_breakpoint

        # per-row base_only, the reference's per-node flag (lib.rs:298-299):
        # query nodes search base vectors only; base nodes may link query
        # nodes, feeding RobustStitch
        pool_scores, pool_ids, _steps = _batched_greedy_search(
            vec_dev, graph_dev, queries, med, cfg.query_breakpoint,
            torch.from_numpy(is_query_node).to(dev),
            l=cfg.l, maxc=cfg.maxc, max_steps=max_steps, expand=cfg.build_expand,
        )

        # merge existing out-neighbours into the candidate pool (lib.rs:301-304)
        existing = graph[batch_p]
        evalid = torch.from_numpy(existing >= 0).to(dev)
        esafe = torch.from_numpy(np.where(existing >= 0, existing, 0).astype(np.int32)).to(dev)
        escores = _gather.gather_dot(vec_dev, esafe, queries.float()).masked_fill(~evalid, NEG_INF)
        eids = esafe.masked_fill(~evalid, INVALID)
        pool_ids, pool_scores = _merge_pool(pool_ids, pool_scores, eids, escores, cfg.maxc)

        saturate = torch.from_numpy(np.logical_or(cfg.saturate_graph, is_query_node)).to(dev)
        new_neigh_dev = _batched_robust_prune(
            vec_dev, batch_dev.int(), pool_ids, pool_scores, cfg.alpha,
            cfg.query_alpha, cfg.query_breakpoint, saturate, r=cfg.r,
        )[:b]
        new_neigh = new_neigh_dev.cpu().numpy()

        # host: install new adjacency + back-edges (lib.rs:311-322)
        graph[batch] = new_neigh  # prune output is -1-right-padded
        degrees[batch] = (new_neigh >= 0).astype(np.int32).sum(axis=1)
        overflow_nodes, accepted = _insert_back_edges(graph, degrees, batch, new_neigh, cfg.r)

        # mirror on the device: the batch rows, then the accepted back-edges
        acc_t, acc_s, acc_u = accepted
        graph_dev[batch_dev[:b]] = new_neigh_dev
        graph_dev[_long(acc_t, dev), _long(acc_s, dev)] = torch.from_numpy(acc_u).to(dev)

        # defer-and-batch: overflowing back-edge targets accumulate for up
        # to overflow_flush_rounds rounds, then re-prune as one batch
        if len(overflow_nodes):
            pending_overflow.append(overflow_nodes)
        rounds_since_flush += 1
        if pending_overflow and rounds_since_flush >= cfg.overflow_flush_rounds:
            _reprune_overflow(vec_dev, graph, degrees, np.concatenate(pending_overflow), cfg, graph_dev)
            pending_overflow.clear()
            rounds_since_flush = 0
        if verbose and (round_start // cfg.batch_size) % 20 == 0:
            print(f"vamana round {round_start // cfg.batch_size}: {round_start + b}/{n} nodes")

    if pending_overflow:  # flush the tail of the deferral window
        _reprune_overflow(vec_dev, graph, degrees, np.concatenate(pending_overflow), cfg, graph_dev)
    # device-mirror invariant (skipped for huge builds, where the download
    # would cost more than it protects; the host graph is the truth)
    if n <= 100_000 and not np.array_equal(graph_dev.cpu().numpy(), graph):
        raise AssertionError("device graph mirror diverged from host graph")
    return graph


def _reprune_overflow(vec_dev, graph, degrees, overflow_pairs, cfg, graph_dev=None):
    """Batch re-prune nodes whose back-edge insertion overflowed R
    (lib.rs:313-318: merge neighbours + the new edges, robust_prune).

    overflow_pairs: (M, 2) int32 [target v, new source u]. The host graph
    and degrees are updated in place, and so is ``graph_dev`` when given.
    The grouping, the narrow (r + 8) and wide (r + 64) candidate widths and
    the padded batch sizes are the JAX package's.
    """
    dev = vec_dev.device
    tgt = overflow_pairs[:, 0]
    src = overflow_pairs[:, 1]
    # group extras by target, capped at 64 per node (fixed prune width)
    key = tgt.astype(np.int64) * (graph.shape[0] + 1) + src
    order = np.argsort(key, kind="stable")
    key_s, tgt, src = key[order], tgt[order], src[order]
    first = np.ones(len(key_s), bool)
    first[1:] = key_s[1:] != key_s[:-1]
    tgt, src = tgt[first], src[first]
    newgrp = np.ones(len(tgt), bool)
    newgrp[1:] = tgt[1:] != tgt[:-1]
    starts = np.flatnonzero(newgrp)
    gidx = np.cumsum(newgrp) - 1
    pos = np.arange(len(tgt)) - starts[gidx]
    all_nodes = tgt[newgrp]
    extras = np.full((len(all_nodes), 64), INVALID, np.int32)
    keep = pos < 64
    extras[gidx[keep], pos[keep]] = src[keep]
    n_extras = np.bincount(gidx[keep], minlength=len(all_nodes))

    max_chunk = 8192
    out_chunks = []
    small = n_extras <= 8
    for ewidth, sel in ((8, np.flatnonzero(small)), (64, np.flatnonzero(~small))):
        c = cfg.r + ewidth
        for start in range(0, len(sel), max_chunk):
            take = sel[start : start + max_chunk]
            nodes = all_nodes[take]
            b = len(nodes)
            b_min = 256 if ewidth == 64 else 1024
            b_pad = max(b_min, 1 << (b - 1).bit_length())
            rows = graph[nodes].copy()  # int32; INVALID fits
            rows[rows < 0] = INVALID
            # a target's row may have been rebuilt since its overflow was
            # recorded: mask extras already present, so no duplicate ids
            ext = extras[take, :ewidth]
            stale = (rows[:, :, None] == ext[:, None, :]).any(axis=1)
            ext = np.where(stale, INVALID, ext)
            cand = np.full((b_pad, c), INVALID, np.int32)
            cand[:b] = np.concatenate([rows, ext], axis=1)
            nodes_pad = np.concatenate([nodes, np.zeros(b_pad - b, np.int32)]).astype(np.int32)
            saturate = np.logical_or(cfg.saturate_graph, nodes_pad >= cfg.query_breakpoint)
            new_rows_dev = _score_sort_prune(
                vec_dev, torch.from_numpy(nodes_pad).to(dev), torch.from_numpy(cand).to(dev),
                cfg.alpha, cfg.query_alpha, cfg.query_breakpoint,
                torch.from_numpy(saturate).to(dev), r=cfg.r,
            )[:b]
            if graph_dev is not None:
                graph_dev[_long(nodes, dev)] = new_rows_dev
            out_chunks.append((nodes, new_rows_dev))

    for nodes, new_rows_dev in out_chunks:
        new_rows = new_rows_dev.cpu().numpy()
        graph[nodes] = new_rows  # -1-right-padded by the prune
        degrees[nodes] = (new_rows >= 0).astype(np.int32).sum(axis=1)
    return graph_dev


def _score_sort_prune(vec_dev, nodes, cand, alpha, query_alpha, bp, saturate, r: int):
    """Score candidates against their node (``gather_dot``), sort
    best-first (score desc, id asc), prune."""
    valid = cand != INVALID
    scores = _gather.gather_dot(vec_dev, torch.where(valid, cand, 0), vec_dev[nodes.long()].float())
    scores = scores.masked_fill(~valid, NEG_INF)
    order = _lexsort(-scores, cand)
    return _batched_robust_prune(
        vec_dev, nodes, cand.gather(1, order), scores.gather(1, order),
        alpha, query_alpha, bp, saturate, r=r,
    )


def robust_stitch(
    vectors: np.ndarray,
    graph: np.ndarray,
    config: VamanaConfig,
    corpus_dev: Optional[torch.Tensor] = None,
    device="cuda",
) -> np.ndarray:
    """OOD-DiskANN RobustStitch (lib.rs:326-374): remove base->query
    edges; refill each former in-neighbour's spare slots with the query's
    best out-neighbours (scored against the in-neighbour, capped by
    max_add_per_stitch_iter), by the reference's exact sequential loop.

    corpus_dev: a device corpus to reuse (the build's bf16 or int8 copy)
    instead of an fp32 copy of ``vectors`` on ``device``; scores are fp32
    either way, and the reduced width can flip genuine near-tie orders.
    """
    n = graph.shape[0]
    bp = config.query_breakpoint
    if bp >= n:
        return graph
    graph = np.array(graph, np.int32)  # a copy, C-contiguous for the native refill

    # collect and delete base->query edges
    base_rows = graph[:bp]
    is_query_edge = base_rows >= bp
    b_idx, slot_idx = np.nonzero(is_query_edge)
    edge_q = base_rows[b_idx, slot_idx]
    # compact each base row to its kept (base-id) edges, -1 right-padded
    keep = np.logical_and(base_rows >= 0, ~is_query_edge)
    order = np.argsort(~keep, axis=1, kind="stable")
    graph[:bp] = np.where(
        np.take_along_axis(keep, order, 1), np.take_along_axis(base_rows, order, 1), -1
    )
    degrees = (graph >= 0).sum(axis=1)
    if len(b_idx) == 0:
        return graph

    vec_dev = corpus_dev if corpus_dev is not None else torch.as_tensor(
        np.asarray(vectors, np.float32)).to(device)
    dev = vec_dev.device
    # (in_neighbour, query) pairs ordered by query id then base id, as the
    # reference iterates queries and their in-edge lists
    porder = np.lexsort((b_idx, edge_q))
    in_ns = b_idx[porder].astype(np.int32)
    qs = edge_q[porder].astype(np.int32)
    qneigh = graph[qs]  # (P, R) query out-neighbours
    valid = qneigh >= 0
    qsafe = torch.from_numpy(np.where(valid, qneigh, 0).astype(np.int32)).to(dev)
    # one (P, R) product: the kernel never holds the (P, R, D) rows, and
    # the plain version takes them in chunks
    scores = _gather.gather_dot(vec_dev, qsafe, vec_dev[_long(in_ns, dev)].float()).cpu().numpy()
    scores[~valid] = -np.inf
    order = np.argsort(-scores, axis=1)
    cand_sorted = np.take_along_axis(qneigh, order, axis=1)  # (P, R) rank-ordered

    # refill with base nodes only: re-adding query ids would recreate the
    # edges just removed. The loop carries per-in-neighbour state (degree,
    # membership, budget), so it runs as the reference's exact sequential
    # loop in the shared native library (native/diskio.cpp stitch_refill,
    # the JAX package's route too)
    native_stitch_refill(graph, degrees, in_ns, cand_sorted, bp, config.max_add_per_stitch_iter, config.r)
    return graph


# ---------------------------------------------------------------------------
# query-time search over an in-memory graph
# ---------------------------------------------------------------------------


def search(
    vectors: np.ndarray,
    graph: np.ndarray,
    queries: np.ndarray,
    k: int,
    config: VamanaConfig,
    start: Optional[int] = None,
    expand: int = 4,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Batched greedy search returning top-k (scores, ids, steps) as numpy.

    Serving mode: pool-free (the beam buffer is the result set) with
    multi-node beam expansion per step; OOD query nodes are never returned.
    """
    if start is None:
        start = medioid(vectors[: min(len(vectors), config.query_breakpoint)], device)
    vec_dev = torch.as_tensor(np.asarray(vectors, np.float32)).to(device).to(torch.bfloat16)
    graph_dev = torch.as_tensor(np.asarray(graph, np.int32)).to(device)
    q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32))).to(device)
    l = max(config.l, k)
    buf_scores, buf_ids, steps = _batched_greedy_search(
        vec_dev, graph_dev, q, int(start), config.query_breakpoint,
        torch.ones((q.shape[0],), dtype=torch.bool, device=device),
        l=l, maxc=l, max_steps=config.max_search_steps or 4 * l,
        expand=expand, collect_pool=False,
    )
    return buf_scores[:, :k].cpu().numpy(), buf_ids[:, :k].cpu().numpy(), steps
