"""Maximum-inner-product search over a corpus resident on the device.

Counterpart of ``meme_search_engine_tpu/ops/mips.py``, which is XLA there,
so it is plain torch here: fp32 products over corpus tiles, each tile's
top-k merged with the running top-k. It is the graph build's evaluation
oracle.

Ties keep ``lax.top_k``'s order, the lower index first: every top-k here
is a stable descending sort cut to k (``torch.topk`` promises no order).
Functions take tensors and answer on their device, except
:func:`streamed_mips_topk`, which streams host slabs and answers numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["mips_topk", "exact_scores", "streamed_mips_topk", "dedup_matches", "top_k"]


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: (values, positions), best first,
    equal values in index order."""
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def exact_scores(corpus: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(N, D) x (B, D) -> (B, N) fp32 inner products. Brute-force oracle."""
    return queries.float() @ corpus.float().T


def mips_topk(
    corpus: torch.Tensor, queries: torch.Tensor, k: int, *, tile: int = 16384
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner-product search: (scores, indices), each (B, min(k, N)),
    scores fp32 descending, indices int32 into the corpus."""
    n = corpus.shape[0]
    b = queries.shape[0]
    k_eff = min(k, n)
    qf = queries.float()
    best_s = torch.full((b, k_eff), -float("inf"), device=corpus.device)
    best_i = torch.zeros((b, k_eff), dtype=torch.int64, device=corpus.device)
    for base in range(0, n, tile):
        s = qf @ corpus[base : base + tile].float().T
        ts, ti = top_k(s, min(k_eff, tile))
        # merge: the running top-k first, so it wins ties
        ms = torch.cat([best_s, ts], dim=1)
        mi = torch.cat([best_i, ti + base], dim=1)
        best_s, pos = top_k(ms, k_eff)
        best_i = mi.gather(1, pos)
    return best_s, best_i.int()


def streamed_mips_topk(corpus_iter, queries, k, *, tile: int = 16384, device="cuda"):
    """Exact top-k over host slabs streamed through the device once, all
    queries scored against each slab before the next upload.

    corpus_iter yields (slab, base_row): a host (M, D) array and its global
    row offset. Returns host (scores, indices), each (B, k)."""
    qdev = torch.as_tensor(np.asarray(queries, np.float32), device=device)
    b = qdev.shape[0]
    best_s = np.full((b, k), -np.inf, np.float32)
    best_i = np.zeros((b, k), np.int64)
    for slab, base in corpus_iter:
        sdev = torch.as_tensor(np.asarray(slab), device=device)
        s, i = mips_topk(sdev, qdev, k, tile=min(tile, slab.shape[0]))
        s = s.cpu().numpy()
        i = i.cpu().numpy().astype(np.int64) + int(base)
        ms = np.concatenate([best_s, s], axis=1)
        mi = np.concatenate([best_i, i], axis=1)
        sel = np.argsort(-ms, axis=1, kind="stable")[:, :k]
        best_s = np.take_along_axis(ms, sel, axis=1)
        best_i = np.take_along_axis(mi, sel, axis=1)
        del sdev  # the device holds one slab and the running top-k
    return best_s, best_i


def dedup_matches(
    embeddings: torch.Tensor, scores: torch.Tensor, threshold: float = 0.95
) -> torch.Tensor:
    """(M,) bool keep-mask over results ranked by ``scores``: a result is
    dropped if its cosine with an already KEPT higher-ranked result exceeds
    ``threshold`` (query_disk_index.rs:514-527's greedy retain, so a chain
    A > B > C with only A~B and B~C similar keeps C)."""
    e = embeddings.float()
    e = e / e.norm(dim=-1, keepdim=True).clamp_min(1e-30)
    order = torch.argsort(-scores, stable=True)
    es = e[order]
    sim = (es @ es.T).cpu().numpy()
    m = sim.shape[0]
    kept = np.zeros(m, bool)
    for i in range(m):  # sequential in rank, as the reference's loop
        kept[i] = not np.any(kept[:i] & (sim[i, :i] > threshold))
    out = torch.zeros(m, dtype=torch.bool, device=embeddings.device)
    out[order] = torch.from_numpy(kept).to(embeddings.device)
    return out
