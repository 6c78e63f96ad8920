"""Corpus-sharded multi-device MIPS search.

Counterpart of ``meme_search_engine_tpu/parallel/sharded.py``: the corpus
rows are split over the mesh's ``data`` ranks, each rank scans its slice
with ``ops/mips.mips_topk``, and every rank's top-k candidates are
all-gathered and merged, so k x ranks candidates cross the interconnect
instead of the corpus. The merge keeps ``lax.top_k``'s tie order over
the shard-major candidate list, as the JAX package's merge does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.mips import mips_topk, top_k
from .mesh import Mesh

__all__ = ["ShardedFlatIndex", "sharded_mips_topk"]


def sharded_mips_topk(
    corpus_shard: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mesh: Mesh,
    tile: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a corpus whose rows are split evenly over ``data``.

    corpus_shard: this rank's (N / data, D) rows, rank d holding rows
    [d N / data, (d + 1) N / data); queries: (B, D), the same on every
    rank. Returns (scores fp32, global row ids int64), each (B, min(k,
    data * k')), k' = min(k, N / data), the same on every rank.
    """
    shard_rows = corpus_shard.shape[0]
    local_k = min(k, shard_rows)
    s, i = mips_topk(corpus_shard, queries.float(), local_k, tile=min(tile, shard_rows))
    gi = i.long() + mesh.data_rank * shard_rows
    all_s = [torch.empty_like(s) for _ in range(mesh.data)]
    all_i = [torch.empty_like(gi) for _ in range(mesh.data)]
    dist.all_gather(all_s, s.contiguous(), group=mesh.data_group)
    dist.all_gather(all_i, gi.contiguous(), group=mesh.data_group)
    b = queries.shape[0]
    # (S, B, k') -> (B, S * k'), shard-major, as JAX's moveaxis + reshape
    all_s = torch.stack(all_s, 1).reshape(b, -1)
    all_i = torch.stack(all_i, 1).reshape(b, -1)
    top_s, pos = top_k(all_s, min(k, all_s.shape[1]))
    return top_s, all_i.gather(1, pos)


class ShardedFlatIndex:
    """Flat index whose rows are split over the mesh's ``data`` ranks.

    Rows are padded to a multiple of the data size with zero rows; the
    search asks for 8 more than k and drops the pad rows' ids on the
    host (JAX ``sharded.py:90-104``). Every rank constructs it from the
    whole array and keeps its slice, fp16, on the mesh's device.
    """

    def __init__(self, vectors: np.ndarray, mesh: Mesh, tile: int = 8192):
        self.mesh = mesh
        self.n = vectors.shape[0]
        pad = (-self.n) % mesh.data
        if pad:
            vectors = np.concatenate([vectors, np.zeros((pad, vectors.shape[1]), vectors.dtype)])
        self.n_padded = vectors.shape[0]
        rows = self.n_padded // mesh.data
        mine = vectors[mesh.data_rank * rows : (mesh.data_rank + 1) * rows]
        self.tile = tile
        self.vectors = torch.from_numpy(np.ascontiguousarray(mine, np.float16)).to(mesh.device)

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(B, D) queries -> (scores (B, min(k, n)) fp32, ids int64), on the host."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        kq = min(k + 8, self.n_padded)  # slack for pad sentinels
        q = torch.from_numpy(queries).to(self.mesh.device)
        s, i = sharded_mips_topk(self.vectors, q, kq, self.mesh, self.tile)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        out_s = np.empty((s.shape[0], min(k, self.n)), np.float32)
        out_i = np.empty_like(out_s, dtype=np.int64)
        for b in range(s.shape[0]):
            valid = i[b] < self.n
            out_s[b] = s[b][valid][: out_s.shape[1]]
            out_i[b] = i[b][valid][: out_s.shape[1]]
        return out_s, out_i
