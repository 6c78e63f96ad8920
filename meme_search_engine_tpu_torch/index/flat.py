"""In-memory brute-force inner-product index (small scale, ~1e5 items).

Counterpart of ``meme_search_engine_tpu/index/flat.py`` (capability
parity with the reference's FAISS-based small-scale index,
src/main.rs:815-896 build_index, :898-933 query_index; fp16 scalar
quantizer, inner product): the vectors live on the device as fp16 and
are scanned by the port's :func:`..ops.mips.mips_topk`, plain torch, as
it is XLA in the JAX package.

Lifecycle matches the reference's online reindexing: ingest streams rows
out of SQLite, a fresh index is built, and the serving handle is swapped
atomically (main.rs:1013-1017). Parallel arrays carry per-item metadata
(filename, format bitmask code, dimensions/frame metadata) exactly like
the reference's ``IIndex`` (main.rs:873-887).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.mips import mips_topk
from ..serving.engine import resolve_device

__all__ = ["FlatIndex", "IndexHandle"]


@dataclass
class FlatIndex:
    """Immutable snapshot of a searchable corpus."""

    vectors: torch.Tensor  # (N, D) fp16 on the device
    filenames: List  # parallel array: item identity
    format_codes: Optional[np.ndarray] = None  # (N,) u64 format bitmask
    metadata: Optional[List] = None  # (w, h, frames) or None per item
    d_emb: int = 0

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        filenames: Sequence,
        format_codes: Optional[np.ndarray] = None,
        metadata: Optional[List] = None,
        device: str | torch.device = "cuda",
    ) -> "FlatIndex":
        """The corpus goes to ``device`` ("cuda" unless the caller asks
        for the CPU; CUDA without a card raises)."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float16)
        n, d = vectors.shape
        if len(filenames) != n:
            raise ValueError(f"{len(filenames)} filenames for {n} vectors")
        dev_vecs = torch.from_numpy(vectors).to(resolve_device(device))
        return cls(
            vectors=dev_vecs,
            filenames=list(filenames),
            format_codes=format_codes,
            metadata=metadata,
            d_emb=d,
        )

    def __len__(self) -> int:
        return int(self.vectors.shape[0])

    def search(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, D) fp32 queries -> (scores (B,k) fp32, indices (B,k) i32)."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        k = min(k, len(self))
        q = torch.from_numpy(queries).to(self.vectors.device)
        scores, idx = mips_topk(self.vectors, q, k)
        return scores.cpu().numpy(), idx.cpu().numpy()


class IndexHandle:
    """Atomically swappable reference to the live index.

    Mirrors the reference's ``RwLock<IIndex>`` swap on reload
    (main.rs:1013-1017): readers always see a complete index; a rebuild
    publishes a new snapshot with one pointer store.
    """

    def __init__(self, index: Optional[FlatIndex] = None):
        self._lock = threading.Lock()
        self._index = index

    @property
    def index(self) -> Optional[FlatIndex]:
        return self._index

    def swap(self, new_index: FlatIndex) -> Optional[FlatIndex]:
        with self._lock:
            old, self._index = self._index, new_index
        return old
