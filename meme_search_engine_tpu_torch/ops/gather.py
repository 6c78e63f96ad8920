"""Row gather for the Vamana build.

Counterpart of ``meme_search_engine_tpu/ops/gather.py``. :func:`gather_rows`
takes an (N, D) corpus and (B, K) int32 ids and returns (B, K, D), row
``idx[b, k]`` copied bit for bit. An id out of range is clamped into
[0, N - 1], as XLA's gather clamps it on the JAX package's default route;
the build's callers mask invalid ids to 0 first. CUDA tensors launch
``csrc/gather.cu`` (a byte copy, so any element type; the build keeps bf16
or int8 rows); CPU tensors take the plain version, :func:`gather_rows_plain`.
The TPU kernel's D % 128 == 0 rule came from the TPU's 128 lanes and is
not kept. ``launches`` counts kernel launches; the CPU path never touches it.
"""

from __future__ import annotations

import torch

from . import _build
from .fused import _on_cpu

__all__ = ["gather_rows", "gather_rows_plain", "launches", "reset_launches"]

launches = {"gather_rows": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def gather_rows_plain(vectors: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, D) x (B, K) ids -> (B, K, D), ids clamped into [0, N - 1]."""
    return vectors[idx.long().clamp(0, vectors.shape[0] - 1)]


def gather_rows(vectors: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, D) x (B, K) int32 -> (B, K, D) row gather."""
    if vectors.dim() != 2 or idx.dim() != 2:
        raise ValueError(
            f"gather_rows takes (N, D) vectors and (B, K) ids, got "
            f"{tuple(vectors.shape)} and {tuple(idx.shape)}"
        )
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_rows takes int32 ids, got {idx.dtype}")
    n, d = vectors.shape
    if n == 0 and idx.numel():
        raise ValueError("gather_rows: ids into an empty corpus")
    if _on_cpu(vectors, idx):
        return gather_rows_plain(vectors, idx)
    if not vectors.is_contiguous():
        raise ValueError("gather_rows: the kernel takes a contiguous corpus")
    b, k = idx.shape
    out = torch.empty((b, k, d), dtype=vectors.dtype, device=vectors.device)
    if out.numel() == 0:  # no ids, or rows of no bytes: nothing to launch
        return out
    idx = idx.contiguous()
    err = _build.library("gather").mse_gather_rows(
        vectors.data_ptr(), idx.data_ptr(), out.data_ptr(), n, b * k,
        d * vectors.element_size(), _build.stream_ptr(vectors.device),
    )
    _build.check(err, "gather_rows")
    launches["gather_rows"] += 1
    return out
