"""Row gathers for the Vamana build, alone and fused into their products.

Counterpart of ``meme_search_engine_tpu/ops/gather.py``. :func:`gather_rows`
takes an (N, D) corpus and (B, K) int32 ids and returns (B, K, D), row
``idx[b, k]`` copied bit for bit. An id out of range is clamped into
[0, N - 1], as XLA's gather clamps it on the JAX package's default route;
the build's callers mask invalid ids to 0 first. CUDA tensors launch
``csrc/gather.cu`` (a byte copy, so any element type); CPU tensors take the
plain version, :func:`gather_rows_plain`. The TPU kernel's D % 128 == 0 rule
came from the TPU's 128 lanes and is not kept.

The build consumes its gathered rows in two dot forms, which the JAX
package runs after the gather (``index/vamana.py``). Each has a kernel that
reads the rows straight into its product, so the (B, K, D) block never
reaches device memory:

- :func:`gather_dot`: ``out[b, k] = sum_d float(V[idx[b, k]][d]) * q[b][d]``,
  fp32, for the greedy-search hop, the re-prune's scores, the merge of a
  node's existing neighbours and the stitch (``csrc/gather_dot.cu``, rows by
  bulk copies into shared memory; bf16, int8 or fp32 rows).
- :func:`gather_gram`: ``pair[b] = float(V[ids[b]]) @ float(V[ids[b]]).T``,
  (B, C, C) fp32, for the robust prune (``csrc/gather_gram.cu``, rows by
  cp.async into a swizzled ring, wgmma; bf16 or int8 rows).

Ids clamp as in :func:`gather_rows`. CPU tensors take the plain versions,
:func:`gather_dot_plain` and :func:`gather_gram_plain`, which gather and
then multiply in fp32 as the build did before these kernels. ``launches``
counts kernel launches; the CPU path never touches it.
"""

from __future__ import annotations

import torch

from . import _build
from .fused import _on_cpu

__all__ = [
    "gather_rows", "gather_rows_plain", "gather_dot", "gather_dot_plain",
    "gather_gram", "gather_gram_plain", "launches", "reset_launches",
]

launches = {"gather_rows": 0, "gather_dot": 0, "gather_gram": 0}

# element type -> the code the dot kernels take
_ELEM = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}
# fp32 elements of the gathered block the plain dot holds at once
_PLAIN_DOT_ELEMS = 1 << 26


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def gather_rows_plain(vectors: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, D) x (B, K) ids -> (B, K, D), ids clamped into [0, N - 1]."""
    return vectors[idx.long().clamp(0, vectors.shape[0] - 1)]


def _check_ids(what: str, vectors: torch.Tensor, idx: torch.Tensor) -> None:
    if vectors.dim() != 2 or idx.dim() != 2:
        raise ValueError(
            f"{what} takes (N, D) vectors and (B, K) ids, got "
            f"{tuple(vectors.shape)} and {tuple(idx.shape)}"
        )
    if idx.dtype != torch.int32:
        raise TypeError(f"{what} takes int32 ids, got {idx.dtype}")
    if vectors.shape[0] == 0 and idx.numel():
        raise ValueError(f"{what}: ids into an empty corpus")


def _kernel_corpus(what: str, vectors: torch.Tensor, kinds) -> int:
    """The element code of a corpus the kernel takes; raises otherwise."""
    if not vectors.is_contiguous():
        raise ValueError(f"{what}: the kernel takes a contiguous corpus")
    if vectors.dtype not in kinds:
        raise TypeError(f"{what}: the kernel takes {', '.join(map(str, kinds))} rows, got {vectors.dtype}")
    return _ELEM[vectors.dtype]


def gather_rows(vectors: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, D) x (B, K) int32 -> (B, K, D) row gather."""
    _check_ids("gather_rows", vectors, idx)
    n, d = vectors.shape
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


def gather_dot_plain(vectors: torch.Tensor, idx: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(N, D) x (B, K) ids x (B, D) -> (B, K) fp32: the gathered rows
    upcast to fp32, times q in fp32 (TF32 off on the card). Takes the
    queries in chunks, so the fp32 block stays under 256 MB."""
    b, k = idx.shape
    out = torch.empty((b, k), dtype=torch.float32, device=vectors.device)
    step = max(1, _PLAIN_DOT_ELEMS // max(1, k * vectors.shape[1]))
    for s in range(0, b, step):
        rows = gather_rows_plain(vectors, idx[s : s + step]).float()
        out[s : s + step] = torch.bmm(rows, q[s : s + step].float()[:, :, None])[..., 0]
    return out


def gather_dot(vectors: torch.Tensor, idx: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(N, D) x (B, K) int32 x (B, D) fp32 -> (B, K) fp32 dots of the
    gathered rows with their query."""
    _check_ids("gather_dot", vectors, idx)
    n, d = vectors.shape
    b, k = idx.shape
    if q.dtype != torch.float32:
        raise TypeError(f"gather_dot takes fp32 queries, got {q.dtype}")
    if tuple(q.shape) != (b, d):
        raise ValueError(f"gather_dot: queries {tuple(q.shape)}, expected {(b, d)}")
    if _on_cpu(vectors, idx, q):
        return gather_dot_plain(vectors, idx, q)
    elem = _kernel_corpus("gather_dot", vectors, (torch.bfloat16, torch.int8, torch.float32))
    if b * k == 0:
        return torch.empty((b, k), dtype=torch.float32, device=vectors.device)
    if d == 0:
        return torch.zeros((b, k), dtype=torch.float32, device=vectors.device)
    idx, q = idx.contiguous(), q.contiguous()
    out = torch.empty((b, k), dtype=torch.float32, device=vectors.device)
    err = _build.library("gather_dot").mse_gather_dot(
        vectors.data_ptr(), idx.data_ptr(), q.data_ptr(), out.data_ptr(), n, b, k, d, elem,
        _build.stream_ptr(vectors.device),
    )
    _build.check(err, "gather_dot")
    launches["gather_dot"] += 1
    return out


def gather_gram_plain(vectors: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(N, D) x (B, C) ids -> (B, C, C) fp32 Gram of the gathered rows,
    upcast to fp32 (TF32 off on the card)."""
    rows = gather_rows_plain(vectors, ids).float()
    return torch.bmm(rows, rows.transpose(1, 2))


def gather_gram(vectors: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(N, D) x (B, C) int32 -> (B, C, C) fp32 Gram of each row's gathered
    candidates."""
    _check_ids("gather_gram", vectors, ids)
    n, d = vectors.shape
    b, c = ids.shape
    if _on_cpu(vectors, ids):
        return gather_gram_plain(vectors, ids)
    elem = _kernel_corpus("gather_gram", vectors, (torch.bfloat16, torch.int8))
    if b * c == 0:
        return torch.empty((b, c, c), dtype=torch.float32, device=vectors.device)
    if d == 0:
        return torch.zeros((b, c, c), dtype=torch.float32, device=vectors.device)
    ids = ids.contiguous()
    out = torch.empty((b, c, c), dtype=torch.float32, device=vectors.device)
    err = _build.library("gather_gram").mse_gather_gram(
        vectors.data_ptr(), ids.data_ptr(), out.data_ptr(), n, b, c,
        d * vectors.element_size(), elem, _build.stream_ptr(vectors.device),
    )
    _build.check(err, "gather_gram")
    launches["gather_gram"] += 1
    return out
