"""SAE feature export + embedding-file utilities.

Parity with sae/export_features.py (decoder rows +- queried against a
live search backend -> HTML exemplar sheets), sae/shared.py (memmap'd
fp16 embedding files) and sae/shuffle.py (disk-shuffling large
embedding files so SGD batches are decorrelated).

A copy of ``meme_search_engine_tpu/models/sae_tools.py`` over the port's
``models/sae.py``; ``search_fn`` may be any search, the port's
``FlatIndex`` for one.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np


def open_embeddings_memmap(path: str, d_emb: int) -> np.ndarray:
    """fp16 (N, D) memmap (sae/shared.py:1-12)."""
    size = os.path.getsize(path)
    n = size // (2 * d_emb)
    return np.memmap(path, dtype=np.float16, mode="r", shape=(n, d_emb))


def shuffle_embeddings_file(
    in_path: str, out_path: str, d_emb: int, *, chunk: int = 65536, seed: int = 0
):
    """Disk shuffle in two passes: scatter rows into random buckets, then
    permute within each bucket (sae/shuffle.py role without arrow)."""
    rng = np.random.default_rng(seed)
    data = open_embeddings_memmap(in_path, d_emb)
    n = len(data)
    n_buckets = max(1, (n + chunk - 1) // chunk)
    assign = rng.integers(0, n_buckets, n)
    buckets: List[List[int]] = [[] for _ in range(n_buckets)]
    for i, b in enumerate(assign):
        buckets[b].append(i)
    with open(out_path, "wb") as out:
        for bucket in buckets:
            rows = data[np.asarray(bucket, np.int64)]
            rows = rows[rng.permutation(len(rows))]
            out.write(np.ascontiguousarray(rows).tobytes())


def feature_exemplars(
    params,
    search_fn: Callable[[np.ndarray, int], Sequence],
    feature_ids: Sequence[int],
    *,
    k: int = 10,
) -> dict:
    """For each SAE feature, the top library items along +decoder row and
    -decoder row (export_features.py: each direction of a feature can
    mean something different).

    ``search_fn(embedding, k)`` -> [(score, name/url), ...] — typically a
    wrapper over the flat index or the query HTTP API.
    """
    from .sae import decoder_features

    rows = decoder_features(params)
    out = {}
    for fid in feature_ids:
        row = rows[fid].astype(np.float32)
        norm = np.linalg.norm(row)
        if norm == 0:
            continue
        row = row / norm
        out[fid] = {
            "positive": list(search_fn(row, k)),
            "negative": list(search_fn(-row, k)),
        }
    return out


def exemplar_sheet_html(
    exemplars: dict, image_prefix: str = "", max_features: Optional[int] = None
) -> str:
    """HTML grid of per-feature exemplars (export_features.py output)."""
    parts = [
        "<!doctype html><html><head><style>img{max-height:128px;margin:2px}"
        "h3{color:#333;font-family:sans-serif}</style></head><body>"
    ]
    for i, (fid, dirs) in enumerate(sorted(exemplars.items())):
        if max_features is not None and i >= max_features:
            break
        for sign in ("positive", "negative"):
            imgs = "".join(
                f'<img src="{image_prefix}{name}" title="{score:.3f}">'
                for score, name in dirs[sign]
            )
            parts.append(f"<h3>feature {fid} ({sign})</h3><div>{imgs}</div>")
    parts.append("</body></html>")
    return "".join(parts)
