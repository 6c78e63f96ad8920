"""Quality-score descriptor CDFs and u8 bucketing.

Parity with meme-rater/compute_cdf.py: run the wide quality model over
the corpus, build a 255-bin quantile CDF per score channel plus one for
the timestamp, save as ``cdfs.msgpack``; at pack time each node's scores
map through the CDFs to u8 bucket bytes stored in
index.descriptor-codes.bin (dump_processor.rs:479-491). At query time
the u8 columns act as extra dot-product components driven by the
Useful/Meme/Aesthetic/Time sliders (query_disk_index.rs:133-142).

A copy of ``meme_search_engine_tpu/pipeline/descriptors.py``, which the
port keeps rather than imports; ``msgpack`` is imported where it is used.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

N_BUCKETS = 255


def compute_cdfs(
    scores: np.ndarray, timestamps: Sequence[int]
) -> List[np.ndarray]:
    """(N, C) scores + (N,) timestamps -> C+1 quantile boundary arrays
    (255 boundaries each)."""
    qs = np.linspace(0, 1, N_BUCKETS + 1)[1:]  # upper edges
    out = [
        np.quantile(np.asarray(scores[:, c], np.float64), qs)
        for c in range(scores.shape[1])
    ]
    out.append(np.quantile(np.asarray(timestamps, np.float64), qs))
    return [np.asarray(c, np.float32) for c in out]


def bucketize_scores(
    scores: np.ndarray,
    timestamps: Sequence[int],
    cdfs: Sequence[np.ndarray],
) -> np.ndarray:
    """-> (N, C+1) u8: value = number of CDF boundaries below the score
    (uniform-rank bucketing)."""
    n = len(scores)
    cols = []
    for c in range(scores.shape[1]):
        cols.append(np.searchsorted(np.asarray(cdfs[c]), scores[:, c]))
    cols.append(
        np.searchsorted(np.asarray(cdfs[scores.shape[1]]), np.asarray(timestamps))
    )
    return np.clip(np.stack(cols, axis=1), 0, 255).astype(np.uint8)


def save_cdfs(cdfs: Sequence[np.ndarray], path: str):
    import msgpack

    with open(path, "wb") as f:
        f.write(msgpack.packb([list(map(float, c)) for c in cdfs]))


def load_cdfs(path: str) -> List[np.ndarray]:
    import msgpack

    with open(path, "rb") as f:
        return [np.asarray(c, np.float32) for c in msgpack.unpackb(f.read())]
