"""Rating data layer (meme-rater/shared.py parity).

SQLite tables: files(filename, embedding), ratings(meme1, meme2,
rating, axis?); validation split assigns files by a sha256(filename)
bucket (shared.py:12-15); rating strings map to win probabilities
"1+" 0.9 / "1" 0.7 / "eq" 0.5 / "2" 0.3 / "2+" 0.1 (shared.py:23-38;
the probability is P(meme1 wins)).

A copy of ``meme_search_engine_tpu/rater/data.py`` over the port's
``utils/fp16.py``, which the port keeps rather than imports; a DB either
package writes, the other reads.
"""

from __future__ import annotations

import hashlib
import sqlite3
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.fp16 import decode_fp16_buffer, encode_fp16_buffer

RATING_PROBS: Dict[str, float] = {
    "1+": 0.9,
    "1": 0.7,
    "eq": 0.5,
    "2": 0.3,
    "2+": 0.1,
}

VAL_FRACTION_BUCKETS = 16  # 1/16 of files land in validation


def is_validation(filename: str) -> bool:
    """Deterministic split by hash bucket (shared.py:12-15)."""
    h = hashlib.sha256(filename.encode()).digest()
    return h[0] % VAL_FRACTION_BUCKETS == 0


class RatingsDB:
    def __init__(self, path: str):
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.executescript(
            """
            CREATE TABLE IF NOT EXISTS files (
                filename TEXT PRIMARY KEY,
                embedding BLOB NOT NULL
            );
            CREATE TABLE IF NOT EXISTS ratings (
                meme1 TEXT NOT NULL,
                meme2 TEXT NOT NULL,
                rating TEXT NOT NULL,
                axis TEXT NOT NULL DEFAULT 'useful'
            );
            CREATE TABLE IF NOT EXISTS queue (
                meme1 TEXT NOT NULL,
                meme2 TEXT NOT NULL
            );
            """
        )

    def add_file(self, filename: str, embedding: np.ndarray):
        self.conn.execute(
            "INSERT OR REPLACE INTO files VALUES (?, ?)",
            (filename, encode_fp16_buffer(embedding)),
        )
        self.conn.commit()

    def add_rating(self, meme1: str, meme2: str, rating: str, axis: str = "useful"):
        assert rating in RATING_PROBS
        self.conn.execute(
            "INSERT INTO ratings VALUES (?, ?, ?, ?)", (meme1, meme2, rating, axis)
        )
        self.conn.commit()

    def embeddings(self) -> Dict[str, np.ndarray]:
        return {
            fn: decode_fp16_buffer(e)
            for fn, e in self.conn.execute("SELECT filename, embedding FROM files")
        }

    def pairs(
        self, axes: Optional[List[str]] = None
    ) -> Tuple[np.ndarray, np.ndarray, List[Tuple[str, str]]]:
        """-> (pair embeddings (B, 2, D), win probs (B, n_axes), names).

        Ratings on different axes for the same pair merge into one row
        with per-axis targets (missing axes get 0.5)."""
        embs = self.embeddings()
        axes = axes or ["useful", "meme", "aesthetic"]
        merged: Dict[Tuple[str, str], Dict[str, float]] = {}
        for m1, m2, rating, axis in self.conn.execute(
            "SELECT meme1, meme2, rating, axis FROM ratings"
        ):
            if m1 not in embs or m2 not in embs:
                continue
            merged.setdefault((m1, m2), {})[axis] = RATING_PROBS[rating]
        pair_list, targets, names = [], [], []
        for (m1, m2), by_axis in merged.items():
            pair_list.append(np.stack([embs[m1], embs[m2]]))
            targets.append([by_axis.get(a, 0.5) for a in axes])
            names.append((m1, m2))
        if not pair_list:
            d = next(iter(embs.values())).shape[0] if embs else 0
            return (
                np.zeros((0, 2, d), np.float32),
                np.zeros((0, len(axes)), np.float32),
                [],
            )
        return (
            np.stack(pair_list).astype(np.float32),
            np.asarray(targets, np.float32),
            names,
        )

    def train_val_split(self, axes: Optional[List[str]] = None):
        pairs, targets, names = self.pairs(axes)
        val_mask = np.asarray(
            [is_validation(m1) or is_validation(m2) for m1, m2 in names]
        )
        return (
            (pairs[~val_mask], targets[~val_mask]),
            (pairs[val_mask], targets[val_mask]),
        )

    # queue for the labelling UI (rater_server)
    def push_queue(self, pairs: List[Tuple[str, str]]):
        self.conn.executemany("INSERT INTO queue VALUES (?, ?)", pairs)
        self.conn.commit()

    def pop_queue(self) -> Optional[Tuple[str, str]]:
        row = self.conn.execute(
            "SELECT rowid, meme1, meme2 FROM queue LIMIT 1"
        ).fetchone()
        if row is None:
            return None
        self.conn.execute("DELETE FROM queue WHERE rowid=?", (row[0],))
        self.conn.commit()
        return row[1], row[2]
