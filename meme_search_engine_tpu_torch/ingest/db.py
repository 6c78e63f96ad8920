"""SQLite state store for the ingest pipeline.

Schema and semantics follow the reference so existing databases migrate
cleanly (src/main.rs:102-127 SCHEMA + PRAGMA user_version migration
loop; :244-261 initialize_database):

  files(filename PK, embedding_time, ocr_time, thumbnail_time,
        embedding BLOB fp16, ocr, raw_ocr_segments, thumbnails, metadata)
  predefined_embeddings(name PK, embedding BLOB fp16)

Per-stage timestamps (µs) make ingest idempotent and restartable: a
stage reruns iff file mtime > stage time (main.rs:722-744).

A copy of ``meme_search_engine_tpu/ingest/db.py``, which the port keeps rather
than imports.
"""

from __future__ import annotations

import json
import sqlite3
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.fp16 import decode_fp16_buffer, encode_fp16_buffer

__all__ = ["FileRecord", "IngestDB", "timestamp_us"]

_MIGRATIONS = [
    """
    CREATE TABLE IF NOT EXISTS files (
        filename BLOB NOT NULL PRIMARY KEY,
        embedding_time INTEGER,
        ocr_time INTEGER,
        thumbnail_time INTEGER,
        metadata_time INTEGER,
        embedding BLOB,
        ocr TEXT,
        raw_ocr_segments BLOB,
        thumbnails BLOB,
        metadata BLOB
    )
    """,
    """
    CREATE TABLE IF NOT EXISTS predefined_embeddings (
        name TEXT NOT NULL PRIMARY KEY,
        embedding BLOB NOT NULL
    )
    """,
    # OCR full-text search: FTS5 index over files.ocr kept in sync by
    # triggers (legacy-backend parity: mse.py:131-158 maintains the same
    # structure for text lookups over OCR'd meme text)
    """
    CREATE VIRTUAL TABLE IF NOT EXISTS ocr_fts USING fts5(
        filename UNINDEXED, ocr
    )
    """,
    """
    CREATE TRIGGER IF NOT EXISTS files_ocr_insert
    AFTER UPDATE OF ocr ON files WHEN new.ocr IS NOT NULL
    BEGIN
        INSERT INTO ocr_fts (filename, ocr) VALUES (new.filename, new.ocr);
    END
    """,
    # v4+: the original trigger was insert-only, so re-OCR duplicated FTS
    # rows and deleting a file left orphans. Recreate it delete-first and
    # purge FTS rows when the file row goes away; clean up any rows the
    # old trigger left behind.
    "DROP TRIGGER IF EXISTS files_ocr_insert",
    """
    CREATE TRIGGER IF NOT EXISTS files_ocr_insert
    AFTER UPDATE OF ocr ON files WHEN new.ocr IS NOT NULL
    BEGIN
        DELETE FROM ocr_fts WHERE filename = new.filename;
        INSERT INTO ocr_fts (filename, ocr) VALUES (new.filename, new.ocr);
    END
    """,
    """
    CREATE TRIGGER IF NOT EXISTS files_ocr_file_delete
    AFTER DELETE ON files
    BEGIN
        DELETE FROM ocr_fts WHERE filename = old.filename;
    END
    """,
    """
    DELETE FROM ocr_fts WHERE rowid NOT IN (
        SELECT MAX(rowid) FROM ocr_fts GROUP BY filename
    )
    """,
    """
    DELETE FROM ocr_fts WHERE filename NOT IN (SELECT filename FROM files)
    """,
]


def timestamp_us() -> int:
    """Microsecond wall-clock timestamp (main.rs:206-208)."""
    return int(time.time() * 1_000_000)


@dataclass
class FileRecord:
    filename: bytes  # encoded Filename (filename.py codec)
    needs_embed: bool = False
    needs_ocr: bool = False
    needs_thumbnail: bool = False
    needs_metadata: bool = False


class IngestDB:
    def __init__(self, path: str):
        # check_same_thread=False: the ingest loop runs stage writes from
        # executor threads; access is serialised by the asyncio design
        # (one ingest at a time, guarded by the /reload lock).
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.execute("PRAGMA journal_mode=WAL")
        self._migrate()

    def _migrate(self):
        cur = self.conn.execute("PRAGMA user_version")
        version = cur.fetchone()[0]
        for i, sql in enumerate(_MIGRATIONS):
            if i < version:
                continue
            self.conn.execute(sql)
            self.conn.execute(f"PRAGMA user_version = {i + 1}")
        self.conn.commit()

    # -- staging ------------------------------------------------------------

    def stage_file(
        self,
        filename: bytes,
        mtime_us: int,
        *,
        want_ocr: bool,
        want_thumbs: bool,
    ) -> FileRecord:
        """Compare mtime against per-stage timestamps (main.rs:722-744)."""
        row = self.conn.execute(
            "SELECT embedding_time, ocr_time, thumbnail_time, metadata_time "
            "FROM files WHERE filename=?",
            (filename,),
        ).fetchone()
        if row is None:
            self.conn.execute(
                "INSERT OR IGNORE INTO files (filename) VALUES (?)", (filename,)
            )
            return FileRecord(
                filename,
                needs_embed=True,
                needs_ocr=want_ocr,
                needs_thumbnail=want_thumbs,
                needs_metadata=True,
            )
        e_t, o_t, t_t, m_t = row
        return FileRecord(
            filename,
            needs_embed=e_t is None or e_t < mtime_us,
            needs_ocr=want_ocr and (o_t is None or o_t < mtime_us),
            needs_thumbnail=want_thumbs and (t_t is None or t_t < mtime_us),
            needs_metadata=m_t is None or m_t < mtime_us,
        )

    # -- stage writes -------------------------------------------------------

    def write_embedding(self, filename: bytes, embedding: np.ndarray):
        self.conn.execute(
            "UPDATE files SET embedding=?, embedding_time=? WHERE filename=?",
            (encode_fp16_buffer(embedding), timestamp_us(), filename),
        )

    def write_thumbnails(self, filename: bytes, thumbs: Dict[str, str]):
        self.conn.execute(
            "UPDATE files SET thumbnails=?, thumbnail_time=? WHERE filename=?",
            (json.dumps(thumbs).encode(), timestamp_us(), filename),
        )

    def write_ocr(self, filename: bytes, text: str, raw_segments: bytes):
        self.conn.execute(
            "UPDATE files SET ocr=?, raw_ocr_segments=?, ocr_time=? "
            "WHERE filename=?",
            (text, raw_segments, timestamp_us(), filename),
        )

    def write_metadata(self, filename: bytes, metadata: dict):
        self.conn.execute(
            "UPDATE files SET metadata=?, metadata_time=? WHERE filename=?",
            (json.dumps(metadata).encode(), timestamp_us(), filename),
        )

    def delete_file(self, filename: bytes):
        self.conn.execute("DELETE FROM files WHERE filename=?", (filename,))

    def commit(self):
        self.conn.commit()

    # -- reads --------------------------------------------------------------

    def all_filenames(self) -> List[bytes]:
        return [
            bytes(r[0])
            for r in self.conn.execute("SELECT filename FROM files")
        ]

    def iter_indexable(
        self,
    ) -> Iterator[Tuple[bytes, np.ndarray, Optional[dict], Optional[dict]]]:
        """Rows with embeddings, for index builds (main.rs:817-896)."""
        cur = self.conn.execute(
            "SELECT filename, embedding, thumbnails, metadata FROM files "
            "WHERE embedding IS NOT NULL"
        )
        for fn, emb, thumbs, meta in cur:
            yield (
                bytes(fn),
                decode_fp16_buffer(emb),
                json.loads(thumbs) if thumbs else None,
                json.loads(meta) if meta else None,
            )

    def predefined_embeddings(self) -> Dict[str, np.ndarray]:
        """Named "slider" embeddings (main.rs:976-985)."""
        return {
            name: decode_fp16_buffer(blob)
            for name, blob in self.conn.execute(
                "SELECT name, embedding FROM predefined_embeddings"
            )
        }

    def search_ocr_text(self, query: str, limit: int = 50):
        """FTS5 match over OCR'd text -> [(filename bytes, rank)]."""
        try:
            rows = self.conn.execute(
                "SELECT filename, rank FROM ocr_fts WHERE ocr_fts MATCH ? "
                "ORDER BY rank LIMIT ?",
                (query, limit),
            ).fetchall()
        except sqlite3.OperationalError:
            return []
        return [(bytes(fn), rank) for fn, rank in rows]

    def set_predefined_embedding(self, name: str, embedding: np.ndarray):
        self.conn.execute(
            "INSERT OR REPLACE INTO predefined_embeddings VALUES (?, ?)",
            (name, encode_fp16_buffer(embedding)),
        )
        self.conn.commit()
