"""Online ingest pipeline: directory scan -> embed/thumbnail/OCR -> index.

Counterpart of ``meme_search_engine_tpu/ingest/pipeline.py``, same stages,
counters and ``reload()``. Reference counterpart: ``ingest_files``
(src/main.rs:598-813) and ``build_index`` (:815-896). The shape is the
same — a staged, resumable pipeline keyed on per-stage SQLite timestamps
— with asyncio + thread pools feeding one embedding stream on the card
instead of tokio mpsc fan-out:

  scan (mtime map) -> stage (needs_*) -> decode pool (CPU)
      -> embed batcher (backend-batch chunks, 3 in flight; main.rs:680-694)
      -> thumbnailer pool
      -> OCR (optional, network)
      -> metadata writer
  then: stream DB rows -> FlatIndex build -> atomic handle swap
        (main.rs:1013-1017)

Failures in any per-file stage are counted and skipped, never fatal
(main.rs:381-432 behaviour).

The index and the in-process engine live on ``config["device"]``,
"cuda" unless the config asks for "cpu". The service's Prometheus
counters (ingest and query) sit in a registry of their own, made on
first use (:func:`metrics`), not in the process-wide default one, so this
module imports beside the JAX package's. PIL and ``prometheus_client``
are imported where they are used.
"""

from __future__ import annotations

import asyncio
import io
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..index.flat import FlatIndex, IndexHandle
from .db import IngestDB
from .filename import Actual, VideoFrame, decode_filename, encode_filename
from .thumbnailer import (
    IMAGE_FORMATS,
    VIDEO_FORMAT_NAME,
    format_bitmask,
    generate_thumbnails,
)

__all__ = ["IngestService", "IngestStats", "count", "metrics"]

_metrics_lock = threading.Lock()
_metrics = None


def metrics() -> Optional[dict]:
    """The small-scale service's counters in a registry of their own (the
    JAX package's names), or None without prometheus_client."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            try:
                from prometheus_client import CollectorRegistry, Counter, Histogram
            except ImportError:
                _metrics = False
                return None
            reg = CollectorRegistry()
            _metrics = {
                "registry": reg,
                "ingested": Counter("mse_ingested_items", "items ingested", ["stage"], registry=reg),
                "errors": Counter("mse_ingest_errors", "ingest errors", ["stage"], registry=reg),
                "queries": Counter("mse_queries", "queries executed", registry=reg),
                "terms": Counter("mse_terms", "terms used in queries, by type", ["type"], registry=reg),
                "qtime": Histogram("mse_query_time", "query execution time", registry=reg),
            }
        return _metrics or None


def count(name: str, label: str) -> None:
    """Add one to the labelled counter ``name`` of :func:`metrics`."""
    m = metrics()
    if m:
        m[name].labels(label).inc()


VIDEO_EXTENSIONS = {".mp4", ".webm", ".mkv", ".avi", ".mov", ".gif"}


@dataclass
class IngestStats:
    embedded: int = 0
    thumbnailed: int = 0
    ocred: int = 0
    deleted: int = 0
    errors: int = 0

    def summary(self) -> str:
        return (
            f"embedded={self.embedded} thumbnailed={self.thumbnailed} "
            f"ocred={self.ocred} deleted={self.deleted} errors={self.errors}"
        )


class IngestService:
    """Owns the DB, the embedder, the thumbnail dir and the live index."""

    def __init__(self, config: dict, db: IngestDB, embedder):
        self.config = config
        self.db = db
        self.embedder = embedder
        self.device = config.get("device", "cuda")
        self.handle = IndexHandle()
        self.formats: List[str] = sorted(IMAGE_FORMATS) + [VIDEO_FORMAT_NAME]
        self.extensions = {
            name: cfg.extension for name, cfg in IMAGE_FORMATS.items()
        }
        self.predefined_embeddings = db.predefined_embeddings()
        self._decode_pool = ThreadPoolExecutor(
            max_workers=int(config.get("decode_threads", os.cpu_count() or 4))
        )

    @classmethod
    async def create(cls, config: dict) -> "IngestService":
        db = IngestDB(config["db_path"])
        if config.get("clip_server"):
            from ..serving.client import RemoteEmbedder

            embedder = RemoteEmbedder(config["clip_server"])
            await embedder.connect()
        else:
            from ..serving.client import InProcessEmbedder
            from ..serving.clip_server import build_engine

            # the checkpoint's weights, or random-init ones from a
            # generator seeded 0, on config["device"]
            engine = build_engine(config, tiny=bool(config.get("tiny_model")))
            embedder = InProcessEmbedder(engine)
        return cls(config, db, embedder)

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------

    def _scan(self) -> Dict[str, float]:
        """relative path -> mtime for all files under the library root."""
        root = self.config["files"]
        out: Dict[str, float] = {}
        for dirpath, _dirnames, filenames in os.walk(root):
            for fn in filenames:
                path = os.path.join(dirpath, fn)
                try:
                    out[os.path.relpath(path, root)] = os.path.getmtime(path)
                except OSError:
                    continue
        return out

    async def _load_images(
        self, rel: str
    ) -> List[Tuple[bytes, "object", Optional[Tuple[int, int]]]]:
        """Decode a file into one or more (encoded_name, PIL image, dims).

        Image decode failure falls back to video frame extraction
        (main.rs:377-470), producing VideoFrame identities.
        """
        from PIL import Image

        path = os.path.join(self.config["files"], rel)
        loop = asyncio.get_event_loop()

        def decode():
            with Image.open(path) as img:
                img.load()
                return img.convert("RGB")

        try:
            img = await loop.run_in_executor(self._decode_pool, decode)
            return [(encode_filename(Actual(rel)), img, img.size)]
        except Exception:  # noqa: BLE001 — try video fallback
            pass

        from . import video

        if not video.video_available():
            raise RuntimeError(f"cannot decode {rel} (no video backend)")

        def extract():
            frames = []
            for n, arr in enumerate(
                video.extract_frames(
                    path, max_dim=int(self.config.get("video_max_dim", 1280))
                )
            ):
                frames.append(
                    (
                        encode_filename(VideoFrame(rel, n)),
                        Image.fromarray(arr),
                        (arr.shape[1], arr.shape[0]),
                    )
                )
            return frames

        return await loop.run_in_executor(self._decode_pool, extract)

    async def ingest(self) -> IngestStats:
        stats = IngestStats()
        mtimes = self._scan()
        want_thumbs = bool(self.config.get("enable_thumbs", False))
        want_ocr = bool(self.config.get("enable_ocr", False))
        thumb_dir = self.config.get("thumbs_path")
        if want_thumbs and thumb_dir:
            os.makedirs(thumb_dir, exist_ok=True)

        batch_size = self.embedder.config.batch
        embed_sem = asyncio.Semaphore(3)  # 3 batches in flight (main.rs:680)
        pending: List[Tuple[bytes, np.ndarray]] = []
        flushes = []

        async def flush_embeds(batch):
            async with embed_sem:
                try:
                    bufs = []
                    for _fn, arr in batch:
                        buf = io.BytesIO()
                        from PIL import Image

                        Image.fromarray(arr).save(buf, "BMP")
                        bufs.append(buf.getvalue())
                    embs = await self.embedder.embed_image_bytes(bufs)
                    for (fn, _), emb in zip(batch, embs):
                        self.db.write_embedding(fn, emb)
                        stats.embedded += 1
                        count("ingested", "embed")
                    self.db.commit()
                except Exception as e:  # noqa: BLE001
                    stats.errors += len(batch)
                    count("errors", "embed")
                    print(f"embed batch failed: {e}")

        from .preprocess_shim import prepare_for_embed

        for rel, mtime in sorted(mtimes.items()):
            mtime_us = int(mtime * 1_000_000)
            record = self.db.stage_file(
                encode_filename(Actual(rel)),
                mtime_us,
                want_ocr=want_ocr,
                want_thumbs=want_thumbs,
            )
            if not (
                record.needs_embed
                or record.needs_ocr
                or record.needs_thumbnail
                or record.needs_metadata
            ):
                continue
            try:
                items = await self._load_images(rel)
            except Exception:  # noqa: BLE001
                stats.errors += 1
                count("errors", "decode")
                continue

            for fn_enc, img, dims in items:
                if fn_enc != record.filename:
                    # ensure video-frame rows exist with their own staging
                    self.db.stage_file(
                        fn_enc, mtime_us, want_ocr=False, want_thumbs=False
                    )
                if record.needs_embed:
                    arr = prepare_for_embed(np.asarray(img), self.embedder.config)
                    pending.append((fn_enc, arr))
                    if len(pending) >= batch_size:
                        flushes.append(
                            asyncio.ensure_future(flush_embeds(pending))
                        )
                        pending = []
                if record.needs_metadata:
                    self.db.write_metadata(
                        fn_enc, {"dimension": list(dims)} if dims else {}
                    )

            first = items[0]
            if record.needs_thumbnail and thumb_dir:
                try:
                    thumbs = generate_thumbnails(
                        decode_filename(first[0]),
                        first[1],
                        os.path.getsize(
                            os.path.join(self.config["files"], rel)
                        ),
                    )
                    names = {}
                    for name, (tn, data) in thumbs.items():
                        with open(os.path.join(thumb_dir, tn), "wb") as f:
                            f.write(data)
                        names[name] = tn
                    self.db.write_thumbnails(record.filename, names)
                    stats.thumbnailed += 1
                except Exception:  # noqa: BLE001
                    stats.errors += 1
            if record.needs_ocr:
                try:
                    from .ocr import ocr_image

                    text, segments = ocr_image(first[1])
                    self.db.write_ocr(
                        record.filename, text, json.dumps(segments).encode()
                    )
                    stats.ocred += 1
                except Exception:  # noqa: BLE001
                    stats.errors += 1

        if pending:
            flushes.append(asyncio.ensure_future(flush_embeds(pending)))
        if flushes:
            await asyncio.gather(*flushes)

        # cleanup: drop DB rows for vanished files / stale frames
        # (main.rs:769-794)
        live = set(mtimes)
        for fn_enc in self.db.all_filenames():
            fname = decode_filename(fn_enc)
            container = (
                fname.container if isinstance(fname, VideoFrame) else fname.path
            )
            if container not in live:
                self.db.delete_file(fn_enc)
                stats.deleted += 1
        self.db.commit()
        return stats

    # ------------------------------------------------------------------
    # index build
    # ------------------------------------------------------------------

    def build_index(self) -> FlatIndex:
        filenames, vecs, codes, metas = [], [], [], []
        d_emb = self.embedder.config.embedding_size
        for fn, emb, thumbs, meta in self.db.iter_indexable():
            if emb.shape[0] != d_emb:
                continue
            fname = decode_filename(fn)
            fmt_names = sorted(thumbs) if thumbs else []
            if isinstance(fname, VideoFrame):
                fmt_names.append(VIDEO_FORMAT_NAME)
            filenames.append(fname)
            vecs.append(emb.astype(np.float16))
            codes.append(format_bitmask(fmt_names, self.formats))
            dims = (meta or {}).get("dimension")
            metas.append(tuple(dims) if dims else None)
        if not vecs:
            return FlatIndex.build(
                np.zeros((0, d_emb), np.float16), [], np.zeros(0, np.uint64), [],
                device=self.device,
            )
        return FlatIndex.build(
            np.stack(vecs),
            filenames,
            np.asarray(codes, np.uint64),
            metas,
            device=self.device,
        )

    async def reload(self) -> str:
        """Full reingest + index rebuild + atomic swap (POST /reload)."""
        stats = await self.ingest()
        index = await asyncio.get_event_loop().run_in_executor(
            None, self.build_index
        )
        self.handle.swap(index)
        return f"indexed {len(index)} items ({stats.summary()})"
