"""Small-scale search backend: JSON/HTTP query API over the flat index.

Counterpart of ``meme_search_engine_tpu/serving/query_server.py``, same
endpoints and JSON. Reference counterpart: src/main.rs:898-1095 (axum
service over FAISS). Endpoints:
  GET  /         FrontendInit {n_total, predefined_embedding_names, d_emb}
  POST /         QueryRequest -> QueryResult (wire.py; common.rs:176-209)
  POST /reload   trigger reingest + index rebuild (main.rs:1058-1079)
  GET  /metrics  Prometheus text (the service's own registry,
                 ``ingest.pipeline.metrics``)

Query execution (main.rs:936-965):
  1. fuse terms into one embedding (weighted text/image/raw/predefined,
     negative weights allowed) — embedding batches go to the embedding
     engine, raw vectors sum host-side;
  2. top-k MIPS scan on the card (k default 1000, main.rs:952);
  3. collapse video frames to one hit per container (main.rs:906-917);
  4. emit (score, filename, thumb-hash-key, format bitmask, dims).

Run: ``python -m meme_search_engine_tpu_torch.serving.query_server cfg.json``
with the JAX server's config keys; ``"device"`` ("cuda" by default, or
"cpu" for the plain path) takes the place of its ``"platform"``.
``aiohttp`` is imported where it is used.
"""

from __future__ import annotations

import asyncio
import base64
import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from ..index.flat import FlatIndex, IndexHandle
from ..ingest.filename import Actual, VideoFrame, container_of, decode_filename
from ..ingest.pipeline import count, metrics
from .wire import (
    FrontendInit,
    QueryRequest,
    QueryResult,
    frontend_init_to_json,
    parse_query_request,
    query_result_to_json,
)

__all__ = [
    "DEFAULT_K", "SearchBatcher", "fuse_query_terms", "execute_query",
    "format_results", "make_app", "main",
]

DEFAULT_K = 1000  # reference default search k (main.rs:952)


class SearchBatcher:
    """Micro-batches concurrent MIPS dispatches into one device call.

    Requests enqueue (query, k) futures; a drain task dispatches at once
    whenever a runner is free (so an idle server adds no latency to a
    lone query), and whatever arrives while a dispatch is in flight
    forms the next batch, up to ``max_batch`` rows. Batch rows and k are
    padded to power-of-two buckets, as in the JAX batcher, so a request
    maps to the same device shapes; each request slices its own k rows
    from the padded result.

    Up to ``max_inflight`` batches run concurrently on executor threads
    (``MSE_SEARCH_INFLIGHT``, default 2; a value that is not an integer
    means the default). It is clamped to at least 1: at 0 the JAX batcher
    starts no drain task and every query waits forever.
    """

    def __init__(
        self,
        handle: IndexHandle,
        max_batch: int = 64,
        max_inflight: Optional[int] = None,
    ):
        self._handle = handle
        self._max_batch = max_batch
        if max_inflight is None:
            try:
                max_inflight = int(os.environ.get("MSE_SEARCH_INFLIGHT", "2"))
            except ValueError:
                max_inflight = 2
        self._max_inflight = max(1, max_inflight)
        self._pending: List[tuple] = []
        self._runners: List[asyncio.Task] = []

    async def search(self, qvec: np.ndarray, k: int):
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        self._pending.append((qvec, int(k), fut))
        self._runners = [t for t in self._runners if not t.done()]
        if len(self._runners) < self._max_inflight:
            self._runners.append(loop.create_task(self._drain()))
        return await fut

    @staticmethod
    def _pow2_pad(n: int) -> int:
        return 1 << max(0, (n - 1).bit_length())

    async def _drain(self):
        loop = asyncio.get_event_loop()
        while self._pending:
            batch = self._pending[: self._max_batch]
            del self._pending[: len(batch)]
            # the batch is already dequeued: any exception from here on
            # must resolve every waiter, or their requests hang
            try:
                index = self._handle.index
                if index is None or len(index) == 0:
                    for _q, _k, fut in batch:
                        if not fut.done():
                            fut.set_result(None)
                    continue
                qs = np.stack([q for q, _k, _f in batch]).astype(np.float32)
                b_pad = self._pow2_pad(len(batch))
                if b_pad > len(batch):
                    qs = np.concatenate(
                        [qs, np.zeros((b_pad - len(batch), qs.shape[1]), np.float32)]
                    )
                k_max = min(max(k for _q, k, _f in batch), len(index))
                k_pad = min(self._pow2_pad(k_max), len(index))
                scores, idx = await loop.run_in_executor(
                    None, index.search, qs, k_pad
                )
                for row, (_q, k, fut) in enumerate(batch):
                    if not fut.done():
                        kk = min(k, k_pad)
                        # the snapshot the batch searched: a concurrent
                        # /reload swap must not let a caller resolve these
                        # row ids against a different index
                        fut.set_result((scores[row, :kk], idx[row, :kk], index))
            except Exception as e:  # surface to every waiter
                for _q, _k, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)


async def fuse_query_terms(
    req: QueryRequest,
    embedder,
    d_emb: int,
    predefined: Dict[str, np.ndarray],
) -> np.ndarray:
    """Async weighted fusion (common.rs:215-274 semantics)."""
    total = np.zeros((d_emb,), dtype=np.float32)
    image_batch, image_w, text_batch, text_w = [], [], [], []

    for term in req.terms:
        w = 1.0 if term.weight is None else float(term.weight)
        if term.image is not None:
            count("terms", "image")
            image_batch.append(base64.b64decode(term.image))
            image_w.append(w)
        if term.text is not None:
            count("terms", "text")
            text_batch.append(term.text)
            text_w.append(w)
        if term.embedding is not None:
            count("terms", "embedding")
            total += np.asarray(term.embedding, dtype=np.float32) * w
        if term.predefined_embedding is not None:
            emb = predefined.get(term.predefined_embedding)
            if emb is not None:
                total += np.asarray(emb, dtype=np.float32) * w

    if image_batch:
        embs = await embedder.embed_image_bytes(image_batch)
        total += np.einsum("nd,n->d", embs, np.asarray(image_w, np.float32))
    if text_batch:
        embs = await embedder.embed_texts(text_batch)
        total += np.einsum("nd,n->d", embs, np.asarray(text_w, np.float32))
    return total


def execute_query(
    index: FlatIndex, query: np.ndarray, req: QueryRequest
) -> QueryResult:
    """Search + video-frame dedup + result formatting."""
    k = req.k or DEFAULT_K
    scores, idx = index.search(query[None, :], min(k, len(index)))
    return format_results(index, scores[0], idx[0], req)


def format_results(
    index: FlatIndex, scores: np.ndarray, idx: np.ndarray, req: QueryRequest
) -> QueryResult:
    """Video-frame dedup + result formatting (main.rs:906-917), over
    already-computed top-k rows, so batched dispatches (SearchBatcher)
    share one device call."""
    from ..ingest.thumbnailer import thumbnail_hash_key

    k = req.k or DEFAULT_K
    matches: List[tuple] = []
    seen_containers: Dict[str, int] = {}
    for s, i in zip(scores.tolist(), idx.tolist()):
        fname = index.filenames[i]
        if isinstance(fname, (bytes, bytearray)):
            fname = decode_filename(bytes(fname))
        elif isinstance(fname, str):
            fname = Actual(fname)
        is_video = isinstance(fname, VideoFrame)
        if is_video and not req.include_video:
            continue
        container = container_of(fname)
        if container in seen_containers:
            continue  # one hit per video container (main.rs:906-917)
        seen_containers[container] = len(matches)

        code = (
            int(index.format_codes[i]) if index.format_codes is not None else 0
        )
        meta = index.metadata[i] if index.metadata is not None else None
        dims = tuple(meta[:2]) if meta else None
        display = container if is_video else fname.path
        matches.append((float(s), display, thumbnail_hash_key(display), code, dims))
        if len(matches) >= k:
            break

    return QueryResult(matches=matches)


def make_app(
    handle: IndexHandle,
    embedder,
    *,
    predefined: Optional[Dict[str, np.ndarray]] = None,
    reload_fn=None,
    formats: Optional[List[str]] = None,
    extensions: Optional[Dict[str, str]] = None,
):
    from aiohttp import web

    predefined = predefined or {}
    formats = formats or []
    extensions = extensions or {}
    reload_lock = asyncio.Lock()
    batcher = SearchBatcher(handle)

    def _cors(resp):
        resp.headers["Access-Control-Allow-Origin"] = "*"
        resp.headers["Access-Control-Allow-Headers"] = "*"
        return resp

    async def frontend_init(_request):
        index = handle.index
        init = FrontendInit(
            n_total=len(index) if index else 0,
            predefined_embedding_names=sorted(predefined.keys()),
            d_emb=embedder.config.embedding_size,
        )
        return _cors(web.json_response(frontend_init_to_json(init)))

    async def query(request):
        m = metrics()
        if m:
            m["queries"].inc()
        req = parse_query_request(await request.json())
        index = handle.index
        if index is None or len(index) == 0:
            return _cors(
                web.json_response(
                    query_result_to_json(
                        QueryResult(matches=[], formats=formats, extensions=extensions)
                    )
                )
            )
        qvec = await fuse_query_terms(
            req, embedder, embedder.config.embedding_size, predefined
        )
        hit = await batcher.search(qvec, min(req.k or DEFAULT_K, len(index)))
        if hit is None:  # index emptied by a concurrent swap
            result = QueryResult(matches=[])
        else:
            scores, idx, searched_index = hit
            result = await asyncio.get_event_loop().run_in_executor(
                None, format_results, searched_index, scores, idx, req
            )
        result.formats = formats
        result.extensions = extensions
        return _cors(web.json_response(query_result_to_json(result)))

    async def reload(_request):
        if reload_fn is None:
            return _cors(web.json_response({"status": "no ingest configured"}))
        async with reload_lock:  # one reingest at a time (main.rs:1058-1079)
            status = await reload_fn()
        return _cors(web.json_response({"status": status or "done"}))

    async def metrics_handler(_request):
        m = metrics()
        if m:
            from prometheus_client import generate_latest

            return web.Response(body=generate_latest(m["registry"]))
        return web.Response(status=501)

    async def telemetry(_request):
        # frontend beacons; the small backend just acknowledges them
        return _cors(web.Response(status=204))

    async def options(_request):
        return _cors(web.Response(status=204))

    app = web.Application(client_max_size=2**26)
    app.router.add_get("/", frontend_init)
    app.router.add_post("/", query)
    app.router.add_post("/reload", reload)
    app.router.add_post("/telemetry", telemetry)
    app.router.add_get("/metrics", metrics_handler)
    app.router.add_route("OPTIONS", "/", options)
    return app


def main(argv=None):
    """Combined small-scale service: ingest + index + query API.

    Config (JSON file as argv[1], reference mse_config.json style):
      {"port", "files": dir, "db_path", "clip_server": url | null,
       "enable_thumbs", "enable_ocr", "no_run_server": bool,
       "device": "cuda" (default) | "cpu"}
    With "clip_server": null an in-process engine is created on
    "device"; "cuda" on a host without a card raises.
    """
    from aiohttp import web

    argv = argv if argv is not None else sys.argv[1:]
    with open(argv[0]) as f:
        config = json.load(f)

    async def start():
        from ..ingest.pipeline import IngestService

        service = await IngestService.create(config)
        await service.reload()
        if config.get("no_run_server"):
            return None
        app = make_app(
            service.handle,
            service.embedder,
            predefined=service.predefined_embeddings,
            reload_fn=service.reload,
            formats=service.formats,
            extensions=service.extensions,
        )
        if config.get("serve_frontend", True):
            from .frontend import attach_frontend

            attach_frontend(
                app,
                memes_dir=config.get("files"),
                thumbs_dir=config.get("thumbs_path"),
                friendly_terms=config.get("friendly_mode_default_terms"),
            )
        return app

    loop = asyncio.new_event_loop()
    app = loop.run_until_complete(start())
    if app is not None:
        web.run_app(app, port=int(config.get("port", 1707)), loop=loop)


if __name__ == "__main__":
    main()
