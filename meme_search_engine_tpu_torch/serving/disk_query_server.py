"""Large-scale query service over the disk index.

Counterpart of ``meme_search_engine_tpu/serving/disk_query_server.py``,
same endpoints and JSON. Capability parity with
src/query_disk_index.rs's serve mode (:402-656): POST / executes
QueryRequest against the DiskANN disk index (term fusion via the
embedding backend, descriptor sliders from predefined-embedding names,
:463-473, beam search, score-ordered JSON QueryResult with image URLs),
plus GET / FrontendInit, GET /metrics, and POST /telemetry appending
msgpack events on a dedicated writer thread (:383-392, 562-580).

Concurrency: beam searches run on a thread pool (each search is IO-bound
pointer chasing through the native reader, which releases the GIL) while
the asyncio loop handles HTTP. Text and image terms are embedded by the
embedder the caller passes: a ``RemoteEmbedder`` (the clip server) or an
``InProcessEmbedder`` over the engine, whose towers run on the card.

Run: ``python -m meme_search_engine_tpu_torch.serving.disk_query_server
cfg.json``. ``aiohttp``, ``msgpack`` and ``prometheus_client`` are
imported where they are used; the counters live in a registry of the
app's own.
"""

from __future__ import annotations

import asyncio
import json
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..index.disk_index import DiskIndex
from .wire import (
    FrontendInit,
    QueryResult,
    frontend_init_to_json,
    parse_query_request,
    query_result_to_json,
)

__all__ = ["DESCRIPTOR_NAMES", "TelemetryLog", "make_app", "main"]

DESCRIPTOR_NAMES = ["Useful", "Meme", "Aesthetic", "Time"]


class TelemetryLog:
    """Append-only msgpack event log on its own writer thread
    (query_disk_index.rs:383-392)."""

    def __init__(self, path: str):
        import msgpack

        self._q: "queue.Queue" = queue.Queue(1024)
        self._packb = msgpack.packb

        def writer():
            with open(path, "ab") as f:
                while True:
                    event = self._q.get()
                    if event is None:
                        return
                    f.write(self._packb(event))
                    f.flush()

        self._thread = threading.Thread(target=writer, daemon=True)
        self._thread.start()

    def append(self, event: dict):
        try:
            self._q.put_nowait(event)
        except queue.Full:
            pass

    def close(self):
        """Stop the writer once it has written every queued event."""
        self._q.put(None)
        self._thread.join()


def _metrics():
    """The disk service's counters (the JAX package's names) in a registry
    of their own, or None without prometheus_client."""
    try:
        from prometheus_client import CollectorRegistry, Counter, Histogram
    except ImportError:
        return None
    reg = CollectorRegistry()
    return {
        "registry": reg,
        "queries": Counter("mse_disk_queries", "queries executed", registry=reg),
        "reads": Counter("mse_disk_node_reads", "node reads", registry=reg),
        "pq_cmps": Counter("mse_disk_pq_comparisons", "pq comparisons", registry=reg),
        "qtime": Histogram("mse_disk_query_time", "query time", registry=reg),
    }


def make_app(
    index: DiskIndex,
    embedder,
    *,
    telemetry_path: Optional[str] = None,
    beamwidth: int = 3,
    search_list: int = 1000,
    search_threads: int = 8,
    spec: Optional[int] = None,
):
    from aiohttp import web

    from .query_server import fuse_query_terms

    telemetry = TelemetryLog(telemetry_path) if telemetry_path else None
    pool = ThreadPoolExecutor(max_workers=search_threads)
    d_emb = index.quantizer.n_dims
    m = _metrics()

    def _cors(resp):
        resp.headers["Access-Control-Allow-Origin"] = "*"
        resp.headers["Access-Control-Allow-Headers"] = "*"
        return resp

    async def frontend_init(_request):
        init = FrontendInit(
            n_total=index.header.count - index.header.dead_count,
            predefined_embedding_names=DESCRIPTOR_NAMES,
            d_emb=d_emb,
        )
        return _cors(web.json_response(frontend_init_to_json(init)))

    async def query(request):
        t0 = time.perf_counter()
        if m:
            m["queries"].inc()
        req = parse_query_request(await request.json())

        # descriptor sliders ride predefined_embedding terms whose names
        # match descriptor channels (query_disk_index.rs:463-473)
        scales = np.zeros(index.n_descriptors, np.float32)
        fusion_terms = []
        for term in req.terms:
            name = term.predefined_embedding
            if name in DESCRIPTOR_NAMES:
                idx = DESCRIPTOR_NAMES.index(name)
                if idx < index.n_descriptors:
                    w = 1.0 if term.weight is None else float(term.weight)
                    scales[idx] = w / 512.0
                continue
            fusion_terms.append(term)
        req.terms = fusion_terms

        qvec = await fuse_query_terms(req, embedder, d_emb, {})
        k = req.k or 20

        def run_search():
            return index.search(
                qvec,
                k,
                beamwidth=beamwidth,
                search_list=search_list,
                descriptor_scales=scales,
                spec=spec,
            )

        results, counters = await asyncio.get_running_loop().run_in_executor(pool, run_search)
        if m:
            m["reads"].inc(counters.node_reads)
            m["pq_cmps"].inc(counters.pq_comparisons)

        matches = [
            (
                r.score,
                r.url,
                "",  # no thumbnail store at this scale; URL serves directly
                0,
                tuple(r.dimensions) if r.dimensions else None,
                {"scores": r.scores, "shards": r.shards} if req.debug_enabled else None,
            )
            for r in results
            if r.url  # dead nodes have graph role but no URL
        ]
        result = QueryResult(matches=matches, formats=[], extensions={})
        if m:
            m["qtime"].observe(time.perf_counter() - t0)
        return _cors(web.json_response(query_result_to_json(result)))

    async def telemetry_handler(request):
        if telemetry is not None:
            telemetry.append(await request.json())
        return _cors(web.Response(status=204))

    async def metrics(_request):
        if m:
            from prometheus_client import generate_latest

            return web.Response(body=generate_latest(m["registry"]))
        return web.Response(status=501)

    async def options(_request):
        return _cors(web.Response(status=204))

    async def shutdown(_app):
        pool.shutdown(wait=True)
        if telemetry is not None:
            telemetry.close()

    app = web.Application(client_max_size=2**26)
    app.router.add_get("/", frontend_init)
    app.router.add_post("/", query)
    app.router.add_post("/telemetry", telemetry_handler)
    app.router.add_get("/metrics", metrics)
    app.router.add_route("OPTIONS", "/", options)
    app.on_cleanup.append(shutdown)
    return app


def main(argv=None):
    """Config JSON: {index_dir, clip_server, port, beamwidth, search_list,
    spec, telemetry_path} (reference flags: query_disk_index.rs:31-54).
    With ``"clip_server": null`` the text and image terms are embedded in
    process by an engine on ``"device"`` ("cuda" by default; the keys of
    the clip server's config: "checkpoint", "tokenizer", "tiny_model")."""
    from aiohttp import web

    argv = argv if argv is not None else sys.argv[1:]
    with open(argv[0]) as f:
        config = json.load(f)

    index = DiskIndex(config["index_dir"])

    async def start():
        if config.get("clip_server"):
            from .client import RemoteEmbedder

            embedder = RemoteEmbedder(config["clip_server"])
        else:
            from .client import InProcessEmbedder
            from .clip_server import build_engine

            embedder = InProcessEmbedder(build_engine(config, tiny=bool(config.get("tiny_model"))))
        await embedder.connect()
        return make_app(
            index,
            embedder,
            telemetry_path=config.get("telemetry_path"),
            beamwidth=int(config.get("beamwidth", 3)),
            search_list=int(config.get("search_list", 1000)),
            # None (key absent) lets DiskIndex.search fall back to the
            # MSE_DISK_SPEC env knob; an explicit config value wins
            spec=int(config["spec"]) if "spec" in config else None,
        )

    loop = asyncio.new_event_loop()
    app = loop.run_until_complete(start())
    web.run_app(app, port=int(config.get("port", 1706)), loop=loop)


if __name__ == "__main__":
    main()
