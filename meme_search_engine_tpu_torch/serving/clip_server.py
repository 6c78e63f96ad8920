"""Embedding service: HTTP + msgpack, wire-compatible with the reference.

Counterpart of ``meme_search_engine_tpu/serving/clip_server.py``, same API:
  POST /        msgpack {"images": [bytes...]} | {"text": [str...]}
                -> 200 msgpack [fp16-LE bytes, ...] | 500 msgpack "err"
  GET  /config  msgpack {model, batch, image_size, embedding_size}
  GET  /        204 (health)
  GET  /metrics Prometheus text

Pipeline: asyncio handlers -> host decode pool (PIL) for images -> one
inference worker thread that owns the device -> response. Texts are
tokenised and embedded by the engine on that worker thread.

Run: ``python -m meme_search_engine_tpu_torch.serving.clip_server config.json``
Config keys: port, device ("cuda" by default, or "cpu"), max_batch_size,
model_name ("tiny..." serves the tiny test geometry; "siglip2-so400m/16-naflex"
SigLIP 2 SO400M/16 NaFlex, its sequence cap the ``max_num_patches`` key,
1024 by default), checkpoint (optional HF ``model.safetensors`` or its
directory), tokenizer (optional HF ``tokenizer.json``; without it the
hash tokenizer), decode_threads, warmup. Without a checkpoint the weights
are random-init from seed 0, as in the reference. A NaFlex engine's
decode pool resizes each picture to its own grid
(``preprocess.decode_and_resize_naflex``) and the worker hands the list
to ``EmbeddingEngine.embed_image_list``; ``/config`` then reports
``patch_size`` and ``max_num_patches``, and ``image_size`` null: there is
no one size to resize to (``wire.InferenceServerConfig``).

``msgpack``, ``aiohttp``, ``PIL`` and ``prometheus_client`` are imported
where they are used, so the engine and :class:`InferenceWorker` import
without them.
"""

from __future__ import annotations

import asyncio
import json
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from ..utils.fp16 import encode_fp16_buffer
from .preprocess import decode_and_resize, decode_and_resize_naflex
from .wire import InferenceServerConfig

__all__ = ["InferenceWorker", "make_app", "main"]

_metrics_lock = threading.Lock()
_metrics = None


def _prometheus():
    """The service's metrics in a registry of their own (None without
    prometheus_client)."""
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
                "items": Counter(
                    "modelserver_total_items", "Items run through model server",
                    ["model", "modality"], registry=reg,
                ),
                "batches": Counter(
                    "modelserver_batchcount", "Inference batches run", ["model"],
                    registry=reg,
                ),
                "inftime": Histogram(
                    "modelserver_inftime", "Time running inference",
                    ["model", "batch_size"], registry=reg,
                ),
            }
        return _metrics or None


class InferenceWorker:
    """Single thread owning device inference, fed by a bounded queue."""

    def __init__(self, engine, model_name: str = "siglip", qsize: int = 10):
        self.engine = engine
        self.model_name = model_name
        self._q: "queue.Queue" = queue.Queue(qsize)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        m = _prometheus()
        while True:
            item = self._q.get()
            if item is None:
                return
            kind, payload, callback = item
            try:
                t0 = time.perf_counter()
                if kind == "image" and self.engine.cfg.max_num_patches:
                    out = self.engine.embed_image_list(payload)
                elif kind == "image":
                    out = self.engine.embed_image_arrays(payload)
                else:
                    out = self.engine.embed_texts(payload)
                if m:
                    m["items"].labels(self.model_name, kind).inc(len(payload))
                    m["batches"].labels(self.model_name).inc()
                    m["inftime"].labels(self.model_name, len(payload)).observe(
                        time.perf_counter() - t0
                    )
                callback(True, out)
            except Exception as e:  # noqa: BLE001 — report to client
                callback(False, str(e))

    def submit(self, kind, payload, callback):
        self._q.put((kind, payload, callback))

    def stop(self, timeout: Optional[float] = None):
        self._q.put(None)
        self._thread.join(timeout)


def make_app(engine, config: dict):
    """Build the aiohttp application around an EmbeddingEngine."""
    import msgpack
    from aiohttp import web

    max_batch = int(config.get("max_batch_size", 128))
    model_name = config.get("model_name", "siglip-so400m/14@384")
    cfg = engine.cfg
    if cfg.max_num_patches:
        server = InferenceServerConfig(max_batch, None, cfg.d_emb, model_name,
                                       patch_size=cfg.patch_size,
                                       max_num_patches=cfg.max_num_patches)
        decode = lambda img: decode_and_resize_naflex(img, cfg.patch_size, cfg.max_num_patches)  # noqa: E731
    else:
        image_size = (cfg.image_size, cfg.image_size)
        server = InferenceServerConfig(max_batch, image_size, cfg.d_emb, model_name)
        decode = lambda img: decode_and_resize(img, image_size)  # noqa: E731
    decode_pool = ThreadPoolExecutor(max_workers=int(config.get("decode_threads", 8)))
    worker = InferenceWorker(engine, model_name)

    async def run_inference(request):
        loop = asyncio.get_running_loop()
        body = msgpack.unpackb(await request.read(), raw=False)
        texts: Optional[List[str]] = body.get("text")
        images: Optional[List[bytes]] = body.get("images")

        try:
            if images:
                if len(images) > max_batch:
                    raise ValueError(f"max batch size is {max_batch}")
                arrays = await asyncio.gather(
                    *[loop.run_in_executor(decode_pool, decode, img) for img in images]
                )
                payload = list(arrays) if cfg.max_num_patches else np.stack(arrays)
                kind = "image"
            elif texts:
                if len(texts) > max_batch:
                    raise ValueError(f"max batch size is {max_batch}")
                payload, kind = list(texts), "text"
            else:
                raise ValueError("images or text required")
        except Exception as e:  # noqa: BLE001
            return web.Response(
                body=msgpack.packb(str(e)), status=500,
                content_type="application/msgpack",
            )

        event = asyncio.Event()
        result = {}

        def callback(ok, value):
            result["ok"], result["value"] = ok, value
            loop.call_soon_threadsafe(event.set)

        worker.submit(kind, payload, callback)
        await event.wait()

        if result["ok"]:
            body_data = [encode_fp16_buffer(v) for v in result["value"]]
            return web.Response(
                body=msgpack.packb(body_data), status=200,
                content_type="application/msgpack",
            )
        return web.Response(
            body=msgpack.packb(result["value"]), status=500,
            content_type="application/msgpack",
        )

    async def config_handler(_request):
        return web.Response(
            body=msgpack.packb(server.to_msgpack_dict()),
            status=200,
            content_type="application/msgpack",
        )

    async def health(_request):
        return web.Response(status=204)

    async def metrics(_request):
        m = _prometheus()
        if m:
            from prometheus_client import generate_latest

            return web.Response(body=generate_latest(m["registry"]))
        return web.Response(status=501)

    async def on_cleanup(_app):
        worker.stop()
        decode_pool.shutdown(wait=False)

    app = web.Application(client_max_size=2**26)
    app.router.add_post("/", run_inference)
    app.router.add_get("/config", config_handler)
    app.router.add_get("/", health)
    app.router.add_get("/metrics", metrics)
    app.on_cleanup.append(on_cleanup)
    app["worker"] = worker
    return app


def build_engine(config: dict, tiny: Optional[bool] = None):
    """Engine from a service config: the checkpoint's weights, or
    random-init weights from seed 0. ``tiny`` selects the tiny test
    geometry; by default a ``model_name`` starting with "tiny" does. A
    ``model_name`` starting with "siglip2" and holding "naflex" selects
    SigLIP 2 SO400M/16 NaFlex at the config's ``max_num_patches`` (1024 by
    default; the tiny NaFlex geometry, 64, where ``tiny`` is set too)."""
    import dataclasses

    import torch

    from ..models import siglip
    from .engine import EmbeddingEngine, resolve_device

    device = resolve_device(config.get("device", "cuda"))
    name = config.get("model_name", "")
    if tiny is None:
        tiny = name.startswith("tiny")
    naflex = name.startswith(("siglip2", "tiny-siglip2")) and "naflex" in name
    if naflex:
        base = siglip.tiny_naflex_test_config() if tiny else siglip.SO400M_16_NAFLEX_1024
        cfg = dataclasses.replace(
            base, max_num_patches=int(config.get("max_num_patches", base.max_num_patches)))
    elif tiny:
        cfg = siglip.tiny_test_config()
    else:
        cfg = siglip.SO400M_14_384
    ckpt = config.get("checkpoint")
    if ckpt:
        params = (siglip.load_hf_siglip2 if naflex else siglip.load_hf_siglip)(ckpt, cfg)
    else:
        print("WARNING: no checkpoint configured; serving random-init weights", file=sys.stderr)
        gen = torch.Generator(device=device).manual_seed(0)
        params = siglip.init_params(cfg, gen, device)
    return EmbeddingEngine(
        params, cfg, max_batch=int(config.get("max_batch_size", 128)), device=device,
        tokenizer_path=config.get("tokenizer"),
    )


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    with open(argv[0]) as f:
        config = json.load(f)
    engine = build_engine(config)
    if config.get("warmup", True):
        engine.warmup()

    from aiohttp import web

    app = make_app(engine, config)
    print("Ready")
    web.run_app(app, port=int(config.get("port", 1708)))


if __name__ == "__main__":
    main()
