"""Serve a synthetic corpus through the real query-server app.

Load-test scaffolding (reference: perf_test.py drives a live server with
random-embedding queries): builds an N x 1152 fp16 FlatIndex on the card
and serves it through the production `make_app` wire path — everything a
raw-embedding query touches (JSON parse, fusion, MIPS top-k, video
dedup, result marshalling) is the real serving code; only ingest is
bypassed.

Usage:
  python -m meme_search_engine_tpu_torch.tools.serve_synthetic \
      [--n 100000] [--port 1707] [--d 1152] [--device cuda|cpu]

Counterpart of ``meme_search_engine_tpu/tools/serve_synthetic.py`` over
the port's flat index and query server: the JAX tool's ``--cpu`` is
``--device`` here, ``cuda`` by default (no card raises). ``aiohttp`` is
imported where it is used.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses

import numpy as np


@dataclasses.dataclass
class _Cfg:
    embedding_size: int


class _RawOnlyEmbedder:
    """Embedder stub for raw-embedding-term load tests."""

    def __init__(self, d):
        self.config = _Cfg(embedding_size=d)

    def embed_image_bytes(self, blobs):  # pragma: no cover - not hit
        raise RuntimeError("synthetic server handles raw terms only")

    def embed_texts(self, texts):  # pragma: no cover - not hit
        raise RuntimeError("synthetic server handles raw terms only")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=1152)
    ap.add_argument("--port", type=int, default=1707)
    ap.add_argument(
        "--device",
        default="cuda",
        help="where the index lives: cuda (default) or cpu",
    )
    args = ap.parse_args(argv)

    from aiohttp import web

    from ..index.flat import FlatIndex, IndexHandle
    from ..ingest.filename import Actual
    from ..serving.query_server import make_app

    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((args.n, args.d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    index = FlatIndex.build(
        vecs.astype(np.float16), [Actual(f"synthetic/{i}.png") for i in range(args.n)],
        device=args.device,
    )
    handle = IndexHandle(index)
    # one search before serving (the allocator at this size)
    index.search(vecs[:1].astype(np.float32), 1000)

    app = make_app(handle, _RawOnlyEmbedder(args.d))
    # serve the SPA too (GET /ui) so a browser can drive the whole stack
    # — the real-browser smoke recipe in tests/test_frontend.py uses this
    from ..serving.frontend import attach_frontend

    attach_frontend(app)
    print(f"serving {args.n} synthetic vectors on :{args.port}", flush=True)
    web.run_app(app, port=args.port, loop=asyncio.new_event_loop())


if __name__ == "__main__":
    main()
