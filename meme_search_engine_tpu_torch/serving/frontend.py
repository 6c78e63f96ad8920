"""Static frontend serving.

The reference deploys clipfront2 behind nginx with /memes /thumbs
/backend proxies (docker/config/nginx.conf); for single-process
deployments this attaches the built-in frontend (frontend/index.html)
plus the media/thumbnail directories directly to the backend app:

  GET /ui                 the app (config injected inline)
  GET /memes/...          original media (optional)
  GET /thumbs/...         thumbnails (optional)

A copy of ``meme_search_engine_tpu/serving/frontend.py``, which the port keeps rather
than imports.
"""

from __future__ import annotations

import json
import os
from typing import Optional

FRONTEND_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "frontend",
)


def attach_frontend(
    app,
    *,
    backend_url: str = "",
    image_path: str = "/memes/",
    thumb_path: str = "/thumbs/",
    memes_dir: Optional[str] = None,
    thumbs_dir: Optional[str] = None,
    friendly_terms: Optional[list] = None,
    telemetry: bool = True,
):
    from aiohttp import web

    config = {
        "backend": backend_url,
        "image_path": image_path,
        "thumb_path": thumb_path,
        "friendly_mode_default_terms": friendly_terms or [],
        "telemetry": telemetry,
    }

    async def ui(_request):
        with open(os.path.join(FRONTEND_DIR, "index.html")) as f:
            html = f.read()
        inject = (
            f"<script>window.FRONTEND_CONFIG = {json.dumps(config)};</script>"
        )
        html = html.replace("<script>", inject + "\n<script>", 1)
        return web.Response(text=html, content_type="text/html")

    app.router.add_get("/ui", ui)
    if memes_dir:
        app.router.add_static("/memes/", memes_dir)
    if thumbs_dir:
        app.router.add_static("/thumbs/", thumbs_dir)
    return app
