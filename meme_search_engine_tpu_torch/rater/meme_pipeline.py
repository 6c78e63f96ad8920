"""Scorer pipeline: crawl -> embed -> score -> filter -> human queue.

Parity with meme-rater/meme_pipeline.py (+ library_processing_server.py,
load_from_json.py): newly crawled images are embedded, scored with the
ensemble median, thresholded, checked against the live library for
near-duplicates (dot > 0.99, meme_pipeline.py:81-88), and the survivors
land in a human filename-assignment queue served over HTTP.

Counterpart of ``meme_search_engine_tpu/rater/meme_pipeline.py``. The
scoring and the duplicate scan run on ``device`` ("cuda" unless the
caller asks for the CPU). The median over an even number of members is
the mean of the two middle scores, as ``jnp.median`` takes it
(``torch.median`` would return the lower one). The queue app's
download runs in a thread, so a slow image host does not hold the event
loop; ``aiohttp`` is imported where it is used.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.score_model import ScoreEnsemble, _as_tensor, ensemble_forward, on_device
from ..serving.engine import resolve_device

DUPLICATE_THRESHOLD = 0.99  # meme_pipeline.py:88


@dataclass
class Candidate:
    url: str
    embedding: np.ndarray
    score: float
    duplicate_of: Optional[str] = None


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over dim 0; an even count averages the two middle values."""
    s = x.sort(dim=0).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) * 0.5


def score_candidates(
    embeddings: np.ndarray, ensemble_params: ScoreEnsemble, channel: int = 0, *, device="cuda"
) -> np.ndarray:
    """Ensemble *median* per item (meme_pipeline.py scoring)."""
    params = on_device(ensemble_params, device)
    with torch.no_grad():
        out = ensemble_forward(params, embeddings)
        return _median(out[:, :, channel]).cpu().numpy()


def near_duplicates(
    candidates: np.ndarray,
    library: np.ndarray,
    threshold: float = DUPLICATE_THRESHOLD,
    *,
    device="cuda",
) -> np.ndarray:
    """(C,) best library dot per candidate >= threshold mask — one fp32
    product against the library (the reference queries the live search
    backend per item; with the matrix resident this is a single scan)."""
    if len(library) == 0:
        return np.zeros(len(candidates), bool)
    dev = resolve_device(device)
    with torch.no_grad():
        sims = torch.mm(_as_tensor(candidates, dev), _as_tensor(library, dev).T).max(dim=1).values
    return sims.cpu().numpy() >= threshold


def filter_candidates(
    urls: Sequence[str],
    embeddings: np.ndarray,
    ensemble_params: ScoreEnsemble,
    library_embeddings: np.ndarray,
    *,
    score_threshold: float,
    channel: int = 0,
    device="cuda",
) -> List[Candidate]:
    """Threshold + dedup; returns accepted candidates sorted by score."""
    scores = score_candidates(embeddings, ensemble_params, channel, device=device)
    dups = near_duplicates(embeddings, library_embeddings, device=device)
    out = [
        Candidate(url=u, embedding=e, score=float(s))
        for u, e, s, d in zip(urls, embeddings, scores, dups)
        if s >= score_threshold and not d
    ]
    return sorted(out, key=lambda c: -c.score)


def make_queue_app(queue_path: str, memes_dir: str):
    """Human filename-assignment UI (library_processing_server.py):
    GET / shows the next accepted candidate; POST /assign names + saves
    it into the library."""
    import asyncio
    import urllib.request

    from aiohttp import web

    def load_queue() -> List[dict]:
        if os.path.exists(queue_path):
            with open(queue_path) as f:
                return json.load(f)
        return []

    def save_queue(q: List[dict]):
        with open(queue_path, "w") as f:
            json.dump(q, f)

    async def index(_request):
        q = load_queue()
        if not q:
            return web.Response(text="queue empty")
        item = q[0]
        return web.Response(
            text=(
                "<!doctype html><body style='background:#111;color:#eee;"
                "text-align:center'>"
                f"<img src=\"{item['url']}\" style='max-height:70vh'>"
                f"<p>score {item['score']:.3f} — {len(q)} queued</p>"
                "<form method=post action=/assign>"
                "<input name=filename placeholder='filename.png' autofocus>"
                "<button>save</button></form>"
                "<form method=post action=/skip><button>skip</button></form>"
                "</body>"
            ),
            content_type="text/html",
        )

    async def assign(request):
        form = await request.post()
        q = load_queue()
        if q:
            item = q.pop(0)
            save_queue(q)
            dest = os.path.join(memes_dir, form["filename"])
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, urllib.request.urlretrieve, item["url"], dest
                )
            except Exception as e:  # noqa: BLE001
                return web.Response(text=f"download failed: {e}", status=502)
        raise web.HTTPFound("/")

    async def skip(_request):
        q = load_queue()
        if q:
            q.pop(0)
            save_queue(q)
        raise web.HTTPFound("/")

    app = web.Application()
    app.router.add_get("/", index)
    app.router.add_post("/assign", assign)
    app.router.add_post("/skip", skip)
    return app


def enqueue_candidates(queue_path: str, candidates: List[Candidate]):
    """Append accepted candidates to the assignment queue
    (load_from_json.py / copy_into_queue.py role)."""
    existing = []
    if os.path.exists(queue_path):
        with open(queue_path) as f:
            existing = json.load(f)
    seen = {e["url"] for e in existing}
    for c in candidates:
        if c.url not in seen:
            existing.append({"url": c.url, "score": c.score})
    with open(queue_path, "w") as f:
        json.dump(existing, f)
