"""Pair-rating web UI (reference: meme-rater/rater_server.py).

Side-by-side comparison webapp over three axes (useful/meme/aesthetic)
with the reference's keyboard layout — QWERT / ASDFG / ZXCVB rows map to
the five ratings 1+ / 1 / eq / 2 / 2+ per axis (rater_server.py:91-107).
Pairs come from the active-learning queue (RatingsDB.queue).

Run: python -m meme_search_engine_tpu_torch.rater.server config.json
Config: {"db_path", "images_dir", "port"}.

A copy of ``meme_search_engine_tpu/rater/server.py``, which the port
keeps rather than imports; ``aiohttp`` is imported where it is used.
"""

from __future__ import annotations

import json
import os
import sys

from .data import RATING_PROBS, RatingsDB

_PAGE = """<!doctype html>
<html><head><title>meme rater</title><style>
body {{ font-family: sans-serif; background: #111; color: #eee; text-align: center; }}
.pair img {{ max-width: 45vw; max-height: 70vh; margin: 0.5em; }}
table {{ margin: auto; border-collapse: collapse; }}
td, th {{ border: 1px solid #444; padding: 0.2em 0.6em; }}
</style></head><body>
<h2>Which is better?</h2>
<div class="pair">
  <img src="/image/{m1}" id="m1"><img src="/image/{m2}" id="m2">
</div>
<table><tr><th>axis</th><th>1 much better</th><th>1 better</th><th>equal</th>
<th>2 better</th><th>2 much better</th></tr>
<tr><td>useful</td><td>Q</td><td>W</td><td>E</td><td>R</td><td>T</td></tr>
<tr><td>meme</td><td>A</td><td>S</td><td>D</td><td>F</td><td>G</td></tr>
<tr><td>aesthetic</td><td>Z</td><td>X</td><td>C</td><td>V</td><td>B</td></tr>
</table>
<p>ratings this session: <span id="count">0</span></p>
<script>
const keymap = {{}};
const axes = ["useful", "meme", "aesthetic"];
const rows = ["qwert", "asdfg", "zxcvb"];
const ratings = ["1+", "1", "eq", "2", "2+"];
rows.forEach((row, ai) => [...row].forEach((ch, ri) =>
  keymap[ch] = [axes[ai], ratings[ri]]));
let count = 0;
document.addEventListener("keydown", async (ev) => {{
  const m = keymap[ev.key.toLowerCase()];
  if (!m) return;
  await fetch("/rate", {{method: "POST", headers: {{"Content-Type": "application/json"}},
    body: JSON.stringify({{m1: "{m1}", m2: "{m2}", axis: m[0], rating: m[1]}})}});
  count += 1; document.getElementById("count").textContent = count;
  location.reload();
}});
</script></body></html>"""


def make_app(db: RatingsDB, images_dir: str):
    from aiohttp import web

    async def index(_request):
        pair = db.pop_queue()
        if pair is None:
            import random

            files = list(db.embeddings().keys())
            if len(files) < 2:
                return web.Response(text="no files to rate", status=503)
            pair = tuple(random.sample(files, 2))
        return web.Response(
            text=_PAGE.format(m1=pair[0], m2=pair[1]),
            content_type="text/html",
        )

    async def image(request):
        name = request.match_info["name"]
        path = os.path.join(images_dir, name)
        if not os.path.isfile(path):
            return web.Response(status=404)
        return web.FileResponse(path)

    async def rate(request):
        body = await request.json()
        if body["rating"] not in RATING_PROBS:
            return web.Response(status=400)
        db.add_rating(body["m1"], body["m2"], body["rating"], body["axis"])
        return web.json_response({"ok": True})

    app = web.Application()
    app.router.add_get("/", index)
    app.router.add_get("/image/{name:.*}", image)
    app.router.add_post("/rate", rate)
    return app


def main(argv=None):
    from aiohttp import web

    argv = argv if argv is not None else sys.argv[1:]
    with open(argv[0]) as f:
        config = json.load(f)
    db = RatingsDB(config["db_path"])
    app = make_app(db, config["images_dir"])
    web.run_app(app, port=int(config.get("port", 1709)))


if __name__ == "__main__":
    main()
