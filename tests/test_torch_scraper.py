"""Port parity for the scraper (``pipeline/scraper.py``), against the JAX
package's.

- tests/test_scraper.py's four cases (URL triage and rewrites, the
  HTML-extraction hosts, the NDJSON reader), run over both packages.
- The port's reader on zstd frames of stored blocks (written without
  ``zstandard``) gives what it gives on the compressed file.
- ``scrape()`` against a local aiohttp image host, each package with its
  in-process embedder over the tiny test config's weights (the JAX
  ``init_params`` from seed 0, carried across through numpy): the dumps
  hold the same entries, and the embeddings agree at cos >= 0.999 (the
  engines' own tolerance, tests/test_torch_serving.py).
- Every embedding batch reaches the dump when the embedder is slow.

The reference's triage rewrites ``http://`` to ``https://``; the local
host speaks plain HTTP, so the submissions spell the scheme ``HTTP://``,
which triage leaves alone and aiohttp reads as http.
"""

import asyncio
import io
import json

import jax
import numpy as np
import pytest
import zstandard

from meme_search_engine_tpu.models import siglip as js
from meme_search_engine_tpu.pipeline import dump as jdump
from meme_search_engine_tpu.pipeline import scraper as jscraper
from meme_search_engine_tpu.serving.client import InProcessEmbedder as JaxInProcessEmbedder
from meme_search_engine_tpu.serving.engine import EmbeddingEngine as JaxEngine
from meme_search_engine_tpu_torch.models import convert
from meme_search_engine_tpu_torch.models import siglip as ts
from meme_search_engine_tpu_torch.pipeline import dump as tdump
from meme_search_engine_tpu_torch.pipeline import scraper as tscraper
from meme_search_engine_tpu_torch.serving.client import InProcessEmbedder
from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine

BOTH = pytest.mark.parametrize("pkg", [jscraper, tscraper], ids=["jax", "torch"])


@BOTH
def test_triage_rejects_non_images(pkg):
    assert pkg.triage_url("https://www.reddit.com/r/foo/comments/x") is None
    assert pkg.triage_url("https://example.com/page.html") is None
    assert pkg.triage_url("https://vimeo.com/12345") is None
    assert pkg.triage_url("https://i.imgur.com/abc.gifv") is None
    assert pkg.triage_url("https://example.com/nothing-here") is None


@BOTH
def test_triage_accepts_and_rewrites(pkg):
    assert pkg.triage_url("http://i.example.com/a.jpg") == "https://i.example.com/a.jpg"
    assert pkg.triage_url("https://imgur.com/aBcD123") == "https://i.imgur.com/aBcD123.jpg"
    out = pkg.triage_url("https://youtu.be/dQw4w9WgXcQ")
    assert out == "https://i.ytimg.com/vi/dQw4w9WgXcQ/maxresdefault.jpg"
    assert "&amp;" not in pkg.triage_url("https://cdn.example.com/a.png?x=1&amp;y=2")


@BOTH
def test_html_extraction_hosts(pkg):
    assert pkg.needs_html_extraction("https://imgur.com/a/abc123") is not None
    assert pkg.needs_html_extraction("https://imgur.com/gallery/abc") is not None
    assert pkg.needs_html_extraction("https://i.imgur.com/abc.jpg") is None


ROWS = [
    {"url": "https://i.example.com/a.jpg", "title": "x", "author": "u",
     "subreddit": "memes", "id": "1", "created_utc": 100, "over_18": False},
    {"url": "https://i.example.com/b.jpg", "title": "y", "author": "[deleted]",
     "subreddit": "memes", "id": "2", "created_utc": "101", "over_18": False},
    {"url": "https://i.example.com/c.jpg", "title": "z", "author": "v",
     "subreddit": "memes", "id": "3", "created_utc": 102.5, "over_18": True},
    {"url": "https://i.example.com/d.jpg", "title": "w", "author": "t",
     "subreddit": None, "id": "4", "created_utc": "103"},
]


def _ndjson(rows):
    return "\n".join(json.dumps(r) for r in rows).encode()


@BOTH
def test_iter_reddit_dump(pkg, tmp_path):
    path = tmp_path / "sub.zst"
    path.write_bytes(zstandard.ZstdCompressor().compress(_ndjson(ROWS)))
    entries = list(pkg.iter_reddit_dump(str(path)))
    ids = [e["id"] for e in entries]
    assert "1" in ids and "4" in ids
    assert "2" not in ids  # deleted author
    assert "3" not in ids  # over_18
    e4 = next(e for e in entries if e["id"] == "4")
    assert e4["timestamp"] == 103 and e4["subreddit"] == ""


def test_iter_reddit_dump_reads_stored_frames(tmp_path):
    """Stored blocks over a block boundary, an ignored line and a broken
    one: the same entries as the JAX reader on the compressed file."""
    rows = ROWS + [{"url": f"https://i.example.com/{i}.png", "title": "é" * (i % 50), "author": "a",
                    "subreddit": "s", "id": f"n{i}", "created_utc": 200 + i} for i in range(3000)]
    raw = _ndjson(rows) + b'\n{"broken": \n\n'
    packed = tmp_path / "packed.zst"
    packed.write_bytes(zstandard.ZstdCompressor().compress(raw))
    stored = tmp_path / "stored.zst"
    with open(stored, "wb") as f:
        w = tdump._StoredFrameWriter(f)
        w.write(raw)
        w.close()
    assert len(raw) > 1 << 17  # more than one block
    want = list(jscraper.iter_reddit_dump(str(packed)))
    assert list(tscraper.iter_reddit_dump(str(stored))) == want
    assert list(tscraper.iter_reddit_dump(str(packed))) == want
    assert len(want) == 3002


def _images(n, size):
    from PIL import Image

    rng = np.random.default_rng(0)
    out = {}
    for j in range(n):
        h, w = (40, 50) if j % 5 == 0 else (size, size)
        buf = io.BytesIO()
        fmt, mime, ext = ("PNG", "image/png", "png") if j % 2 else ("JPEG", "image/jpeg", "jpg")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format=fmt)
        out[f"{j:03d}.{ext}"] = (buf.getvalue(), mime)
    return out


def _submissions(base, names, path):
    rows = [{"url": f"{base}/img/{name}", "title": f"t{j}", "author": f"a{j % 3}",
             "subreddit": "memes", "id": f"s{j}", "created_utc": 1000 + j}
            for j, name in enumerate(names)]
    rows += [
        {"url": f"{base}/page.html", "title": "p", "author": "a", "subreddit": "memes", "id": "r0",
         "created_utc": 5},
        {"url": f"{base}/nothing-here", "title": "p", "author": "a", "subreddit": "memes", "id": "r1",
         "created_utc": 6},
        {"url": f"{base}/img/missing.png", "title": "m", "author": "a", "subreddit": "memes",
         "id": "r2", "created_utc": 7},
        {"url": f"{base}/img/{names[0]}", "title": "n", "author": "a", "subreddit": "memes",
         "id": "r3", "created_utc": 8, "over_18": True},
    ]
    path.write_bytes(zstandard.ZstdCompressor().compress(_ndjson(rows)))


async def _with_image_host(blobs, body):
    from aiohttp import web
    from aiohttp.test_utils import TestServer

    async def serve(request):
        blob = blobs.get(request.match_info["name"])
        if blob is None:
            raise web.HTTPNotFound()
        return web.Response(body=blob[0], content_type=blob[1])

    app = web.Application()
    app.router.add_get("/img/{name}", serve)
    server = TestServer(app, host="127.0.0.1")
    await server.start_server()
    try:
        return await body(f"HTTP://127.0.0.1:{server.port}")
    finally:
        await server.close()


def _entries(pkg_dump, path):
    return {e.id: e for e in pkg_dump.read_dump(path)}


def test_scrape_matches_jax_scraper(tmp_path):
    jcfg = js.tiny_test_config()
    params = js.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    jembed = JaxInProcessEmbedder(JaxEngine(params, jcfg, max_batch=8))
    tcfg = ts.tiny_test_config()
    tembed = InProcessEmbedder(EmbeddingEngine(convert.tree_from_numpy(tree), tcfg, max_batch=8,
                                               device="cpu"))
    blobs = _images(20, jcfg.image_size)
    sub = tmp_path / "RS.zst"

    async def body(base):
        _submissions(base, sorted(blobs), sub)
        counts = []
        for pkg, embedder, tag in ((jscraper, jembed, "jax"), (tscraper, tembed, "torch")):
            cfg = pkg.ScraperConfig(input_files=[str(sub)], output_dir=str(tmp_path / tag),
                                    max_fetch_concurrency=4)
            counts.append(await pkg.scrape(cfg, embedder))
        return counts

    assert asyncio.run(_with_image_host(blobs, body)) == [20, 20]
    want = _entries(jdump, str(tmp_path / "jax" / "000000001.dump.zst"))
    got = _entries(tdump, str(tmp_path / "torch" / "000000001.dump.zst"))
    assert set(got) == set(want) == {f"s{j}" for j in range(20)}
    for key, w in want.items():
        g = got[key]
        assert (g.url, g.title, g.subreddit, g.author, g.timestamp) == (
            w.url, w.title, w.subreddit, w.author, w.timestamp)
        assert (g.metadata.mime_type, g.metadata.original_file_size, g.metadata.dimension) == (
            w.metadata.mime_type, w.metadata.original_file_size, w.metadata.dimension)
        assert g.metadata.final_url == w.metadata.final_url
        cos = float(g.embedding @ w.embedding / np.linalg.norm(g.embedding) / np.linalg.norm(w.embedding))
        assert cos >= 0.999, (key, cos)
    # both read each other's dumps
    assert set(_entries(tdump, str(tmp_path / "jax" / "000000001.dump.zst"))) == set(want)
    assert set(_entries(jdump, str(tmp_path / "torch" / "000000001.dump.zst"))) == set(want)


class _SlowEmbedder:
    """An embedder that answers each batch after a wait, as a remote one does."""

    def __init__(self):
        from meme_search_engine_tpu_torch.serving.wire import InferenceServerConfig

        self.config = InferenceServerConfig(batch=4, image_size=(8, 8), embedding_size=8, model="slow")
        self.calls = 0

    async def embed_image_bytes(self, blobs):
        self.calls += 1
        await asyncio.sleep(0.05)
        return np.ones((len(blobs), 8), np.float32)


def test_scrape_writes_every_batch_of_a_slow_embedder(tmp_path):
    """Batches still waiting on the embedder when the fetches end are
    awaited before the dump closes (the JAX scraper's fire-and-forget
    batches may be lost there); 16 images in batches of 4."""
    blobs = _images(16, 8)
    sub = tmp_path / "RS.zst"
    embedder = _SlowEmbedder()

    async def body(base):
        _submissions(base, sorted(blobs), sub)
        cfg = tscraper.ScraperConfig(input_files=[str(sub)], output_dir=str(tmp_path / "out"))
        return await tscraper.scrape(cfg, embedder)

    assert asyncio.run(_with_image_host(blobs, body)) == 16
    assert embedder.calls == 4
    assert len(_entries(tdump, str(tmp_path / "out" / "000000001.dump.zst"))) == 16
