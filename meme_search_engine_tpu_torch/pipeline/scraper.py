"""Reddit-dump scraper (reference: src/reddit_dump.rs).

Reads zstd NDJSON Reddit submission dumps, filters/rewrites media URLs
(imgur/youtube thumbnail extraction included), fetches images with high
concurrency, embeds them through the embedding service in batches, and
writes ProcessedEntry dump files — resuming from the newest timestamp in
the highest-sequence-numbered existing output (reddit_dump.rs:269-355).

Concurrency model parity (reddit_dump.rs:379-489): bounded fetch
fan-out (512 in the reference), CPU-count decoders, 3 embedding batches
in flight — here as asyncio semaphores + executor pools. Network access
is required for fetching; the URL filtering/rewriting layer and the
NDJSON reader are pure and unit-testable offline.

Counterpart of ``meme_search_engine_tpu/pipeline/scraper.py``, a copy over
the port's ``serving/client.RemoteEmbedder`` and ``pipeline/dump``, with
three differences:

- ``iter_reddit_dump`` also reads zstd frames of stored blocks without the
  ``zstandard`` package (``pipeline/dump.py``'s reader); a compressed dump
  still needs it.
- ``scrape`` keeps every embedding batch it starts and awaits them all
  before it closes the dump. The JAX function starts them with
  ``ensure_future``, keeps no reference and closes the dump after the
  last one only, so a batch still waiting on a remote embedder when the
  fetches end is lost (or written after the close).
- The counters are registered at first use, and the fetch timeout is an
  ``aiohttp.ClientTimeout``.

``aiohttp``, ``msgpack``, ``zstandard`` and ``prometheus_client`` are
imported where they are used.
"""

from __future__ import annotations

import asyncio
import io
import json
import os
import re
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Set, Tuple

import numpy as np

from .dump import (
    DumpWriter,
    OriginalImageMetadata,
    ProcessedEntry,
    _stored_frames,
    latest_timestamp,
)

_COUNTERS = {
    "fetched": ("mse_scrape_images_fetched", "images fetched"),
    "processed": ("mse_scrape_images_processed", "images processed"),
    "entries": ("mse_scrape_entries_processed", "entries processed"),
    "failed": ("mse_scrape_images_failed", "images failed"),
    "discarded": ("mse_scrape_discarded", "images discarded by hash"),
}
_counters: dict = {}


def _count(key: str) -> None:
    """Add one to a scrape counter in prometheus_client's default registry,
    where any exporter of the process reads it (nothing without
    prometheus_client). A process that also imports the JAX scraper has
    the same names registered already, and shares its counters."""
    if key not in _counters:
        try:
            from prometheus_client import REGISTRY, Counter
        except ImportError:
            _counters[key] = None
        else:
            name, doc = _COUNTERS[key]
            _counters[key] = REGISTRY._names_to_collectors.get(name) or Counter(name, doc)
    if _counters[key] is not None:
        _counters[key].inc()


# URL triage (reddit_dump.rs:58-124 behaviour: drop obvious non-images,
# require an image-ish signal, rewrite indirect hosts to direct files)
_IGNORE = re.compile(
    r"(//(www\.)?reddit\.com/[^g])|(\.html?)|(\.php)|(\?articleid=)"
    r"|(\.aspx?)|(\.xml)|(/rss/)|(//vimeo\.com)|(//v\.redd\.it)"
    r"|(\.gifv$)|(youtube\.com/user/)"
)
_MUST_CONTAIN = re.compile(
    r"jpe?g|png|webp|\.gif|=gif|bmp|tiff|avif|imgur|image|//i\.|img"
    r"|cdn\.|media\.|/i/|/media|youtu\.be|youtube\.com|reddit\.com/gallery/",
    re.IGNORECASE,
)
_REWRITES: List[Tuple[re.Pattern, str]] = [
    (re.compile(r"imgur\.com/([A-Za-z0-9]+),"), r"imgur.com/\1"),
    (re.compile(r"//(?:www\.|m\.)?imgur\.com/([A-Za-z0-9]+)$"), r"//i.imgur.com/\1.jpg"),
    (re.compile(r"^http://"), "https://"),
    (re.compile(r"//youtu\.be/(.*)"), r"//youtube.com/watch?v=\1"),
    (re.compile(r"//[a-z]+\.youtube\.com/(.*)"), r"//youtube.com/\1"),
    (
        re.compile(r"//youtube\.com/embed/([A-Za-z0-9_-]+)"),
        r"//i.ytimg.com/vi/\1/maxresdefault.jpg",
    ),
    (
        re.compile(r"//youtube\.com/(?:.*)v=([A-Za-z0-9_-]+)(?:.*)"),
        r"//i.ytimg.com/vi/\1/maxresdefault.jpg",
    ),
    (re.compile(r"&amp;"), "&"),
]
# hosts whose pages need HTML meta extraction to find the real image
_HTML_EXTRACT = [
    (
        re.compile(r"//imgur\.com/(a|gallery)/[A-Za-z0-9]+"),
        re.compile(r'<meta name="twitter:image"[^>]*content="([^"]+)"'),
    ),
]
ACCEPTABLE_MIME: Set[str] = {
    "image/png",
    "image/webp",
    "image/avif",
    "image/jpeg",
    "image/gif",
    "image/apng",
    "image/bmp",
    "image/tiff",
}


def triage_url(url: str) -> Optional[str]:
    """Filter + rewrite a submission URL; None = skip."""
    if _IGNORE.search(url):
        return None
    if not _MUST_CONTAIN.search(url):
        return None
    for pattern, repl in _REWRITES:
        url = pattern.sub(repl, url)
    return url


def needs_html_extraction(url: str):
    for pattern, meta_re in _HTML_EXTRACT:
        if pattern.search(url):
            return meta_re
    return None


class _BlockReader(io.RawIOBase):
    """A raw stream over an iterator of byte blocks."""

    def __init__(self, blocks):
        self._blocks = blocks
        self._buf = memoryview(b"")

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        while not self._buf:
            block = next(self._blocks, None)
            if block is None:
                return 0
            self._buf = memoryview(block)
        n = min(len(b), len(self._buf))
        b[:n] = self._buf[:n]
        self._buf = self._buf[n:]
        return n


def iter_reddit_dump(path: str) -> Iterator[dict]:
    """zstd NDJSON submissions -> parsed entries worth fetching
    (reddit_dump.rs:137-181 process_file)."""
    with open(path, "rb") as f:
        stored = _stored_frames(f)
        if stored is None:
            import zstandard

            f.seek(0)
            reader = zstandard.ZstdDecompressor(max_window_size=2**31).stream_reader(f)
        else:
            reader = io.BufferedReader(_BlockReader(stored))
        text = io.TextIOWrapper(reader, encoding="utf-8", errors="replace")
        for line in text:
            line = line.strip()
            if not line or "\x00" in line:
                continue
            # cheap pre-filters before JSON parse (OBJECT_HACKY_IGNORE)
            if '"author":"[deleted]"' in line or '"promoted":true' in line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if obj.get("over_18"):
                continue
            if obj.get("author") == "[deleted]" or obj.get("promoted"):
                continue
            url = obj.get("url")
            if not url:
                continue
            ts = obj.get("created_utc", 0)
            try:
                ts = int(float(ts))
            except (TypeError, ValueError):
                continue
            yield {
                "url": url,
                "title": obj.get("title", ""),
                "author": obj.get("author") or "",
                "subreddit": obj.get("subreddit") or "",
                "id": obj.get("id", ""),
                "timestamp": ts,
            }


@dataclass
class ScraperConfig:
    """reddit_dump.rs:324-334 hardcodes this struct in source; we take
    JSON."""

    input_files: List[str] = field(default_factory=list)
    output_dir: str = "dumps"
    clip_server: str = "http://localhost:1708"
    max_fetch_concurrency: int = 512
    embed_batches_in_flight: int = 3
    max_file_size: int = 16 * 1024 * 1024
    discard_hashes: Set[int] = field(default_factory=set)
    seq_start: int = 1
    timeout_s: float = 30.0


async def fetch_image(
    session, url: str, cfg: ScraperConfig
) -> Optional[Tuple[bytes, str, str]]:
    """-> (bytes, mime, final_url); follows one HTML-extraction hop for
    gallery hosts (reddit_dump.rs:197-250 fetch_file)."""
    import aiohttp

    meta_re = needs_html_extraction(url)
    timeout = aiohttp.ClientTimeout(total=cfg.timeout_s)
    try:
        if meta_re is not None:
            async with session.get(url, timeout=timeout) as resp:
                html = await resp.text()
            m = meta_re.search(html)
            if not m:
                return None
            url = m.group(1)
        async with session.get(url, timeout=timeout) as resp:
            if resp.status != 200:
                return None
            mime = resp.headers.get("Content-Type", "").split(";")[0]
            if mime and mime not in ACCEPTABLE_MIME:
                return None
            data = await resp.content.read(cfg.max_file_size + 1)
            if len(data) > cfg.max_file_size:
                return None
            return data, mime, str(resp.url)
    except Exception:  # noqa: BLE001 — fetch failures are counted, not fatal
        return None


async def scrape(cfg: ScraperConfig, embedder=None) -> int:
    """Run the scrape; returns the number of entries written.

    ``embedder`` defaults to a RemoteEmbedder on cfg.clip_server.
    """
    import aiohttp

    from ..serving.client import RemoteEmbedder
    from ..tools.content_hash import content_hash

    os.makedirs(cfg.output_dir, exist_ok=True)
    resume_ts = latest_timestamp(cfg.output_dir) or 0
    if resume_ts:
        print(f"resuming after timestamp {resume_ts}")

    own_embedder = embedder is None
    if own_embedder:
        embedder = RemoteEmbedder(cfg.clip_server)
        await embedder.connect()

    out_path = os.path.join(
        cfg.output_dir, f"{cfg.seq_start:09d}.dump.zst"
    )
    writer = DumpWriter(out_path)
    written = 0
    fetch_sem = asyncio.Semaphore(cfg.max_fetch_concurrency)
    embed_sem = asyncio.Semaphore(cfg.embed_batches_in_flight)
    batch: List[Tuple[dict, bytes, str, str]] = []
    batch_lock = asyncio.Lock()
    write_lock = asyncio.Lock()

    async def flush(items):
        nonlocal written
        async with embed_sem:
            try:
                embs = await embedder.embed_image_bytes(
                    [b for _e, b, _m, _u in items]
                )
            except Exception as e:  # noqa: BLE001
                print(f"embed batch failed: {e}")
                return
            async with write_lock:
                for (entry, data, mime, final_url), emb in zip(items, embs):
                    writer.write(
                        ProcessedEntry(
                            url=entry["url"],
                            id=entry["id"],
                            title=entry["title"],
                            subreddit=entry["subreddit"],
                            author=entry["author"],
                            timestamp=entry["timestamp"],
                            embedding=np.asarray(emb, np.float32),
                            metadata=OriginalImageMetadata(
                                mime_type=mime,
                                original_file_size=len(data),
                                dimension=(0, 0),
                                final_url=final_url,
                            ),
                        )
                    )
                    written += 1
                    _count("processed")

    flushes: List[asyncio.Task] = []

    async with aiohttp.ClientSession(
        headers={"User-Agent": "meme-search-tpu-scraper/0.1"}
    ) as session:

        async def handle(entry):
            nonlocal batch
            _count("entries")
            if entry["timestamp"] <= resume_ts:
                return
            url = triage_url(entry["url"])
            if url is None:
                return
            entry = dict(entry, url=url)
            async with fetch_sem:
                fetched = await fetch_image(session, url, cfg)
            if fetched is None:
                _count("failed")
                return
            data, mime, final_url = fetched
            _count("fetched")
            if content_hash(data) in cfg.discard_hashes:
                _count("discarded")
                return
            async with batch_lock:
                batch.append((entry, data, mime, final_url))
                if len(batch) >= embedder.config.batch:
                    items, batch = batch, []
                    flushes.append(asyncio.ensure_future(flush(items)))

        tasks = []
        for path in cfg.input_files:
            for entry in iter_reddit_dump(path):
                tasks.append(asyncio.ensure_future(handle(entry)))
                if len(tasks) >= cfg.max_fetch_concurrency * 2:
                    await asyncio.gather(*tasks)
                    tasks = []
        if tasks:
            await asyncio.gather(*tasks)
        if batch:
            flushes.append(asyncio.ensure_future(flush(batch)))
        await asyncio.gather(*flushes)

    writer.close()
    if own_embedder:
        await embedder.close()
    print(f"wrote {written} entries to {out_path}")
    return written


def main(argv=None):
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    with open(argv[0]) as f:
        raw = json.load(f)
    cfg = ScraperConfig(
        input_files=raw["input_files"],
        output_dir=raw.get("output_dir", "dumps"),
        clip_server=raw.get("clip_server", "http://localhost:1708"),
        max_fetch_concurrency=raw.get("max_fetch_concurrency", 512),
        discard_hashes=set(raw.get("discard_hashes", [])),
        seq_start=raw.get("seq_start", 1),
    )
    asyncio.run(scrape(cfg))


if __name__ == "__main__":
    main()
