"""Reddit multireddit crawler (reference: meme-rater/crawler.py:10-57).

Pages through a multireddit's JSON listing API with polite rate-limit
handling (sleep on 429 / respect x-ratelimit-remaining), yielding post
dicts for the scorer pipeline. Network-gated; the paging/ratelimit logic
is test-injectable via the ``fetch`` argument.

A copy of ``meme_search_engine_tpu/rater/crawler.py``, which the port
keeps rather than imports.
"""

from __future__ import annotations

import json
import time
import urllib.parse
import urllib.request
from typing import Callable, Iterator, Optional


def _default_fetch(url: str) -> tuple:
    req = urllib.request.Request(
        url, headers={"User-Agent": "meme-search-tpu-crawler/0.1"}
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, dict(resp.headers), resp.read()


def crawl_multireddit(
    user: str,
    multi: str,
    *,
    max_pages: int = 20,
    fetch: Optional[Callable] = None,
    sleep=time.sleep,
) -> Iterator[dict]:
    """Yield post data dicts, newest first, across listing pages."""
    fetch = fetch or _default_fetch
    after = None
    for _page in range(max_pages):
        params = {"limit": "100"}
        if after:
            params["after"] = after
        url = (
            f"https://www.reddit.com/user/{user}/m/{multi}.json?"
            + urllib.parse.urlencode(params)
        )
        status, headers, body = fetch(url)
        if status == 429:
            sleep(float(headers.get("retry-after", 30)))
            continue
        if status != 200:
            break
        remaining = headers.get("x-ratelimit-remaining")
        if remaining is not None and float(remaining) < 2:
            sleep(float(headers.get("x-ratelimit-reset", 60)))
        data = json.loads(body)
        children = data.get("data", {}).get("children", [])
        if not children:
            break
        for child in children:
            yield child["data"]
        after = data["data"].get("after")
        if after is None:
            break
