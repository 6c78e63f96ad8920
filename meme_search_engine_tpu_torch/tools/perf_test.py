"""Query-server load test (reference: perf_test.py:6-29).

Fires N random-embedding queries at a live search backend with bounded
concurrency and reports latency percentiles + QPS.

Usage:
  python -m meme_search_engine_tpu_torch.tools.perf_test \
      --server http://localhost:1707 [--n 1000 --concurrency 100 --d 1152]

A copy of ``meme_search_engine_tpu/tools/perf_test.py``, which the port
keeps rather than imports; ``aiohttp`` is imported where it is used.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time

import numpy as np


async def run(args):
    import aiohttp

    rng = np.random.default_rng(0)
    sem = asyncio.Semaphore(args.concurrency)
    latencies = []

    async with aiohttp.ClientSession() as session:
        async def one():
            emb = rng.standard_normal(args.d).astype(np.float32)
            emb /= np.linalg.norm(emb)
            body = {"terms": [{"embedding": emb.tolist()}], "k": 20}
            async with sem:
                t0 = time.perf_counter()
                async with session.post(args.server + "/", json=body) as resp:
                    await resp.read()
                    assert resp.status == 200, resp.status
                latencies.append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        await asyncio.gather(*[one() for _ in range(args.n)])
        wall = time.perf_counter() - t0

    lat = np.asarray(latencies) * 1000
    print(
        json.dumps(
            {
                "n": args.n,
                "qps": round(args.n / wall, 1),
                "p50_ms": round(float(np.percentile(lat, 50)), 2),
                "p95_ms": round(float(np.percentile(lat, 95)), 2),
                "p99_ms": round(float(np.percentile(lat, 99)), 2),
            }
        )
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="http://localhost:1707")
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--concurrency", type=int, default=100)
    ap.add_argument("--d", type=int, default=1152)
    args = ap.parse_args(argv)
    asyncio.run(run(args))


if __name__ == "__main__":
    main()
