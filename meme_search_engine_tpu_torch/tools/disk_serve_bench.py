"""Disk-index serve-path QPS benchmark (thread sweep, warm or cold cache).

Measures the per-core beam-search serving rate of a packed disk index
(the reference measures the same loop inside query_disk_index.rs serve
mode; its eval harness is query_disk_index.rs:225-343). Works on both
real pipeline indexes (tools/scale_bench.py) and synthetic
cost-structure indexes (tools/synth_disk_index.py — QPS from those is
meaningful because per-query cost is capped by search_list + record IO,
not graph quality; recall from them is NOT and is never reported here).

Prints one JSON line: {"n":..., "qps_vs_threads": {...}, "mean_ms":...,
"node_reads":..., "pq_comparisons":...}.

Counterpart of ``meme_search_engine_tpu/tools/disk_serve_bench.py`` over
the port's ``DiskIndex``: the same CLI and JSON line.

Usage:
  python -m meme_search_engine_tpu_torch.tools.disk_serve_bench \
      --index /data/synth10m [--queries 256] [--threads 1,2,4] \
      [--beamwidth 4] [--search-list 500] [--k 20] [--warmup 16]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--threads", default="1,2,4")
    ap.add_argument("--beamwidth", type=int, default=4)
    ap.add_argument("--search-list", type=int, default=500)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=16)
    ap.add_argument("--seed", type=int, default=99)
    ap.add_argument(
        "--spec",
        type=int,
        default=None,
        help="speculative frontier reads per hop (native path; default "
        "env MSE_DISK_SPEC or 0) — results are invariant, only the IO "
        "schedule changes; sweep 0/2/4/8 for the cold-latency A/B",
    )
    ap.add_argument(
        "--cold",
        action="store_true",
        help="evict index.bin from the page cache (fadvise DONTNEED) "
        "before every thread sweep: measures the device-IOPS-bound "
        "regime a >page-cache index (1e8+) serves from, instead of the "
        "warm memcpy regime",
    )
    args = ap.parse_args(argv)

    from ..index.disk_index import DiskIndex

    def drop_records_cache():
        # POSIX_FADV_DONTNEED on the whole records file; sync first so
        # dirty pages (a freshly packed index) are actually evictable.
        path = os.path.join(args.index, "index.bin")
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)

    idx = DiskIndex(args.index)
    n = idx.header.count
    d = len(idx.shard_centroids[0]) if len(idx.shard_centroids) else 1152
    print(f"index: {n} nodes, {len(idx.shard_centroids)} shards", flush=True)

    rng = np.random.default_rng(args.seed)
    qs = rng.standard_normal((args.queries, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)

    def one(q):
        return idx.search(
            q, args.k, beamwidth=args.beamwidth,
            search_list=args.search_list, spec=args.spec,
        )

    t0 = time.time()
    counters = []
    for q in qs[: args.warmup]:
        _r, c = one(q)
        counters.append(c)
    warm_s = time.time() - t0
    print(f"warmup {args.warmup} queries: {warm_s:.1f}s "
          f"(cold page cache shows here)", flush=True)

    report = {"n": n, "beamwidth": args.beamwidth,
              "search_list": args.search_list, "k": args.k,
              "cold": bool(args.cold), "spec": args.spec,
              "qps_vs_threads": {}}
    lat_ms = []
    for threads in [int(t) for t in args.threads.split(",")]:
        if args.cold:
            drop_records_cache()
        t0 = time.time()
        with ThreadPoolExecutor(threads) as ex:
            if threads == 1:
                # per-query latency distribution on the 1-thread pass
                def timed_one(q):
                    s = time.perf_counter()
                    _r, c = one(q)
                    counters.append(c)
                    return (time.perf_counter() - s) * 1e3
                counters = []  # replace warmup counters with measured
                lat_ms = list(ex.map(timed_one, qs))
            else:
                list(ex.map(one, qs))
        dt = time.time() - t0
        report["qps_vs_threads"][threads] = round(args.queries / dt, 1)
        print(f"threads={threads}: {args.queries / dt:.1f} QPS", flush=True)

    if lat_ms:
        a = np.asarray(lat_ms)
        report["mean_ms"] = round(float(a.mean()), 2)
        report["p50_ms"] = round(float(np.percentile(a, 50)), 2)
        report["p95_ms"] = round(float(np.percentile(a, 95)), 2)
        report["p99_ms"] = round(float(np.percentile(a, 99)), 2)
    if counters:
        report["node_reads_per_query"] = round(
            float(np.mean([c.node_reads for c in counters])), 1
        )
        report["pq_comparisons_per_query"] = round(
            float(np.mean([c.pq_comparisons for c in counters])), 1
        )
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
