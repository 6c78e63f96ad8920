"""Recall@K vs QPS tradeoff sweep over a packed disk index.

The standard ANN operating-curve: sweep ``search_list`` (and optionally
beamwidth / spec) against a persisted brute-force oracle and report
recall@20, QPS, latency and IO counters per point. Ground truth comes
from ``eval_oracle.npz`` written by the scale_bench eval stage
(queries + top-1000 exact ids), so the sweep is pure host+disk work —
the reference's analogous loop is the evaluate mode of
query_disk_index.rs:225-343 run at varying ``--search-list``.

Counterpart of ``meme_search_engine_tpu/tools/recall_sweep.py`` over the
port's ``DiskIndex``: the same CLI and JSON lines.

Usage:
  python -m meme_search_engine_tpu_torch.tools.recall_sweep \
      --index /data/scale1e7/index --oracle /data/scale1e7/eval_oracle.npz \
      [--search-lists 125,250,500,1000,2000] [--beamwidth 3] [--spec 0] \
      [--queries 256] [--k 20]

Prints one JSON line per grid point and a final summary line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--oracle", required=True)
    ap.add_argument("--search-lists", default="125,250,500,1000,2000")
    ap.add_argument("--beamwidth", default="3")
    ap.add_argument("--spec", default="0")
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=20)
    args = ap.parse_args(argv)

    from ..index.disk_index import DiskIndex

    oracle = np.load(args.oracle)
    qs = np.asarray(oracle["queries"], np.float32)[: args.queries]
    gt = np.asarray(oracle["gt"])[: args.queries]
    idx = DiskIndex(args.index)
    print(
        f"index: {idx.header.count} nodes, "
        f"{len(idx.shard_centroids)} shards; {len(qs)} oracle queries",
        flush=True,
    )

    rows = []
    for bw in [int(b) for b in args.beamwidth.split(",")]:
        for spec in [int(s) for s in args.spec.split(",")]:
            for sl in [int(s) for s in args.search_lists.split(",")]:
                # warm the page cache once per config
                idx.search(qs[0], args.k, beamwidth=bw,
                           search_list=sl, dedup=False, spec=spec)
                hits = 0
                reads = 0
                cmps = 0
                t0 = time.time()
                for qi, q in enumerate(qs):
                    results, c = idx.search(
                        q, args.k, beamwidth=bw,
                        search_list=sl, dedup=False, spec=spec,
                    )
                    found = {r.id for r in results}
                    hits += len(found & set(gt[qi, : args.k].tolist()))
                    reads += c.node_reads
                    cmps += c.pq_comparisons
                dt = time.time() - t0
                row = {
                    "search_list": sl,
                    "beamwidth": bw,
                    "spec": spec,
                    "recall_at_20": round(hits / (len(qs) * args.k), 4),
                    "qps": round(len(qs) / dt, 1),
                    "mean_ms": round(1e3 * dt / len(qs), 2),
                    "node_reads_per_query": round(reads / len(qs), 1),
                    "pq_comparisons_per_query": round(cmps / len(qs), 1),
                }
                rows.append(row)
                print(json.dumps(row), flush=True)
    print(json.dumps({"sweep": rows}))
    return rows


if __name__ == "__main__":
    main()
