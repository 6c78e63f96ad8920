"""In-memory ANN quality/perf harness (reference: diskann/src/main.rs).

Loads (or synthesises) an fp16 corpus, builds the Vamana graph, and
reports: build time, degree stats (lib.rs:403-416 report_degrees),
self-recall@1, recall@10 vs brute force, and QPS — the reference's
evaluation protocol (main.rs:101-137).

Counterpart of ``meme_search_engine_tpu/tools/ann_bench.py`` over the
port's ``vamana`` and ``mips``: the same CLI and JSON line. The build, the
search and the brute-force oracle run on ``--device`` (the card unless the
caller asks for the CPU).

Usage:
  python -m meme_search_engine_tpu_torch.tools.ann_bench \
      [--vectors real.bin --queries query5.bin --d-emb 1152] \
      [--n 100000 --d 1152 synth fallback] [--r 64 --l 192 --maxc 750] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--vectors")
    ap.add_argument("--queries")
    # "--d" spelled out: argparse would read it as an ambiguous prefix of
    # --d-emb and --device
    ap.add_argument("--d-emb", "--d", type=int, default=1152)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--r", type=int, default=64)
    ap.add_argument("--l", type=int, default=192)
    ap.add_argument("--maxc", type=int, default=750)
    ap.add_argument("--alpha", type=float, default=65536 / 65536)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--expand", type=int, default=2)
    ap.add_argument("--corpus-dtype", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--eval-queries", type=int, default=512)
    ap.add_argument(
        "--max-steps",
        type=int,
        default=0,
        help="override the build search-hop budget (0 = auto: "
        "ceil(2L/expand)); --max-steps 384 restores the pre-round-2 "
        "fixed 2L budget for quality A/Bs",
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..index import vamana
    from ..ops.mips import mips_topk
    from ..utils.timer import Timer

    if args.vectors:
        vecs = (
            np.fromfile(args.vectors, np.float16)
            .reshape(-1, args.d_emb)
            .astype(np.float32)
        )
    else:
        rng = np.random.default_rng(0)
        vecs = rng.standard_normal((args.n, args.d_emb)).astype(np.float32)
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    n = len(vecs)
    print(f"corpus: {n} x {vecs.shape[1]}")

    cfg = vamana.VamanaConfig(
        r=args.r,
        l=args.l,
        maxc=args.maxc,
        alpha=args.alpha,
        batch_size=args.batch_size,
        build_expand=args.expand,
        corpus_dtype=args.corpus_dtype,
        max_search_steps=args.max_steps,
    )
    with Timer("build") as t_build:
        graph = vamana.build_graph(vecs, cfg, verbose=True, device=args.device)

    degrees = (graph >= 0).sum(axis=1)
    print(
        f"degrees: avg {degrees.mean():.1f} median {np.median(degrees):.0f} "
        f"min {degrees.min()} max {degrees.max()}"
    )

    # self-recall@1 (main.rs:101-137)
    nq = min(args.eval_queries, n)
    rng = np.random.default_rng(1)
    sample = rng.permutation(n)[:nq]
    t0 = time.perf_counter()
    _s, ids, _steps = vamana.search(vecs, graph, vecs[sample], 10, cfg, device=args.device)
    qps = nq / (time.perf_counter() - t0)
    self_recall = float((ids[:, 0] == sample).mean())

    # recall@10 vs brute force
    _es, exact = mips_topk(
        torch.from_numpy(vecs.astype(np.float16)).to(args.device),
        torch.from_numpy(vecs[sample]).to(args.device),
        10,
    )
    exact = exact.cpu().numpy()
    recall10 = float(
        np.mean(
            [
                len(set(ids[i].tolist()) & set(exact[i].tolist())) / 10
                for i in range(nq)
            ]
        )
    )

    print(
        json.dumps(
            {
                "n": n,
                "build_seconds": round(t_build.elapsed, 2),
                "self_recall@1": round(self_recall, 4),
                "recall@10": round(recall10, 4),
                "qps": round(qps, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
