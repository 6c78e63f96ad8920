"""Dump-processor CLI (reference: src/dump_processor.rs argh flags
:25-76).

Subcommands over zstd msgpack dumps:
  sample       random embedding sample -> fp16 .bin (-s)
  stats        entry count / dedup count / embedding histogram
  kmeans       balanced spherical k-means -> centroids.bin
  shard        dedup + threshold filter + 2-way-spill shard split (-C -S)
  build-shards per-shard Vamana builds (generate-index-shard)
  pack         final index pack (-S -i -M --cdfs)
  parquet      dump -> parquet (slow_dump_parse_script.py; needs pyarrow)

Example end-to-end:
  dump_tool sample  --dumps d/*.zst --fraction 0.01 --output sample.bin
  dump_tool kmeans  --sample sample.bin --clusters 42 --output centroids.bin
  dump_tool shard   --dumps d/*.zst --centroids centroids.bin --out-dir s/
  dump_tool build-shards --shard-dir s/ --queries query_data.bin
  dump_tool pack    --shard-dir s/ --out-dir index/ --opq opq.msgpack

Counterpart of ``meme_search_engine_tpu/tools/dump_tool.py`` over the
port's ``pipeline/processor``, ``index/kmeans`` and
``pipeline/build_shard``: the same subcommands and flags, plus
``--device`` for the three that compute (k-means, the shard builds and
the pack's OPQ encode and its ``--score-model`` scores), ``cuda``
unless the caller asks for ``cpu``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sample")
    p.add_argument("--dumps", nargs="+", required=True)
    p.add_argument("--fraction", type=float, default=0.01)
    p.add_argument("--output", required=True)

    p = sub.add_parser("stats")
    p.add_argument("--dumps", nargs="+", required=True)

    p = sub.add_parser("kmeans")
    p.add_argument("--sample", required=True)
    p.add_argument("--d-emb", type=int, default=1152)
    p.add_argument("--clusters", type=int, default=42)
    p.add_argument("--output", required=True)
    p.add_argument("--max-iter", type=int, default=200)
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("shard")
    p.add_argument("--dumps", nargs="+", required=True)
    p.add_argument("--centroids", required=True)
    p.add_argument("--d-emb", type=int, default=1152)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--no-dedup", action="store_true")
    p.add_argument("--balance-fudge", type=float, default=0.2)

    p = sub.add_parser("build-shards")
    p.add_argument("--shard-dir", required=True)
    p.add_argument("--queries")
    p.add_argument("--d-emb", type=int, default=1152)
    p.add_argument("--r", type=int, default=64)
    p.add_argument("--l", type=int, default=192)
    p.add_argument("--maxc", type=int, default=750)
    p.add_argument("--passes", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--expand", type=int, default=2)
    p.add_argument("--corpus-dtype", default="bf16", choices=["bf16", "int8"])
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("pack")
    p.add_argument("--shard-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--opq", required=True)
    p.add_argument("--score-model")
    p.add_argument("--cdfs")
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("parquet")
    p.add_argument("--dumps", nargs="+", required=True)
    p.add_argument("--output", required=True)

    args = ap.parse_args(argv)
    paths = sorted(
        sum((glob.glob(p) for p in getattr(args, "dumps", [])), [])
    ) if hasattr(args, "dumps") else []

    from ..pipeline import processor

    if hasattr(args, "device"):
        from ..serving.engine import resolve_device

        args.device = resolve_device(args.device)

    if args.cmd == "sample":
        sample = processor.sample_embeddings(paths, args.fraction)
        sample.tofile(args.output)
        print(f"wrote {len(sample)} x {sample.shape[1]} fp16 to {args.output}")

    elif args.cmd == "stats":
        from ..pipeline.dump import read_dump

        count = 0
        ring = processor.DedupRing()
        for p_ in paths:
            for e in read_dump(p_):
                ring.admit(e)
                count += 1
        print(json.dumps({"entries": count, "duplicates": ring.deduped}))

    elif args.cmd == "kmeans":
        from ..index.kmeans import balanced_kmeans, save_centroids

        sample = (
            np.fromfile(args.sample, np.float16)
            .reshape(-1, args.d_emb)
            .astype(np.float32)
        )
        centroids = balanced_kmeans(
            sample, args.clusters, max_iter=args.max_iter, verbose=True,
            device=args.device,
        )
        save_centroids(centroids, args.output)
        print(f"wrote {args.clusters} centroids to {args.output}")

    elif args.cmd == "shard":
        from ..index.kmeans import load_centroids

        centroids = load_centroids(args.centroids, args.d_emb)
        count, manifest = processor.split_to_shards(
            paths,
            centroids,
            args.out_dir,
            deduplicate=not args.no_dedup,
            balance_fudge=args.balance_fudge,
        )
        with open(os.path.join(args.out_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        print(f"{count} records -> {len(centroids)} shards")

    elif args.cmd == "build-shards":
        from ..pipeline.build_shard import build_shard

        queries = None
        if args.queries:
            queries = (
                np.fromfile(args.queries, np.float16)
                .reshape(-1, args.d_emb)
                .astype(np.float32)
            )
        for in_path in sorted(
            glob.glob(os.path.join(args.shard_dir, "shard_*.msgpack"))
        ):
            out_path = in_path.replace(".msgpack", ".graph")
            header = build_shard(
                in_path,
                out_path,
                query_vectors=queries,
                r=args.r,
                l=args.l,
                maxc=args.maxc,
                n_build_passes=args.passes,
                batch_size=args.batch_size,
                build_expand=args.expand,
                corpus_dtype=args.corpus_dtype,
                verbose=True,
                device=args.device,
            )
            print(f"shard {header.id}: {header.max} nodes -> {out_path}")

    elif args.cmd == "pack":
        _pack(args)

    elif args.cmd == "parquet":
        _parquet(paths, args.output)


def _pack(args):
    from ..index.opq import ProductQuantizer
    from ..pipeline import processor
    from ..pipeline.formats import read_shard_input, read_shard_output

    with open(args.opq, "rb") as f:
        pq = ProductQuantizer.from_msgpack(f.read())

    shard_outputs = []
    vectors = {}
    centroids, medioids, counts = [], [], []
    for graph_path in sorted(
        glob.glob(os.path.join(args.shard_dir, "shard_*.graph"))
    ):
        header, adjacency = read_shard_output(graph_path)
        shard_outputs.append((header, adjacency))
        centroids.append(header.centroid)
        medioids.append(header.mapping[header.medioid])
        counts.append(header.max)
        h_in, records = read_shard_input(
            graph_path.replace(".graph", ".msgpack")
        )
        for rid, vec in records:
            vectors[rid] = vec

    with open(os.path.join(args.shard_dir, "manifest.json")) as f:
        manifest = json.load(f)
    n = len(manifest)
    d = pq.n_dims
    vec_arr = np.zeros((n, d), np.float32)
    for rid, vec in vectors.items():
        vec_arr[rid] = vec

    vertices, node_shards = processor.merge_shard_adjacency(shard_outputs, n)

    scores = None
    cdfs = None
    if args.score_model:
        from ..models.score_model import WideScoreModel

        model = WideScoreModel.load_safetensors(args.score_model)
        scores = model.score_batch(vec_arr, device=args.device)
    if args.cdfs:
        from ..pipeline.descriptors import load_cdfs

        cdfs = load_cdfs(args.cdfs)
    elif scores is not None:
        from ..pipeline.descriptors import compute_cdfs

        cdfs = compute_cdfs(scores, [m["timestamp"] for m in manifest])

    header = processor.pack_index(
        args.out_dir,
        vec_arr,
        vertices,
        node_shards,
        manifest,
        pq,
        np.asarray(centroids, np.float32),
        medioids,
        scores=scores,
        descriptor_cdfs=cdfs,
        device=args.device,
    )
    print(f"packed {header.count} nodes ({header.dead_count} dead)")


def _parquet(paths, output):
    from ..pipeline.dump import read_dump

    try:
        import pyarrow as pa
        import pyarrow.parquet as pq_
    except ImportError:
        raise SystemExit("pyarrow not available in this environment")

    rows = {
        "url": [],
        "id": [],
        "title": [],
        "subreddit": [],
        "author": [],
        "timestamp": [],
        "embedding": [],
    }
    for p in paths:
        for e in read_dump(p):
            rows["url"].append(e.url)
            rows["id"].append(e.id)
            rows["title"].append(e.title)
            rows["subreddit"].append(e.subreddit)
            rows["author"].append(e.author)
            rows["timestamp"].append(e.timestamp)
            rows["embedding"].append(e.embedding.astype(np.float16).tobytes())
    pq_.write_table(pa.table(rows), output)
    print(f"wrote {len(rows['url'])} rows to {output}")


if __name__ == "__main__":
    main()
