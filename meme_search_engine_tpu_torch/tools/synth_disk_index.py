"""Generate a production-geometry disk index from synthetic data.

Serving-capacity measurement scaffolding: beam-search QPS is a function
of record IO + per-hop frontier work, both of which are capped by
``search_list`` regardless of graph quality, so a synthetic index with
random adjacency and sample-point PQ centroids exercises the EXACT
per-query cost structure of a real one (4096-B records, fp16 vectors,
R out-edges, 64-chunk OPQ codes, descriptor bytes) at any N without a
multi-hour build. Recall numbers from a synthetic index are meaningless
and never reported.

Counterpart of ``meme_search_engine_tpu/tools/synth_disk_index.py``: the
same CLI and, from the same seed, the same corpus, adjacency and records.
The OPQ encode runs on ``--device`` (the card unless the caller asks for
the CPU; the JAX tool pins itself to the CPU), and the records are packed
by the native packer, byte-identical to a loop of ``PackedIndexEntry``.

Usage:
  python -m meme_search_engine_tpu_torch.tools.synth_disk_index \
      --out /data/synth1m --n 1000000 [--d 1152] [--r 64] [--shards 42] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def stream_main(args):
    """Bounded-memory generator for N where full arrays don't fit:
    writes records chunk-by-chunk."""
    from ..index.native_io import native_pack_records
    from ..index.opq import ProductQuantizer
    from ..pipeline.formats import RECORD_PAD_SIZE, IndexHeader

    rng = np.random.default_rng(args.seed)
    n, d = args.n, args.d
    t0 = time.time()
    os.makedirs(args.out, exist_ok=True)

    q, _ = np.linalg.qr(rng.standard_normal((d, d)).astype(np.float32))
    first = rng.standard_normal((4096, d)).astype(np.float32)
    first /= np.linalg.norm(first, axis=1, keepdims=True)
    centroids = (first[:256] @ q.T).astype(np.float32)
    quantizer = ProductQuantizer(
        centroids=centroids,
        transform=q.astype(np.float32),
        n_dims_per_code=d // args.chunks,
        n_dims=d,
    )
    shard_centroids = first[256 : 256 + args.shards]
    shard_medioids = rng.integers(0, n, args.shards).tolist()

    chunk = 32768
    with open(os.path.join(args.out, "index.bin"), "wb") as recf, open(
        os.path.join(args.out, "index.pq-codes.bin"), "wb"
    ) as pqf, open(
        os.path.join(args.out, "index.descriptor-codes.bin"), "wb"
    ) as descf:
        for start in range(0, n, chunk):
            end = min(n, start + chunk)
            b = end - start
            vecs = rng.standard_normal((b, d)).astype(np.float32)
            vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
            codes = quantizer.quantize(vecs, device=args.device)
            pqf.write(np.ascontiguousarray(codes).tobytes())
            descf.write(rng.integers(0, 256, (b, 4), dtype=np.uint8).tobytes())
            adj = rng.integers(0, n, (b, args.r), dtype=np.int64)
            gid = np.arange(start, end, dtype=np.int64)
            raw, _dead = native_pack_records(
                vecs.astype("<f2"),
                adj.astype(np.int32),
                np.full(b, args.r, np.int32),
                start,
                1700000000 + gid,
                np.tile(np.asarray([[640, 480]], np.int64), (b, 1)),
                np.zeros((b, 3), np.float64),
                [f"https://cdn.example.com/{g}.png" for g in gid.tolist()],
                (gid % args.shards).astype(np.int32)[:, None],
                np.ones(b, np.int32),
                RECORD_PAD_SIZE,
            )
            recf.write(raw)
            if (start // chunk) % 16 == 0:
                print(f"{end}/{n} records ({time.time()-t0:.0f}s)", flush=True)

    header = IndexHeader(
        shards=[
            (list(map(float, c)), int(m))
            for c, m in zip(shard_centroids, shard_medioids)
        ],
        count=n,
        dead_count=0,
        record_pad_size=RECORD_PAD_SIZE,
        quantizer={
            "centroids": quantizer.centroids.flatten().tolist(),
            "transform": quantizer.transform.flatten().tolist(),
            "n_dims_per_code": quantizer.n_dims_per_code,
            "n_dims": d,
        },
        descriptor_cdfs=[],
    )
    header.save(os.path.join(args.out, "index.msgpack"))
    print(f"done in {time.time() - t0:.0f}s -> {args.out}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=1152)
    ap.add_argument("--r", type=int, default=64)
    ap.add_argument("--shards", type=int, default=42)
    ap.add_argument("--chunks", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-flat", action="store_true",
                    help="also write vectors.f16 next to the index")
    ap.add_argument("--stream", action="store_true",
                    help="bounded-memory streaming mode (for N >= 1e7)")
    ap.add_argument("--device", default="cuda",
                    help="where the OPQ codes are encoded ('cpu' for the plain path)")
    args = ap.parse_args(argv)

    if args.stream:
        return stream_main(args)

    from ..index.opq import ProductQuantizer
    from ..pipeline import processor

    rng = np.random.default_rng(args.seed)
    n, d = args.n, args.d
    t0 = time.time()

    print(f"generating {n} x {d} corpus...", flush=True)
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    vectors = vectors.astype(np.float16)

    # quantizer: random orthonormal rotation + sample-point centroids —
    # ADC scores correlate with true dots (frontier ordering behaves),
    # without an OPQ training run
    q, _ = np.linalg.qr(rng.standard_normal((d, d)).astype(np.float32))
    centroids = vectors[rng.permutation(n)[:256]].astype(np.float32) @ q.T
    quantizer = ProductQuantizer(
        centroids=centroids,
        transform=q.astype(np.float32),
        n_dims_per_code=d // args.chunks,
        n_dims=d,
    )

    print("adjacency + manifest...", flush=True)
    adj = rng.integers(0, n, (n, args.r), dtype=np.int64)
    shard_of = rng.integers(0, args.shards, n)
    # padded rows, so the native packer takes every batch
    vertices = processor.PaddedAdjacency(adj.astype(np.int32), np.full(n, args.r, np.int32))
    node_shards = processor.PaddedAdjacency(
        shard_of.astype(np.int32)[:, None], np.ones(n, np.int32)
    )
    manifest = [
        {"timestamp": 1700000000 + i, "url": f"https://cdn.example.com/{i}.png",
         "dimensions": (640, 480)}
        for i in range(n)
    ]
    scores = rng.standard_normal((n, 3)).astype(np.float32)
    shard_centroids = vectors[rng.permutation(n)[: args.shards]].astype(
        np.float32
    )
    shard_medioids = rng.permutation(n)[: args.shards].tolist()

    print("packing records...", flush=True)
    from ..pipeline.descriptors import compute_cdfs

    cdfs = compute_cdfs(scores, [m["timestamp"] for m in manifest])
    processor.pack_index(
        args.out,
        vectors,
        vertices,
        node_shards,
        manifest,
        quantizer,
        shard_centroids,
        shard_medioids,
        scores=scores,
        descriptor_cdfs=cdfs,
        device=args.device,
    )
    if args.save_flat:
        vectors.tofile(os.path.join(args.out, "vectors.f16"))
    print(f"done in {time.time() - t0:.0f}s -> {args.out}", flush=True)


if __name__ == "__main__":
    main()
