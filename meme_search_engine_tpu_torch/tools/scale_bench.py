"""Production-geometry disk-index scale benchmark: the large-scale
deployment's entry point.

Runs the full large-scale pipeline (SURVEY SS3.4) at --n up to 1e7 with
the reference's production geometry — ~42 shards, 2-way spill, R=64
L=192, OPQ 64x18x256, 4096-B records — then measures serve-path QPS
vs thread count and eval recall@20 (query_disk_index.rs:225-343
semantics). Every stage writes its artifact and is skipped when the
artifact already exists, so the run is resumable (the reference's
multi-binary pipeline has the same property, files as interface).

Counterpart of ``meme_search_engine_tpu/tools/scale_bench.py``: the same
CLI, stages, artifacts and report keys, from the same seeds the same
corpus. k-means, the shard builds, OPQ training, the pack's encode and
the eval oracle run on ``--device`` (the card unless the caller asks for
the CPU); the split, the merge, the record packing and the beam searches
run on the host, as in the JAX package. It holds the chip lease as the
JAX tool does (``utils/tpu_lease.py``: advertised at the start, a safe
point before each shard build, collect step, OPQ training, pack batch and
eval slab, cleared at the end) and has no compile cache. The dump is written as zstd frames of stored blocks (the
JAX tool compresses at level 8): the synthetic fp16 corpus barely
compresses, and any zstd reader reads either.

Usage:
  python -m meme_search_engine_tpu_torch.tools.scale_bench \
      --workdir /data/scale1m --n 1000000 [--clusters 42] [--stage all] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..utils import tpu_lease
from ..utils.mallctl import malloc_trim, rss_kb

D_EMB = 1152


def log(msg):
    print(f"[scale_bench +{time.strftime('%H:%M:%S')}] {msg}", flush=True)


N_SUPER = 64  # coarse semantic structure (real embedding corpora are
# hierarchical; independent fine clusters at D=1152 are near-orthogonal,
# which makes ANY coarse sharding meaningless — not a property of real
# data, as the reference's 42-shard design presumes)
SUPER_FINE_SCALE = 0.55  # fine-centre dispersion around its super
NOISE_SCALE = 0.45  # point dispersion around its fine centre


def _hier_centers(n):
    """(super_raw, fine_raw) for the hierarchical synthetic corpus."""
    crng = np.random.default_rng(0)
    supers = crng.standard_normal((N_SUPER, D_EMB)).astype(np.float32)
    n_fine = max(N_SUPER, n // 500)
    fines = supers[np.arange(n_fine) % N_SUPER] + (
        SUPER_FINE_SCALE
        * crng.standard_normal((n_fine, D_EMB)).astype(np.float32)
    )
    return supers, fines


def _hier_points(fines, c, rng):
    # dtype=float32 generation: drawing f64 then casting measured ~10x
    # slower on this host (the 1e7 corpus is 1.15e10 normal draws)
    x = fines[c] + NOISE_SCALE * rng.standard_normal(
        (len(c), D_EMB), dtype=np.float32
    )
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _stage_dump(wd, n, seed=0, sample_target=200_000):
    """Synthetic hierarchical corpus as a real zstd dump (fp16 wire).

    Also reservoir-writes a kmeans sample (sample.npy) alongside, so the
    kmeans stage doesn't need a second full decode pass over the dump.
    """
    from ..pipeline.dump import (
        DumpWriter,
        OriginalImageMetadata,
        ProcessedEntry,
    )

    path = os.path.join(wd, "000000001.dump.zst")
    if os.path.exists(path):
        return path
    t0 = time.time()
    rng = np.random.default_rng(seed)
    srng = np.random.default_rng(seed + 1)
    sample_p = min(1.0, sample_target / n)
    samples = []
    _supers, fines = _hier_centers(n)
    n_clusters = len(fines)
    with DumpWriter(path + ".tmp") as w:
        chunk = 8192
        for start in range(0, n, chunk):
            m = min(chunk, n - start)
            c = rng.integers(0, n_clusters, m)
            x = _hier_points(fines, c, rng)
            keep = srng.random(m) < sample_p
            if keep.any():
                samples.append(x[keep].astype(np.float16))
            for j in range(m):
                i = start + j
                w.write(
                    ProcessedEntry(
                        url=f"https://example.com/{i}",
                        id=f"id{i}",
                        title=f"meme {i}",
                        subreddit="memes",
                        author="a",
                        timestamp=1700000000 + i,
                        embedding=x[j],
                        metadata=OriginalImageMetadata(
                            mime_type="image/png",
                            original_file_size=1000 + i % 1000,
                            dimension=(640, 480),
                            final_url=f"https://cdn.example.com/{i}.png",
                        ),
                    )
                )
            if start % (chunk * 16) == 0:
                log(f"dump {start + m}/{n}")
    np.save(os.path.join(wd, "sample.npy"), np.concatenate(samples))
    os.rename(path + ".tmp", path)
    log(f"dump stage: {time.time() - t0:.0f}s")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--clusters", type=int, default=42)
    ap.add_argument("--r", type=int, default=64)
    ap.add_argument("--l", type=int, default=192)
    ap.add_argument("--maxc", type=int, default=750)
    ap.add_argument("--build-batch", type=int, default=1024)
    ap.add_argument("--build-expand", type=int, default=2)
    ap.add_argument("--eval-queries", type=int, default=512)
    ap.add_argument(
        "--eval-queries-allshards",
        type=int,
        default=64,
        help="subsample scored under the reference's evaluate-mode "
        "protocol (union of beams from every shard start, "
        "query_disk_index.rs:280-343) — costs n_shards searches/query",
    )
    ap.add_argument("--serve-queries", type=int, default=256)
    ap.add_argument("--search-list", type=int, default=500)
    ap.add_argument("--beamwidth", type=int, default=4)
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--pq-chunks", type=int, default=64)
    ap.add_argument("--pq-centroids", type=int, default=256)
    ap.add_argument("--ood-queries", type=int, default=1024)
    ap.add_argument(
        "--pad-to",
        type=int,
        default=0,
        help="round each shard's node count up to a multiple of this "
        "with extra OOD pad queries (the JAX tool's bound on per-size "
        "recompiles; the port compiles nothing per size)",
    )
    ap.add_argument(
        "--balance-fudge",
        type=float,
        default=0.2,
        help="online shard-split balance correction "
        "(dump_processor.rs:443-449 semantics: dot - fudge*count/total). "
        "The reference default 0.2 is calibrated for ~42 shards; at "
        "K=420 the per-shard count fraction is 10x smaller, so a "
        "proportionally larger fudge (~2.0) is needed for the same "
        "corrective pressure (measured on the 200k sample: 0.2 -> "
        "p95/med 1.45, 2.0 -> 1.26 at 13.7%% spill-set divergence)",
    )
    ap.add_argument(
        "--stage",
        choices=("all", "prep", "resplit"),
        default="all",
        help="prep: exit once kmeans+split artifacts exist (lets the "
        "caller schedule other work on the card before the long build "
        "phase). "
        "resplit: regenerate shard input files that --frugal-disk "
        "deleted, from vectors.f16 + centroids (assignment.npy replay, "
        "verified against every built shard graph), so an interrupted "
        "many-shard build can resume",
    )
    ap.add_argument(
        "--partial-tail",
        action="store_true",
        help="build nothing; run OPQ/pack/serve/eval over whichever "
        "shard graphs already exist. Records whose shards are all "
        "unbuilt get empty adjacency (dead ends) and the coarse router "
        "only routes to built shards, so eval recall is an honest "
        "partial-coverage number; report.json gains a 'coverage' field "
        "and eval gains 'recall_at_20_covered' (ground truth restricted "
        "to covered records — the quality of what was built)",
    )
    ap.add_argument(
        "--coverage-order",
        action="store_true",
        help="build remaining shards in greedy set-cover order "
        "(most still-uncovered records per estimated build second, "
        "processor.coverage_build_order) instead of shard-id order. "
        "Under a chip-time budget this maximises the fraction of "
        "records reachable by the packed index: each record spills to "
        "2 shards, so sequential order wastes the redundancy "
        "(measured at 1e7/420 shards: +180 shards sequential = 0.853 "
        "coverage vs greedy = 0.922; full coverage at 356/420). "
        "Resume-safe: the order is recomputed from the built set at "
        "every process start, and the pack tail is build-order "
        "independent",
    )
    ap.add_argument(
        "--max-build-records",
        type=int,
        default=0,
        help="exit(3) after building this many shard records in one "
        "process, a cap on host memory growth over a long many-shard "
        "build (in the JAX package a device plugin leaked host memory "
        "per transfer; the cap works whatever grows). Every stage is "
        "resumable; wrap with "
        "`while python -m ...; rc=$?; [ $rc -eq 3 ]; do :; done`",
    )
    ap.add_argument(
        "--frugal-disk",
        action="store_true",
        help="delete the dump once kmeans+split artifacts exist and the "
        "shard inputs once vectors.f16 is written (1e7 needs ~140 GB "
        "otherwise; every deletion keeps the run resumable — deleted "
        "shard inputs come back byte-exactly via --stage resplit)",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="where k-means, the builds, OPQ, the pack's encode and the "
        "oracle run ('cpu' for the plain path)",
    )
    args = ap.parse_args(argv)
    device = args.device

    import torch

    from ..index.disk_index import DiskIndex
    from ..index.kmeans import balanced_kmeans
    from ..index.opq import ProductQuantizer, train_opq
    from ..pipeline import processor
    from ..pipeline.build_shard import build_shard
    from ..pipeline.descriptors import compute_cdfs
    from ..pipeline.formats import read_shard_input, read_shard_output

    wd = args.workdir
    os.makedirs(wd, exist_ok=True)
    # long-running chip holder: advertise for cooperative handoff and
    # check for PAUSE requests at every safe point below
    tpu_lease.advertise(wd)
    pause_point = lambda: tpu_lease.pause_point(log)  # noqa: E731
    report = {"n": args.n, "clusters": args.clusters, "stages_s": {}}
    report_path = os.path.join(wd, "report.json")
    if os.path.exists(report_path):
        # resumed run: keep stage timings recorded by prior invocations
        with open(report_path) as f:
            prior = json.load(f)
        if prior.get("n") == args.n:
            report["stages_s"].update(prior.get("stages_s", {}))

    def checkpoint_report():
        with open(report_path + ".tmp", "w") as f:
            json.dump(report, f, indent=1)
        os.replace(report_path + ".tmp", report_path)

    # the dump is only an input to kmeans + shard split; once both
    # artifacts exist it can be deleted to free disk without forcing a
    # resumed run to regenerate it
    cent_path = os.path.join(wd, "centroids.npy")
    if os.path.exists(cent_path) and os.path.exists(
        os.path.join(wd, "manifest.npy")
    ):
        dump_path = os.path.join(wd, "000000001.dump.zst")
        if args.frugal_disk and os.path.exists(dump_path):
            log("frugal-disk: dump no longer needed, deleting")
            os.remove(dump_path)
    else:
        dump_path = _stage_dump(wd, args.n)

    # --- kmeans centroids on a sample -------------------------------------
    if not os.path.exists(cent_path):
        t0 = time.time()
        sample_path = os.path.join(wd, "sample.npy")
        if os.path.exists(sample_path):
            sample = np.load(sample_path)  # written by _stage_dump
        else:
            sample = processor.sample_embeddings(
                [dump_path], min(1.0, 200_000 / args.n), seed=0
            )
        log(f"kmeans over sample {sample.shape}")
        centroids = balanced_kmeans(
            sample.astype(np.float32), args.clusters, max_iter=120, seed=0,
            device=device,
        )
        np.save(cent_path, centroids)
        report["stages_s"]["kmeans"] = round(time.time() - t0, 1)
        checkpoint_report()
        log(f"kmeans: {report['stages_s']['kmeans']}s")
    centroids = np.load(cent_path)

    # --- 2-way-spill shard split ------------------------------------------
    shard_dir = os.path.join(wd, "shards")
    manifest_path = os.path.join(wd, "manifest.npy")
    if not os.path.exists(manifest_path):
        t0 = time.time()
        count, manifest = processor.split_to_shards(
            [dump_path],
            centroids,
            shard_dir,
            deduplicate=True,
            balance_fudge=args.balance_fudge,
            save_assignment=os.path.join(wd, "assignment.npy"),
        )
        np.save(manifest_path, np.asarray(manifest, object), allow_pickle=True)
        report["stages_s"]["shard_split"] = round(time.time() - t0, 1)
        checkpoint_report()
        log(
            f"shard split: {count} records, "
            f"{report['stages_s']['shard_split']}s"
        )
        if args.frugal_disk and os.path.exists(dump_path):
            log("frugal-disk: dump no longer needed, deleting")
            os.remove(dump_path)
    if args.stage == "prep":
        log("prep stage complete (kmeans + split); exiting")
        tpu_lease.clear()
        return
    manifest = list(np.load(manifest_path, allow_pickle=True))
    n_total = len(manifest)

    if args.stage == "resplit":
        flat_path = os.path.join(wd, "vectors.f16")
        if not os.path.exists(flat_path):
            raise SystemExit(
                "resplit needs vectors.f16 (the collect stage writes it "
                "before --frugal-disk deletes shard inputs)"
            )
        t0 = time.time()
        summary = processor.regenerate_shard_inputs(
            flat_path,
            n_total,
            centroids,
            shard_dir,
            balance_fudge=args.balance_fudge,
            assignment_path=os.path.join(wd, "assignment.npy"),
        )
        report["stages_s"]["resplit"] = round(time.time() - t0, 1)
        checkpoint_report()
        log(f"resplit: {summary} in {report['stages_s']['resplit']}s")
        tpu_lease.clear()
        return

    # --- OOD query vectors (generate_index_shard.rs:71-94) -----------------
    rng = np.random.default_rng(7)
    queries = rng.standard_normal((args.ood_queries, D_EMB)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)

    # --- per-shard Vamana builds -------------------------------------------
    t0 = time.time()
    built = 0
    records_this_run = 0
    build_order = list(range(args.clusters))
    if args.coverage_order and not args.partial_tail:
        assignment_path = os.path.join(wd, "assignment.npy")
        if os.path.exists(assignment_path):
            t_ord = time.time()
            already = [
                s
                for s in range(args.clusters)
                if os.path.exists(
                    os.path.join(shard_dir, f"shard_{s}.graph")
                )
            ]
            build_order = processor.coverage_build_order(
                np.load(assignment_path), already, args.clusters
            )
            log(
                f"coverage order over {len(build_order)} unbuilt shards "
                f"in {time.time() - t_ord:.0f}s (head: {build_order[:6]})"
            )
        else:
            log("coverage-order: assignment.npy missing; sequential order")
    for s in build_order:
        in_path = os.path.join(shard_dir, f"shard_{s}.msgpack")
        out_path = os.path.join(shard_dir, f"shard_{s}.graph")
        if not os.path.exists(in_path) or args.partial_tail:
            continue
        if not os.path.exists(out_path):
            pause_point()
            if (
                args.max_build_records
                and records_this_run >= args.max_build_records
            ):
                log(
                    f"max-build-records reached ({records_this_run}); "
                    "exiting 3 for a fresh-process resume"
                )
                report["stages_s"]["shard_builds"] = round(
                    report["stages_s"].get("shard_builds", 0.0)
                    + time.time()
                    - t0,
                    1,
                )
                checkpoint_report()
                raise SystemExit(3)
            ts = time.time()
            h = build_shard(
                in_path,
                out_path + ".tmp",
                query_vectors=queries,
                r=args.r,
                l=args.l,
                maxc=args.maxc,
                batch_size=args.build_batch,
                build_expand=args.build_expand,
                seed=s,
                pad_to=args.pad_to,
                device=device,
            )
            os.rename(out_path + ".tmp", out_path)
            built += 1
            records_this_run += h.max
            # Return reclaimable glibc arena to the OS between shards
            # (cheap insurance, utils/mallctl.py); RSS is logged so the
            # build's host growth stays measurable on real runs.
            malloc_trim()
            log(
                f"shard {s} built in {time.time() - ts:.0f}s "
                f"(rss {rss_kb() // 1024} MB)"
            )
            report["shards_built"] = built
            report["shard_build_s_last"] = round(time.time() - ts, 1)
            checkpoint_report()
    # collect outputs in shard-id order: the pack tail's shard list
    # (centroid stack, medioid list, node->shard indices) must not
    # depend on the build order
    shard_outputs = []
    for s in range(args.clusters):
        out_path = os.path.join(shard_dir, f"shard_{s}.graph")
        if os.path.exists(out_path):
            shard_outputs.append(read_shard_output(out_path))
    if args.partial_tail:
        uniq = np.unique(
            np.concatenate(
                [np.asarray(h.mapping) for h, _ in shard_outputs]
            )
        )
        report["coverage"] = {
            "built_shards": len(shard_outputs),
            "total_shards": args.clusters,
            "unique_records_covered": int(len(uniq)),
            "fraction": round(len(uniq) / n_total, 4),
        }
        checkpoint_report()
        log(f"partial tail: {report['coverage']}")
    if built:
        # accumulate across --max-build-records restarts
        report["stages_s"]["shard_builds"] = round(
            report["stages_s"].get("shard_builds", 0.0) + time.time() - t0, 1
        )
        checkpoint_report()
        log(f"shard builds: {report['stages_s']['shard_builds']}s")
        if args.max_build_records:
            # run the OPQ/pack/serve/eval tail in a fresh process too:
            # this process carries the build loop's host growth, and the
            # tail adds the eval stream + pack working set on top
            log("builds complete; exiting 3 so the tail runs leak-free")
            raise SystemExit(3)

    # --- OPQ + pack ---------------------------------------------------------
    # The flat fp16 corpus (global-id order) is written FIRST: it serves
    # the eval oracle, lets the pack stage resume without the 2e7-record
    # shard inputs, and with --frugal-disk frees their ~50 GB before the
    # ~41 GB index.bin is written. fp16 collection is lossless — shard
    # inputs store fp16 on the wire (ShardedRecord, common.rs:131-137).
    out_dir = os.path.join(wd, "index")
    flat_path = os.path.join(wd, "vectors.f16")
    if not os.path.exists(os.path.join(out_dir, "index.msgpack")):
        if not os.path.exists(flat_path):
            t0 = time.time()
            log("collecting vectors for OPQ/pack")
            vectors = np.zeros((n_total, D_EMB), np.float16)
            for s in range(args.clusters):
                pause_point()
                in_path = os.path.join(shard_dir, f"shard_{s}.msgpack")
                if not os.path.exists(in_path):
                    continue
                _h, records = read_shard_input(in_path)
                for rid, vec in records:
                    vectors[rid] = vec
            vectors.tofile(flat_path + ".tmp")
            os.rename(flat_path + ".tmp", flat_path)
            report["stages_s"]["collect_vectors"] = round(time.time() - t0, 1)
            checkpoint_report()
            log(f"collect: {report['stages_s']['collect_vectors']}s")
        else:
            vectors = np.memmap(
                flat_path, np.float16, "r", shape=(n_total, D_EMB)
            )
        if args.frugal_disk:
            for s in range(args.clusters):
                in_path = os.path.join(shard_dir, f"shard_{s}.msgpack")
                if os.path.exists(in_path):
                    os.remove(in_path)
            log("frugal-disk: shard inputs deleted (vectors.f16 has them)")

        t0 = time.time()
        # checkpoint the trained OPQ next to the workdir: training is
        # deterministic in the corpus sample + queries (both seeded), so
        # a restarted tail (crash mid-pack, partial-tail -> full-tail
        # rerun) reloads instead of re-paying ~530 s at 1e7
        opq_ckpt = os.path.join(wd, "opq.msgpack")
        pause_point()
        if os.path.exists(opq_ckpt):
            with open(opq_ckpt, "rb") as f:
                pq = ProductQuantizer.from_msgpack(f.read())
            log("opq: reloaded checkpoint")
        else:
            sample_idx = np.sort(
                rng.permutation(n_total)[: min(n_total, 100_000)]
            )
            pq = train_opq(
                np.asarray(vectors[sample_idx], np.float32),
                queries,
                n_chunks=args.pq_chunks,
                n_centroids=args.pq_centroids,
                outer_iters=2,
                adam_iters=120,
                pause_point=pause_point,
                device=device,
            )
            with open(opq_ckpt + ".tmp", "wb") as f:
                f.write(pq.to_msgpack())
            os.rename(opq_ckpt + ".tmp", opq_ckpt)
        report["stages_s"]["opq_train"] = round(time.time() - t0, 1)
        checkpoint_report()
        log(f"opq: {report['stages_s']['opq_train']}s")

        t0 = time.time()
        vertices, node_shards = processor.merge_shard_adjacency(
            shard_outputs, n_total
        )
        scores = rng.standard_normal((n_total, 3)).astype(np.float32)
        cdfs = compute_cdfs(scores, [m["timestamp"] for m in manifest])
        processor.pack_index(
            out_dir,
            vectors,
            vertices,
            node_shards,
            manifest,
            pq,
            # align centroids with the (possibly partial) built-shard
            # set: header.id indexes the kmeans centroid row
            np.stack([centroids[h.id] for h, _ in shard_outputs]),
            [h.mapping[h.medioid] for h, _ in shard_outputs],
            scores=scores,
            descriptor_cdfs=cdfs,
            device=device,
            pause_point=pause_point,
        )
        report["stages_s"]["pack"] = round(time.time() - t0, 1)
        checkpoint_report()
        log(f"pack: {report['stages_s']['pack']}s")
        del vectors

    # --- serve-path measurements --------------------------------------------
    idx = DiskIndex(out_dir)
    log(f"index open: {idx.header.count} nodes, "
        f"shards {len(idx.shard_centroids)}")

    # query workload shaped like the corpus (held-out points near the
    # same fine-cluster centres — the realistic case)
    qrng = np.random.default_rng(1234)
    _supers, fines = _hier_centers(args.n)
    qc = qrng.integers(0, len(fines), args.serve_queries)
    qs = _hier_points(fines, qc, qrng)

    # warm the page cache
    pause_point()
    for q in qs[:8]:
        idx.search(q, 20, beamwidth=args.beamwidth,
                   search_list=args.search_list)

    from concurrent.futures import ThreadPoolExecutor

    report["qps_vs_threads"] = {}
    for threads in (1, 2, 4):
        t0 = time.time()
        with ThreadPoolExecutor(threads) as ex:
            list(
                ex.map(
                    lambda q: idx.search(
                        q, 20, beamwidth=args.beamwidth,
                        search_list=args.search_list,
                    ),
                    qs,
                )
            )
        qps = args.serve_queries / (time.time() - t0)
        report["qps_vs_threads"][threads] = round(qps, 1)
        log(f"threads={threads}: {qps:.1f} QPS")

    # the 1-thread pass above runs right after pack evicted the page
    # cache (it measures mostly NVMe misses on a fresh index); re-run
    # it once the sweep has warmed the beam working set so the table
    # has the steady-state single-thread number too
    t0 = time.time()
    for q in qs:
        idx.search(q, 20, beamwidth=args.beamwidth,
                   search_list=args.search_list)
    report["qps_1thread_rewarmed"] = round(
        args.serve_queries / (time.time() - t0), 1
    )
    checkpoint_report()
    log(f"threads=1 (rewarmed): {report['qps_1thread_rewarmed']} QPS")

    if not args.skip_eval and os.path.exists(flat_path):
        # recall@20 + rank stats vs the brute-force oracle on the device
        # over the flat fp16 corpus (query_disk_index.rs:225-343 eval
        # semantics)
        from ..ops.mips import mips_topk, streamed_mips_topk

        t0 = time.time()
        eval_q = qs[: args.eval_queries]
        # memmap: the streamed path reads 1e6-row slabs sequentially, no
        # need to hold the 23 GB corpus in RAM next to the page cache
        corpus = np.memmap(flat_path, np.float16, "r", shape=(n_total, D_EMB))
        if n_total <= 3_000_000:
            corpus_dev = torch.from_numpy(np.array(corpus)).to(device)  # upload once
            gt_i = []
            for start in range(0, len(eval_q), 64):
                pause_point()
                _s, i = mips_topk(
                    corpus_dev, torch.from_numpy(eval_q[start : start + 64]).to(device),
                    1000, tile=min(n_total, 262_144),
                )
                gt_i.append(i.cpu().numpy())
            gt_i = np.concatenate(gt_i)
            del corpus_dev
        else:
            # corpus exceeds HBM: stream 1e6-row slabs through the
            # device once, all queries per slab (ops/mips.py)
            slab = 1_000_000

            def slabs():
                for s0 in range(0, n_total, slab):
                    pause_point()
                    yield corpus[s0 : s0 + slab], s0

            _s, gt_i = streamed_mips_topk(
                slabs(), eval_q, 1000, tile=262_144, device=device
            )
        # persist the oracle (queries + top-1000 ids): recall/QPS
        # tradeoff sweeps over search_list/beamwidth/spec are pure host
        # work given this file — no need to re-pay the device stream
        np.savez(
            os.path.join(wd, "eval_oracle.npz"), queries=eval_q, gt=gt_i
        )
        # Under --partial-tail the raw recall is bounded above by the
        # coverage fraction (a true neighbour in an unbuilt shard is
        # unreachable by construction), so ALSO score against the
        # ground truth restricted to covered records: that is the
        # quality of the index over what was actually built, the number
        # that extrapolates to full coverage. Both are reported; neither
        # replaces the other.
        covered = None
        if args.partial_tail:
            covered = np.zeros(n_total, bool)
            covered[
                np.concatenate(
                    [np.asarray(h.mapping) for h, _ in shard_outputs]
                )
            ] = True
        hits, ranks = 0, []
        hits_cov, denom_cov = 0, 0
        for qi, q in enumerate(eval_q):
            # eval mode: no near-duplicate dedup (the reference's
            # evaluate path ranks raw results, query_disk_index.rs:225-343;
            # dedup belongs to the serve handler only)
            results, _c = idx.search(
                q, 20, beamwidth=args.beamwidth,
                search_list=args.search_list, dedup=False,
            )
            found = {r.id for r in results}
            hits += len(found & set(gt_i[qi, :20].tolist()))
            if covered is not None:
                row = gt_i[qi]
                row_cov = row[covered[row]][:20]
                hits_cov += len(found & set(row_cov.tolist()))
                denom_cov += len(row_cov)
            top = results[0].id if results else -1
            pos = np.nonzero(gt_i[qi] == top)[0]
            ranks.append(int(pos[0]) + 1 if len(pos) else 1001)
        ranks = np.asarray(ranks, np.float64)
        report["eval"] = {
            "recall_at_20": round(hits / (len(eval_q) * 20), 4),
            "mean_rank": round(float(ranks.mean()), 2),
            "median_rank": float(np.median(ranks)),
            "harmonic_mean_rank": round(
                float(len(ranks) / (1.0 / ranks).sum()), 3
            ),
        }
        if covered is not None and denom_cov:
            report["eval"]["recall_at_20_covered"] = round(
                hits_cov / denom_cov, 4
            )
        # the single-start numbers above use the SERVE-mode protocol
        # (one beam from the best shard) — stricter than the
        # reference's evaluate mode, which unions beams from EVERY
        # shard start and takes per-position best ranks
        # (query_disk_index.rs:280-343). Score that protocol too, on a
        # subsample (it costs n_shards searches per query).
        n_as = min(args.eval_queries_allshards, len(eval_q))
        if n_as:
            hits_as = 0
            for qi in range(n_as):
                results, _c = idx.search_all_shards(
                    eval_q[qi], 20, beamwidth=args.beamwidth,
                    search_list=args.search_list, dedup=False,
                )
                found = {r.id for r in results}
                hits_as += len(found & set(gt_i[qi, :20].tolist()))
            report["eval"]["recall_at_20_allshards"] = round(
                hits_as / (n_as * 20), 4
            )
            report["eval"]["allshards_queries"] = n_as
        report["stages_s"]["eval"] = round(time.time() - t0, 1)
        log(f"eval: {report['eval']}")

    checkpoint_report()
    tpu_lease.clear()
    print(json.dumps(report))


if __name__ == "__main__":
    main()
