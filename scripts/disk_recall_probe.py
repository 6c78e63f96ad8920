#!/usr/bin/env python3
"""CPU probes of where the disk deployment's recall goes, the JAX package
against the port on the same inputs.

Each probe draws ``tools/scale_bench.py``'s hierarchical synthetic corpus
at n = 4e5 (the seeds of its dump stage), its k-means sample and its 256
eval queries, then runs the stage under test through each package named:

    kmeans  both packages' ``balanced_kmeans`` (42 clusters, the tool's
            settings) on the tool's sample; for each, the top-2 split's
            max/ideal and how many eval queries lack their true top 20
            in their start shard. Saves the centroids under OUT.
    opq     both packages' ``train_opq`` (64 x 256, the tool's 2 x 120
            iterations, 1,024 OOD queries) on one 20,480-row sample; for
            each, how the ADC ranks a 100k slice against the exact dots:
            recall@20, the exact top 20 inside the ADC top 100, and the
            OOD queries' squared error.
    graph   one shard of the split by the port's centroids (the one
            nearest 19,000 rows; needs ``kmeans`` first) built by each
            package's ``build_shard`` with the deployment's parameters
            (R/L/maxc 64/192/750, batch 1,024, expand 2, bf16, 1,024 OOD
            queries), then searched from its medioid with exact scores on
            the frontier (L 500, beamwidth 4) by up to 2,000 queries whose
            start shard it is: recall@20 and the queries whose first
            answer is outside the shard's true top 1,000.

It imports the JAX package, so it runs where JAX runs, on the CPU
(``JAX_PLATFORMS=cpu``). The corpus takes about 1 GB of host memory; on 8
cores the graph builds take about 6 (JAX) and 10 (port) minutes. Usage,
from the repository root:

    JAX_PLATFORMS=cpu python3 scripts/disk_recall_probe.py kmeans OUT torch jax
    JAX_PLATFORMS=cpu python3 scripts/disk_recall_probe.py opq OUT torch jax
    JAX_PLATFORMS=cpu python3 scripts/disk_recall_probe.py graph OUT torch jax
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from meme_search_engine_tpu_torch.tools import scale_bench  # noqa: E402

N, D, K = 400_000, scale_bench.D_EMB, 42


def corpus():
    """(fp16 corpus, fp32 k-means sample, fine centres): the dump stage's
    draws, chunk by chunk."""
    rng, srng = np.random.default_rng(0), np.random.default_rng(1)
    sample_p = min(1.0, 200_000 / N)
    _supers, fines = scale_bench._hier_centers(N)
    x, samples = np.zeros((N, D), np.float16), []
    for start in range(0, N, 8192):
        m = min(8192, N - start)
        c = rng.integers(0, len(fines), m)
        rows = scale_bench._hier_points(fines, c, rng)
        keep = srng.random(m) < sample_p
        if keep.any():
            samples.append(rows[keep].astype(np.float16))
        x[start : start + m] = rows
    return x, np.concatenate(samples).astype(np.float32), fines


def eval_queries(fines):
    """The tool's serve queries, of which it evaluates all 256."""
    qrng = np.random.default_rng(1234)
    return scale_bench._hier_points(fines, qrng.integers(0, len(fines), 256), qrng)


def top2(x, cent):
    out = np.zeros((len(x), 2), np.int64)
    for j in range(0, len(x), 100_000):
        sims = x[j : j + 100_000].astype(np.float32) @ cent.T
        out[j : j + 100_000] = np.argsort(-sims, axis=1, kind="stable")[:, :2]
    return out


def probe_kmeans(out, packages):
    x, sample, fines = corpus()
    qs = eval_queries(fines)
    top = []
    for i in range(0, len(qs), 64):
        s = np.zeros((len(qs[i : i + 64]), N), np.float32)
        for j in range(0, N, 100_000):
            s[:, j : j + 100_000] = qs[i : i + 64] @ x[j : j + 100_000].astype(np.float32).T
        top.append(np.argsort(-s, axis=1)[:, :20])
    top = np.concatenate(top)
    for name in packages:
        t0 = time.time()
        if name == "jax":
            from meme_search_engine_tpu.index.kmeans import balanced_kmeans

            cent = balanced_kmeans(sample, K, max_iter=120, seed=0)
        else:
            from meme_search_engine_tpu_torch.index.kmeans import balanced_kmeans

            cent = balanced_kmeans(sample, K, max_iter=120, seed=0, device="cpu")
        np.save(os.path.join(out, f"centroids_{name}.npy"), cent)
        assign = top2(x, cent)
        counts = np.bincount(assign.ravel(), minlength=K)
        start = np.argmax(qs @ cent.T, axis=1)
        held = np.array([(assign[top[q]] == start[q]).any(axis=1).sum() for q in range(len(qs))])
        print(f"{name}: {time.time() - t0:.1f} s, top-2 max/ideal {counts.max() / (2 * N / K):.3f}; "
              f"eval queries with none of their top 20 in their start shard {int((held == 0).sum())}, "
              f"with fewer than 10 {int((held < 10).sum())}", flush=True)


def probe_opq(out, packages, m=20_480):
    x, _sample, fines = corpus()
    orng = np.random.default_rng(7)
    ood = orng.standard_normal((1024, D)).astype(np.float32)
    ood /= np.linalg.norm(ood, axis=1, keepdims=True)
    sample = x[np.sort(np.random.default_rng(5).permutation(N)[:m])].astype(np.float32)
    qs = eval_queries(fines)
    sub = x[:100_000].astype(np.float32)
    exact = np.argsort(-(qs @ sub.T), axis=1)[:, :20]
    chunks, dpc = 64, D // 64
    for name in packages:
        t0 = time.time()
        kw = dict(n_chunks=chunks, n_centroids=256, outer_iters=2, adam_iters=120)
        if name == "jax":
            from meme_search_engine_tpu.index.opq import train_opq

            pq = train_opq(sample, ood, **kw)
        else:
            from meme_search_engine_tpu_torch.index.opq import train_opq

            pq = train_opq(sample, ood, device="cpu", **kw)
        cent, tr = np.asarray(pq.centroids), np.asarray(pq.transform)
        np.savez(os.path.join(out, f"opq_{name}.npz"), centroids=cent, transform=tr)
        cc = cent.reshape(256, chunks, dpc)
        codes = np.einsum("nkd,ckd->nkc", (sub @ tr.T).reshape(len(sub), chunks, dpc), cc).argmax(-1)
        lut = np.einsum("qkd,ckd->qkc", (qs @ tr.T).reshape(len(qs), chunks, dpc), cc)
        adc = np.zeros((len(qs), len(sub)), np.float32)
        for c in range(chunks):
            adc += lut[:, c, codes[:, c]]
        order = np.argsort(-adc, axis=1)
        r20 = np.mean([len(set(order[i, :20]) & set(exact[i])) / 20 for i in range(len(qs))])
        r100 = np.mean([len(set(order[i, :100]) & set(exact[i])) / 20 for i in range(len(qs))])
        recon = cc.transpose(1, 0, 2)[np.arange(chunks)[None, :], codes].reshape(len(sub), D) @ tr
        err = np.mean(np.square(ood[:256] @ (sub - recon).T))
        print(f"{name}: {time.time() - t0:.0f} s, ADC recall@20 {r20:.4f}, exact top 20 inside the ADC "
              f"top 100 {r100:.4f}, OOD query squared error {err:.3e}", flush=True)


def beam_search(base, adj, med, q, search_list=500, beamwidth=4):
    """``DiskIndex.search``'s loop over one shard's graph, exact scores on
    the frontier; the ids of the best 20 visited."""
    seen = np.zeros(len(adj), bool)
    seen[med] = True
    f_ids = np.array([med])
    f_sc = base[f_ids] @ q
    visited = {}
    while len(f_ids):
        top = np.lexsort((f_ids, -f_sc))[:beamwidth]
        batch = f_ids[top]
        keep = np.ones(len(f_ids), bool)
        keep[top] = False
        f_ids, f_sc = f_ids[keep], f_sc[keep]
        for i in batch:
            visited[int(i)] = float(base[i] @ q)
        cand = np.unique(np.concatenate([adj[i] for i in batch]))
        cand = cand[~seen[cand]]
        seen[cand] = True
        if len(cand):
            f_ids, f_sc = np.concatenate([f_ids, cand]), np.concatenate([f_sc, base[cand] @ q])
            if len(f_ids) > 2 * search_list:
                keep = np.lexsort((f_ids, -f_sc))[:search_list]
                f_ids, f_sc = f_ids[keep], f_sc[keep]
        if len(visited) >= search_list:
            break
    return sorted(visited, key=lambda i: -visited[i])[:20]


def probe_graph(out, packages):
    x, _sample, fines = corpus()
    cent = np.load(os.path.join(out, "centroids_torch.npy"))
    assign = top2(x, cent)
    sizes = np.bincount(assign.ravel(), minlength=K)
    s = int(np.argsort(np.abs(sizes - 19_000))[0])
    members = np.nonzero((assign == s).any(axis=1))[0]
    base = x[members].astype(np.float32)
    qrng = np.random.default_rng(99)
    qs = scale_bench._hier_points(fines, qrng.integers(0, len(fines), 40_000), qrng)
    qs = qs[np.argmax(qs @ cent.T, axis=1) == s][:2000]
    gt = np.argsort(-(qs @ base.T), axis=1)[:, :1000]
    orng = np.random.default_rng(7)
    ood = orng.standard_normal((1024, D)).astype(np.float32)
    ood /= np.linalg.norm(ood, axis=1, keepdims=True)
    params = dict(r=64, l=192, maxc=750, batch_size=1024, build_expand=2, seed=s)
    print(f"shard {s}: {len(members)} rows, {len(qs)} queries start in it", flush=True)
    for name in packages:
        t0 = time.time()
        if name == "jax":
            from meme_search_engine_tpu.pipeline import formats
            from meme_search_engine_tpu.pipeline.build_shard import build_shard

            inp, outp = os.path.join(out, f"shard_{s}.msgpack"), os.path.join(out, f"shard_{s}_jax.graph")
            formats.write_shard_input(inp, formats.ShardInputHeader(id=s, centroid=cent[s].tolist()),
                                      zip(members.tolist(), base))
            med = build_shard(inp, outp, query_vectors=ood, **params).medioid
            adj = [np.asarray(a, np.int64) for a in formats.read_shard_output(outp)[1]]
        else:
            from meme_search_engine_tpu_torch.pipeline.build_shard import build_shard_graph

            graph, med = build_shard_graph(base, ood, device="cpu", **params)
            adj = [row[row >= 0].astype(np.int64) for row in graph[: len(base)]]
        build_s = time.time() - t0
        hits, lost = 0, 0
        for qi, q in enumerate(qs):
            res = beam_search(base, adj, int(med), q)
            hits += len(set(res) & set(gt[qi, :20].tolist()))
            lost += int(res[0] not in set(gt[qi].tolist()))
        print(f"{name}: build {build_s:.0f} s, medioid {int(med)}, mean degree "
              f"{np.mean([len(a) for a in adj]):.2f}; recall@20 {hits / (20 * len(qs)):.4f}, first answer "
              f"outside the shard's top 1,000 for {lost} of {len(qs)}", flush=True)


if __name__ == "__main__":
    probe, out, packages = sys.argv[1], sys.argv[2], sys.argv[3:]
    os.makedirs(out, exist_ok=True)
    {"kmeans": probe_kmeans, "opq": probe_opq, "graph": probe_graph}[probe](out, packages)
