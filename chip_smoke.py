#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``meme_search_engine_tpu_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

``python3 chip_smoke.py --fat-bench [ROOT]`` times the fat attention
kernel alone (see ``fat_bench``), for an A/B of two checkouts;
``python3 chip_smoke.py --gather-bench`` the gathered dots alone (see
``gather_bench``); ``--mha-bench [ROOT]``, ``--adc-bench [ROOT]`` and
``--proj-bench [ROOT]`` the fused attention, ADC and fused attention +
o-projection kernels alone (see ``mha_bench``, ``adc_bench`` and
``proj_bench``), each for an A/B of two checkouts.
``python3 chip_smoke.py --disk-n N`` runs the whole script with the disk
phase at n = N (``--disk-n 1000000`` is the deployment uncut; it takes
about 1,100 s). ``python3 chip_smoke.py --train-scrape`` runs the
``train``, ``sharded_search`` and ``scrape`` phases alone (see
``train_scrape``), ``python3 chip_smoke.py --quality`` the ``quality``
phase alone (see ``quality_only``), ``python3 chip_smoke.py --routes`` the
``text_routes`` and ``model_parallel`` phases and the ``flash_mha`` check
alone (see ``routes_only``), ``python3 chip_smoke.py --naflex`` the
``naflex`` phase alone (see ``naflex_only``).

Phases, in order; any failure exits non-zero with no result line:

1. Device: the card's name and power limit (nvidia-smi), TF32 off.
2. Build: every CUDA kernel of the port, from ``ops/csrc``.
3. Kernel checks: each kernel against its plain PyTorch version on the
   card at SigLIP SO400M/14@384 shapes with B=2 and again with B=128
   (stated tolerances), then timed at B=128 (CUDA events, median) beside
   its plain version, one PyTorch library call for the same function,
   and its bound, with its TFLOP/s and share of the bf16 peak (the fat
   attention's bound also counts its exponentials, B * H * SP^2 at 16 a
   clock on each SM, and reports them apart);
   ``ln_mlp_residual``'s two launches (LN + fc1 + gelu, fc2 + residual)
   are checked and timed apart as well. The image kernels run at the image tower's shapes; the
   fused attention kernel at the text tower's (B, 64, 16, 72), in all
   three stable modes at B=2, and once more at S=729, B=2; then also
   checked and timed at a single text's (1, 64, 16, 72). The ADC kernel
   at N = 1,000,003 codes of M = 64 bytes with B = 1 and B = 64 LUTs of
   C = 256, at the JAX test's (300, 16) x (3, 16, 256), and at C = 16 with
   codes up to 255 (rtol = atol = 1e-4); then timed at N = 1e6, B = 1 and
   B = 64, beside its plain version, its bound and one library call for
   the same function (``F.embedding_bag(mode="sum")`` over the LUTs
   zero-padded to 256 entries as a (M * 256, B) table, bag n holding the
   indices codes[n, m] + 256 m; it answers (N, B), held against the plain
   version at 1e-4 too); then both of its routes, M = 32, 64 and 128
   (conflict-free lookups) and M = 48, each at B = 1, 3 and 64 over
   250,007 codes, checked and timed. The row gather bit for bit (tolerance 0) at the
   shard build's hop shape, (1024, 128) ids into 48,643 x 1152 bf16, at
   its prune shape (1024, 750), the hop shape in int8, near the end of a
   1e6 x 1152 bf16 corpus (past 2^31 bytes), at D = 32 and 72 in int8, at
   (3, 50) and (1, 1) ids, with ids out of range (clamped) and with no ids
   (no launch); then timed at the hop and prune shapes beside its plain
   version, ``torch.index_select`` and its bound. The gathered dots
   (``gathered_dots``): ``gather_dot`` and ``gather_gram`` against their
   plain versions (1e-5 on bf16 rows of unit vectors, exact in int8) at
   the hop and prune shapes and the same edges, ragged C (7, 129, 750) and
   exact symmetry for the Gram; then timed at the hop (dot) and prune
   (Gram) shapes beside their plain versions, the route each replaces in
   the build (gather_rows, .float(), fp32 bmm), ``torch.index_select`` +
   ``torch.bmm(out_dtype=torch.float32)`` and the bound. The fused attention +
   o-projection kernel (``fat_vit_mha_packed_proj``, clusters of 8 CTAs
   over heads, which no main path runs: it lost to kernels 7 then 2)
   on the image tower's layer shapes and activations at B=2 and B=128,
   against its plain version and against kernels 7 then 2 on the card
   (valid rows, rtol = atol = 2e-2), at SP = 200 with 129 valid rows (two
   query blocks) and at the tiny geometries; its cluster size,
   ``cudaOccupancyMaxActiveClusters`` and ptxas's registers and spills
   logged; then timed beside its plain version, 7 + 2 and SDPA + addmm.
4. Main path at full SO400M width (27 layers per tower, random weights
   from a seed, the hash tokenizer): one EmbeddingEngine holds both
   towers behind the service's InferenceWorker.
   - Images: requests of 1, 7 and 16 images at 384x384 and one at
     500x400 (the on-device resize); every image kernel's launch count
     must match the buckets run, and the text kernel must not launch.
     Then one B=128 batch is timed through the engine.
   - Texts: requests of 1, 7 and 16 strings; the fused attention kernel
     must launch 27 times per bucket and no image kernel at all. Then a
     256-text request (two buckets of 128) is timed three times, and
     one text layer's parts are timed at B=128.
   All outputs must be finite and unit-norm, and three embeddings of
   each tower must agree (cos >= 0.999) with the same weights run on the
   CPU through the plain versions.
   - The text tower's routes (``text_routes``): 256 texts (two buckets of
     128) through (a) the default route, (b) ``MSE_TEXT_FUSED=1`` with
     its three sub-blocks ``xla``, (c) with all three ``fused`` and (d)
     ``attn_impl="fat_interpret"``, each with its exact launches a bucket
     (a, b: ``fused_mha`` 27; c: ``ln_matmul``, ``fused_mha``,
     ``matmul_residual``, ``ln_mlp_residual`` 27 each; d: ``ln_matmul``,
     ``fat_vit_mha``, ``matmul_residual``, ``ln_mlp_residual`` 27 each),
     cos >= 0.999 against (a) (max |d| logged), three texts against the
     CPU plain path of the same route and texts/s (median of three); the
     routes' weight bytes on the card; then kernels 1 (the fused route's
     QKV at N = 3456 and the fat route's with the key mask), 2, 3 and 7
     (SP = 64) at the routes' shapes against their plain versions at B = 2
     and 128, timed at 128 beside the bound and the library call. Then
     ``model_parallel``: the engine over ``[[cuda:0, cuda:0]]`` with
     ``model_parallel=True`` (two shards of the weights on the card),
     16 images and 16 texts against the single-device engine (rtol =
     atol = 2e-2, cos >= 0.999), each kernel once a shard a layer (the MAP
     head's ``ln_matmul`` once a shard), each shard's weight bytes,
     images/s at 128 and texts/s at 256; then ``flash_mha`` against
     ``mha_xla`` at (2, 729, 16, 72) in fp32 (2e-3).
   - The small-scale service on the same engine (``service``): 1e5 rows
     in a temporary SQLite state (512 images embedded by the engine, the
     rest unit-norm fp16 rows from a seed), ``build_index`` + swap, 64
     concurrent k = 1000 searches through the ``SearchBatcher`` in fewer
     device calls, each equal to the CPU's exact top-k up to near ties
     (1e-5); fused text queries (weights 1, 0.5, -1; the fused vector
     equal to the weighted sum of its terms); an ingested image found
     first by its stored embedding, with its dims; then the reload, the
     search at B = 1 and 16 beside its byte bound, and a single-text
     query end to end, timed. The fused kernel launches on no main path.
   - The SigLIP train step (``train``) on a 1 x 1 mesh of
     ``torch.distributed`` (NCCL, world size 1): at SO400M widths and
     depth 2 one step on the card against the same step on the CPU (loss
     2e-2, every gradient's cosine 0.99); at full depth, B = 8, five steps
     timed and one profiled, the peak memory, no kernel launched (the
     train route is the plain one); the state saved and restored equal;
     the trained tree served through the image kernels against the plain
     route (cos 0.999). Then ``sharded_search``: ``ShardedFlatIndex`` on
     the same kind of mesh, 1e5 x 1152 fp16 rows, 64 queries at k =
     1,000, equal to ``FlatIndex.search`` up to near ties (1e-5). Then
     ``scrape``: the scraper end to end against a local image host and
     the port's clip server on this engine (256 images, 26 links triage
     rejects), every accepted link in the dump once with the engine's
     own embedding of its bytes (cos 0.999), the image kernels launched
     and the text kernel not; ``dump_tool stats`` on the dump;
     ``get_embedding`` of one text (27 ``fused_mha`` launches).
   - The quality model, the rater stack and the SAE (``quality``) at the
     reference's widths (an ensemble of 16 at d = 1152 with 3 channels, an
     SAE of 262,144 features at top-k 128), inputs from seeds: the rater
     trained 600 steps on 16,384 rated pairs of 8,192 items (its loss below
     0.8x the first, validation AUROC >= 0.8, 3 steps card against CPU), the
     wide export and its safetensors file, 1e6 x 1152 scored (4,096 rows
     against float64 numpy at 1e-4), ``dump_tool`` through ``pack
     --score-model`` on 2e4 records in 4 shards (codes equal to the wide
     model's, the Useful slider raising the answers' codes), active
     learning, a crawl from a local host embedded by the engine (kernels 1,
     2, 3 and 7 28, 27, 27, 27 times a bucket, 5 none) with 8 planted
     duplicates flagged and no others and the queue app over HTTP, then 30
     SAE steps on the service's 1e5 library (64 rows card against CPU, one
     step traced by ``utils/profiling.trace``) and feature exemplars.
   - SigLIP 2 SO400M/16 NaFlex (``naflex_serve``): the clip server's
     ``build_engine`` by ``model_name``, eight pictures of eight aspect
     ratios through ``make_app`` and ``InProcessEmbedder``, each against
     ``embed_image_list`` of the picture alone at its grid (cos 0.999).
   - Quantizers, at the deployment size of docs/scale1m_report.json
     (N = 1e6, d = 1152): the port's ``tools/quantizer_bench`` trains OPQ
     64x256 on a 50k sample with 64 queries, encodes the corpus and
     scores the 64 queries one at a time (exactly 64 ADC launches and no
     other kernel), then RaBitQ 512 and scalar u8. The transform must be
     orthonormal (1e-3); 4,096 of the card's codes are held against the
     CPU's (any that differ must be near ties: the CPU's best sim within
     1e-4 of the sim of the card's code), and 2 queries' ADC scores
     against the CPU's at 1e-4.
   - The large-scale deployment (``disk``), at docs/scale1m_report.json's
     d = 1152 in 42 shards with n cut from 1e6 to 4e5 (``DISK_N``: the
     script's time limit), through the port's ``tools/scale_bench.py``
     as a user runs it (after a check of the free disk space), in a
     temporary workdir under ``build/`` deleted at the end: the
     hierarchical synthetic dump, balanced k-means on the card, the top-2
     split, every shard's ``build_shard`` with 1,024 OOD queries (R/L/maxc
     64/192/750, batch 1,024, bf16), OPQ 64x256 on a 100k sample, the merge
     and the pack into 4096-B records (``--frugal-disk``; the tool holds
     the chip lease: ``.tpu_busy.json`` names this process at every safe
     point and is gone after the run), QPS at 1, 2 and 4
     threads and eval recall@20 against the exact oracle (search list 500,
     beamwidth 4, 256 serve and 512 eval queries), each stage timed. Each
     shard's build must launch ``gather_dot`` once a hop, round (the merge
     of the existing neighbours), re-prune chunk and stitch product,
     ``gather_gram`` once a prune (re-prunes included), ``gather_rows`` and
     every other kernel never; every shard built and stitched; the merged
     adjacency well formed; ``index.msgpack`` counting n records and the
     dead ones a scan of every record finds; 4,096 records equal to the
     flat corpus and the merge; the index open with ``NativeNav``; the
     native beam search equal to the numpy loop on 16 queries (ids and
     counters, scores within 1e-5); recall@20 >= 0.90. Then the port's
     disk query server (``make_app`` with the engine's text tower as its
     in-process embedder) over HTTP answers 1, 7 and 16 concurrent text
     queries and a fused one (weights 1, 0.5, -1), launching ``fused_mha``
     27 times a bucket and nothing else, each answer's ids equal to
     ``DiskIndex.search`` on its fused vector; 64 single text queries are
     timed, embed and search apart. Then the checks of shard 0 as it was
     built (``shard0_checks``): the graph well formed and stitched,
     self-recall@1 >= 0.95 and recall@10 >= 0.80 (ann_bench's protocol
     over 512 base rows); one round's greedy search and one prune under
     torch.profiler (the card's time a hop against the build's wall time
     a hop); 64 nodes searched and pruned on the card against the CPU: in
     bf16, pool ids on >= 99% and scores within 1e-5, and every pruned row
     that differs must hold a decision within 1e-5 of its threshold; in
     int8, whose sums are exact integers, everything must be equal.
5. One JSON line with every kernel's numbers, one with the quantizer
   path's, one with the service's, one with the disk deployment's, one
   with the ``train``, ``sharded_search`` and ``scrape`` phases', one with
   the ``quality`` phase's, one with the ``naflex`` phase's, one with the
   ``text_routes``, ``model_parallel``
   and ``flash_mha`` results, then
   the card's name and power limit, then ``{"ok": true, "device": {...}}`` as
   the last line.
"""

from __future__ import annotations

import json
import os
import queue
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published dense bf16 peak and memory rate of the H100 SXM (NVIDIA data
# sheet), the card this script is written for; any other card fails.
CARD, PEAK_FLOPS, PEAK_BW = "H100 80GB HBM3", 989e12, 3.35e12
# Shared-memory lookups a second: 32 banks of one 4-byte word a clock on
# each of 132 SMs at the 1.98 GHz boost clock (the ADC kernel's operations)
PEAK_SMEM_WORDS = 32 * 132 * 1.98e9
# Exponentials a second: 16 a clock in each SM's special-function units, at
# the same clock (the fat attention's second bound, beside its products)
PEAK_EXP = 16 * 132 * 1.98e9

B_CHECK, B_TIME = 2, 128
CHECK_TOL = 0.05  # rtol = atol for the GEMM kernels (tests/test_fused.py)
ATTN_TOL = 2e-2  # atol on valid rows for attention (tests/test_attention.py:98)
ADC_TOL = 1e-4  # rtol = atol for ADC (tests/test_quantizers.py:175)
ADC_N, ADC_M = 1_000_003, 64  # a corpus of 1e6 codes and a ragged tail
# the ADC kernel's two routes at a ragged N: M a multiple of 32 (conflict-free
# lookups), then 48 (the other route)
ADC_EDGE_N, ADC_EDGE_M = 250_007, (32, 64, 128, 48)
NEAR_TIE = 1e-4  # a code may differ from the CPU's only within this of its best sim
# the row gather at the shard build's shapes: a corpus of about the shard's
# node count, the hop's (batch, expand x R) ids and the prune's (batch, maxc)
GATHER_N, GATHER_HOP, GATHER_PRUNE = 48_643, (1024, 128), (1024, 750)
# the gathered dots against their plain versions, with bf16 rows of unit
# vectors: fp32 sums of the same exact products in another order
GATHER_DOT_TOL = 1e-5
# fp32 FMAs a second on the H100 SXM's CUDA cores (data sheet), the bound
# of gather_dot's operations
PEAK_FP32 = 67e12
# the small-scale service: a personal library of about 1e5 items, some of
# them images embedded by the engine; a search answer may differ from the
# CPU's exact top-k only by near ties within this
SERVICE_N, SERVICE_IMAGES, NEAR_TIE_SEARCH = 100_000, 512, 1e-5
# the large-scale deployment of docs/scale1m_report.json: d = 1152 in 42
# shards, every width and parameter of that run, with n cut from 1e6 to
# 4e5: at 1e6 the deployment alone ran 910 s and the script would have
# taken about 1,100 s of its 1,200 s limit on an H100 (PERF.md, §4)
DISK_N, DISK_CLUSTERS, DISK_CUT = 400_000, 42, "n 1e6 -> 4e5: the script's time limit"
# free space its workdir needs per 1e6 records: the dump and the shard
# inputs (about 7 GiB), then vectors.f16 and index.bin (about 6.4 GiB), and
# headroom
DISK_FREE_GIB = 16
# eval recall@20 floor (the JAX package's recorded build reached 0.966)
DISK_MIN_RECALL = 0.90
# the native beam search's exact scores against the numpy loop's
NATIVE_SCORE_TOL = 1e-5


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1, inner: int = 1) -> float:
    """Median over ``reps`` of the card's time per call: CUDA events
    around ``inner`` back-to-back calls. A spin kernel queued first holds
    the stream while the host enqueues them, so the window holds the
    card's work and not the host's launch overhead."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000 * inner)  # about 0.1 ms per call at 1.98 GHz
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def compare(got, want, tol, rows=None):
    """(max abs error, whether |got - want| <= tol + tol * |want| everywhere);
    ``rows`` keeps the first rows of dim 1 (attention's valid rows)."""
    g, w = got.float()[:, :rows], want.float()[:, :rows]
    if not bool(g.isfinite().all()):
        return float("inf"), False
    d = (g - w).abs()
    return float(d.max()), bool((d <= tol + tol * w.abs()).all())


def gathered_dots(dev, gen, d: int = 1152, n_huge: int = 1_000_000) -> dict:
    """Phase 3 for the two kernels that take the shard build's gathered rows
    straight into their products: ``gather_dot`` (the hop's and the
    re-prune's dots) and ``gather_gram`` (the prune's candidate Gram).
    Each is held against its plain version (rtol = atol = GATHER_DOT_TOL
    with bf16 rows of unit vectors, as the build holds them; exactly with
    int8 rows, whose sums are integers below 2^24) at the build's shapes and
    its edges, with exactly one launch a call and none for no ids; the Gram
    must come out exactly symmetric. Then each is timed at its build shape
    (the hop, the prune) beside its plain version, the route it replaces
    in the build (``gather_rows``, ``.float()``, an fp32 ``torch.bmm``,
    timed as a whole), the library composition (``torch.index_select``
    then ``torch.bmm(..., out_dtype=torch.float32)`` on bf16) and its bound.
    Returns the two ``kernels`` entries' numbers."""
    import torch

    from meme_search_engine_tpu_torch.ops import gather

    def unit(n):
        x = torch.randn((n, d), generator=gen, device=dev)
        return (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)

    def ids(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    gu = unit(GATHER_N)
    gx8 = torch.randint(-127, 128, (GATHER_N, d), generator=gen, device=dev, dtype=torch.int8)
    huge = torch.zeros((n_huge, d), device=dev, dtype=torch.bfloat16)  # 2.3 GB, past 2^31 B
    huge[-1000:] = unit(1000)
    hop_ids, prune_ids = ids(GATHER_HOP, 0, GATHER_N), ids(GATHER_PRUNE, 0, GATHER_N)
    wild = ids((64, 50), -100_000, GATHER_N + 100_000)
    wild[0, :2] = torch.tensor([-(2**31), 2**31 - 1], dtype=torch.int32)
    # (corpus, ids); gather_dot's queries are rows of the corpus, as the
    # build's are
    cases = {
        "hop_bf16": (gu, hop_ids),
        "prune_bf16": (gu, prune_ids),
        "hop_int8": (gx8, hop_ids),
        "prune_int8": (gx8, prune_ids[:64]),
        "64bit_offsets": (huge, ids((64, 100), n_huge - 1000, n_huge)),
        "d32_int8": (gx8[:, :32].contiguous(), ids((64, 50), 0, GATHER_N)),
        "d72_int8": (gx8[:, :72].contiguous(), ids((64, 50), 0, GATHER_N)),
        "c7_c129": (gu, ids((16, 129), 0, GATHER_N)),
        "ids_3x50": (gu, ids((3, 50), 0, GATHER_N)),
        "ids_1x1": (gu, ids((1, 1), 0, GATHER_N)),
        "out_of_range_clamped": (gu, wild),
        "no_ids": (gu, ids((0, 128), 0, GATHER_N)),
    }
    results = {k: {"max_abs_err": 0.0, "tolerance": GATHER_DOT_TOL, "checked": list(cases)}
               for k in ("gather_dot", "gather_gram")}

    def held(name, key, got, want, exact):
        gather_launches = dict(gather.launches)
        torch.cuda.synchronize()
        if got.numel():
            err, ok = compare(got, want, 0.0 if exact else GATHER_DOT_TOL)
        else:
            err, ok = 0.0, got.shape == want.shape
        want_launches = {"gather_rows": 0, "gather_dot": 0, "gather_gram": 0}
        want_launches[name] = 1 if got.numel() else 0
        ok = ok and gather_launches == want_launches
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        log(f"check {name} {key} ids {tuple(want.shape[:2])}: max_abs_err {err:.3e} "
            f"({'exact' if exact else f'tol {GATHER_DOT_TOL}'}), launches {gather_launches} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} disagrees with its plain version or launched wrongly: {key}")

    for key, (gv, gi) in cases.items():
        exact = gv.dtype == torch.int8
        q = gv[torch.randint(0, gv.shape[0], (gi.shape[0],), generator=gen, device=dev)].float()
        gather.reset_launches()
        got = gather.gather_dot(gv, gi, q)
        held("gather_dot", key, got, gather.gather_dot_plain(gv, gi, q), exact)
        if key.startswith("hop"):
            continue  # the hop's shape is the dot's; the Gram's is the prune's
        for gj in ((gi[:, :7], gi) if key == "c7_c129" else (gi,)):
            gather.reset_launches()
            got = gather.gather_gram(gv, gj)
            held("gather_gram", f"{key} C={gj.shape[1]}", got, gather.gather_gram_plain(gv, gj), exact)
            if not torch.equal(got, got.transpose(1, 2)):
                fail(f"gather_gram is not exactly symmetric: {key}")
            del got
    del huge, wild, cases, gx8
    torch.cuda.empty_cache()

    # the times at the build's shapes
    try:
        torch.bmm(gu[:2, None], gu[:2, :, None], out_dtype=torch.float32)
        has_out_dtype = True
    except (TypeError, RuntimeError) as e:
        has_out_dtype = False
        log(f"library composition not timed: torch.bmm has no out_dtype here ({str(e)[:80]})")
    row_bytes = d * gu.element_size()
    hq = gu[torch.randint(0, GATHER_N, (GATHER_HOP[0],), generator=gen, device=dev)].float()
    hq16 = hq.to(torch.bfloat16)  # exact: the queries are bf16 rows

    def flat_rows(gi):
        return torch.index_select(gu, 0, gi.reshape(-1)).view(*gi.shape, d)

    def gram(v, **kw):
        return torch.bmm(v, v.transpose(1, 2), **kw)

    rows = {
        "gather_dot": dict(
            gi=hop_ids, inner=20,
            kern=lambda: gather.gather_dot(gu, hop_ids, hq),
            plain=lambda: gather.gather_dot_plain(gu, hop_ids, hq),
            replaced=lambda: torch.bmm(gather.gather_rows(gu, hop_ids).float(), hq[:, :, None])[..., 0],
            library=lambda: torch.bmm(flat_rows(hop_ids), hq16[:, :, None], out_dtype=torch.float32),
            # fp32 FMAs on the CUDA cores, 67 TFLOP/s (the H100 SXM's fp32 peak)
            ops=2.0 * hop_ids.numel() * d, peak_ops=PEAK_FP32,
            out_bytes=hop_ids.numel() * 4 + hq.numel() * 4,
        ),
        "gather_gram": dict(
            gi=prune_ids, inner=2,
            kern=lambda: gather.gather_gram(gu, prune_ids),
            plain=lambda: gather.gather_gram_plain(gu, prune_ids),
            replaced=lambda: gram(gather.gather_rows(gu, prune_ids).float()),
            library=lambda: gram(flat_rows(prune_ids), out_dtype=torch.float32),
            # the symmetric Gram's distinct dots, C (C + 1) / 2 a row, on
            # the tensor cores
            ops=2.0 * GATHER_PRUNE[0] * d * GATHER_PRUNE[1] * (GATHER_PRUNE[1] + 1) / 2, peak_ops=PEAK_FLOPS,
            out_bytes=GATHER_PRUNE[0] * GATHER_PRUNE[1] ** 2 * 4,
        ),
    }
    for name, r in rows.items():
        gi, inner = r["gi"], r["inner"]
        if has_out_dtype:
            results[name]["library_max_abs_err"] = float(
                (r["library"]().float().reshape(-1) - r["plain"]().reshape(-1)).abs().max())
        t_k = time_ms(r["kern"], reps=10, inner=inner)
        t_p = time_ms(r["plain"], reps=3, inner=1)
        t_r = time_ms(r["replaced"], reps=3, inner=1)
        t_l = time_ms(r["library"], reps=5, inner=1) if has_out_dtype else None
        # each distinct row read once, the ids and queries read once, the
        # output written once
        distinct = int(torch.unique(gi).numel())
        nbytes = distinct * row_bytes + gi.numel() * 4 + r["out_bytes"]
        t_bytes, t_ops = nbytes / PEAK_BW * 1e3, r["ops"] / r["peak_ops"] * 1e3
        results[name].update({
            "ms": t_k, "plain_ms": t_p, "replaced_route_ms": t_r, "library_ms": t_l,
            "library_calls": ("torch.index_select + torch.bmm(out_dtype=torch.float32) on bf16, two calls"
                              if has_out_dtype else "torch.bmm has no out_dtype on this torch"),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops, "distinct_rows": distinct,
            "shape": list(gi.shape),
        })
        log(f"time {name} ids {tuple(gi.shape)} from {GATHER_N} x {d} bf16: kernel {t_k:.4f} ms, "
            f"plain {t_p:.3f} ms, the route it "
            f"replaces (gather_rows, .float(), fp32 bmm) {t_r:.3f} ms, "
            f"library (index_select + bmm out_dtype fp32) "
            + (f"{t_l:.4f} ms" if t_l is not None else "not timed")
            + f", bound {max(t_bytes, t_ops):.4f} ms ({results[name]['bound_by']}: bytes {t_bytes:.4f}, "
            f"operations {t_ops:.4f}; {distinct} distinct rows)")
    del gu, hop_ids, prune_ids, hq, hq16, rows
    torch.cuda.empty_cache()
    return results


def disk(engine, dev, timed, launch_counts, reset_counts, check_counts,
         n: int = DISK_N, clusters: int = DISK_CLUSTERS, free_gib: float = DISK_FREE_GIB) -> dict:
    """The large-scale deployment of docs/scale1m_report.json end to end,
    through the port's ``tools/scale_bench.py`` as a user runs it, in a
    temporary workdir under ``build/`` that is deleted at the end: the
    hierarchical synthetic dump, k-means 42 on the card, the top-2 split,
    every shard's ``build_shard`` (1,024 OOD queries, R/L/maxc 64/192/750,
    batch 1,024, bf16), OPQ 64x256, the merge and the pack into 4096-B
    records, served QPS at 1, 2 and 4 threads and the eval against the
    exact oracle (512 queries; 64 more over every shard). Then the checks
    on what it left, the disk query server over HTTP with the engine's
    text tower as its embedder, and the checks of the old shard build on
    shard 0 (``shard0_checks``). Returns the ``disk`` JSON object."""
    import shutil
    import tempfile

    top = os.path.join(ROOT, "build")
    os.makedirs(top, exist_ok=True)
    free, need = shutil.disk_usage(top).free / 2**30, free_gib * n / 1e6
    if free < need:
        fail(f"disk: {free:.1f} GiB free under {top}; the deployment at n = {n} needs {need:.1f}")
    wd = tempfile.mkdtemp(prefix="disk_smoke_", dir=top)
    try:
        return _disk(engine, dev, timed, launch_counts, reset_counts, check_counts, n, clusters, wd)
    finally:
        shutil.rmtree(wd, ignore_errors=True)


def _disk(engine, dev, timed, launch_counts, reset_counts, check_counts, n, clusters, wd) -> dict:
    import asyncio
    import contextlib

    import torch

    from meme_search_engine_tpu_torch.index import vamana
    from meme_search_engine_tpu_torch.index.disk_index import DiskIndex
    from meme_search_engine_tpu_torch.index.native_io import PythonReader
    from meme_search_engine_tpu_torch.pipeline import build_shard, processor
    from meme_search_engine_tpu_torch.pipeline.formats import PackedIndexEntry
    from meme_search_engine_tpu_torch.serving.client import InProcessEmbedder
    from meme_search_engine_tpu_torch.serving.engine import pow2_buckets
    from meme_search_engine_tpu_torch.tools import scale_bench
    from meme_search_engine_tpu_torch.utils import tpu_lease

    r, l, maxc, batch, n_ood = 64, 192, 750, 1024, 1024
    search_list, beamwidth, k = 500, 4, 20
    d = scale_bench.D_EMB
    cfg = engine.cfg
    t_phase = time.perf_counter()
    zero = {name: 0 for name in launch_counts()}

    # the stages the tool's report does not split, on the host clock; the
    # merge's inputs and output and shard 0's build are kept for the checks
    stages: dict = {}
    kept: dict = {}

    def stage(owner, name, key):
        fn = getattr(owner, name)

        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stages[key] = stages.get(key, 0.0) + time.perf_counter() - t0
            if key == "merge":
                kept[key] = (a, out)
            return out

        setattr(owner, name, wrapper)
        return owner, name, fn

    build_stages: dict = {}
    calls: dict = {}
    names = ("_batched_greedy_search", "_merge_pool", "_batched_robust_prune", "_insert_back_edges",
             "_reprune_overflow", "_score_sort_prune", "robust_stitch", "medioid_dev")
    wrapped = [(vamana, n_, timed(vamana, n_, build_stages, calls)) for n_ in names]
    shards: list = []
    shard0: dict = {}
    real_build = build_shard.build_shard_graph

    def build(base, query_vectors=None, **kw):
        """build_shard's graph build, with this shard's launches checked:
        gather_dot once a hop, a round (the existing neighbours), a
        re-prune chunk and a product the stitch asks for; gather_gram
        once a prune, the re-prunes' included; nothing else."""
        before, c0 = launch_counts(), dict(calls)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph, med = real_build(base, query_vectors, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {key: v - before[key] for key, v in launch_counts().items()}
        c = {key: v - c0.get(key, 0) for key, v in calls.items()}
        i = len(shards)
        n_total = len(base) + len(query_vectors)
        if c.get("robust_stitch") != 1 or graph.shape != (n_total, r):
            fail(f"shard build {i}: {c.get('robust_stitch')} stitches, graph {graph.shape}")
        if n_total > 100_000:  # build_graph checks its device mirror up to 1e5 nodes
            fail(f"shard build {i} of {n_total} nodes: build_graph skipped its device-mirror check")
        check_counts(f"disk (shard build {i})", got, {
            **zero, "gather_dot": c["hops"] + c["_merge_pool"] + c.get("_score_sort_prune", 0)
            + c.get("stitch_products", 0), "gather_gram": c["_batched_robust_prune"],
        }, 1)
        shards.append({"nodes": n_total, "wall_s": wall, "hops": c["hops"],
                       "prunes": c["_batched_robust_prune"], "gather_dot": got["gather_dot"],
                       "gather_gram": got["gather_gram"]})
        if i == 0:
            shard0.update(base=np.asarray(base, np.float32), queries=np.asarray(query_vectors, np.float32),
                          graph=graph, med=med, wall=wall, stages=dict(build_stages), calls=c,
                          launches=got)
        return graph, med

    # the chip lease: at every safe point of the build the busy file names
    # this process and the workdir; it is gone after the run
    lease = {"pause_points": 0, "advertised": 0}
    real_pause = tpu_lease.pause_point
    holder = {"pid": os.getpid(), "workdir": os.path.abspath(wd)}

    def pause_point(log=None):
        lease["pause_points"] += 1
        if os.path.exists(tpu_lease.BUSY_PATH):
            with open(tpu_lease.BUSY_PATH) as f:
                lease["advertised"] += json.load(f) == holder
        real_pause(log)

    build_shard.build_shard_graph = build
    tpu_lease.pause_point = pause_point
    wrapped += [(tpu_lease, "pause_point", real_pause),
                stage(scale_bench, "_stage_dump", "dump"),
                stage(processor, "merge_shard_adjacency", "merge"),
                stage(processor, "pack_index", "pack_index")]
    argv = ["--workdir", wd, "--n", str(n), "--clusters", str(clusters), "--r", str(r), "--l", str(l),
            "--maxc", str(maxc), "--build-batch", str(batch), "--build-expand", "2",
            "--ood-queries", str(n_ood), "--pq-chunks", "64", "--pq-centroids", "256",
            "--serve-queries", "256", "--eval-queries", "512", "--search-list", str(search_list),
            "--beamwidth", str(beamwidth), "--frugal-disk", "--device", dev.type]
    log(f"disk: scale_bench {' '.join(argv)} (its log goes to stderr)")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            scale_bench.main(argv)
    finally:
        build_shard.build_shard_graph = real_build
        for owner, name, fn in wrapped:
            setattr(owner, name, fn)
    tool_s = time.perf_counter() - t0
    lease["busy_after"] = os.path.exists(tpu_lease.BUSY_PATH)
    log(f"disk: the chip lease: {lease['advertised']} of {lease['pause_points']} safe points saw "
        f"{tpu_lease.BUSY_PATH} name this process; after the run it "
        f"{'still exists' if lease['busy_after'] else 'is gone'}")
    if not 0 < lease["advertised"] == lease["pause_points"] or lease["busy_after"]:
        fail(f"disk: scale_bench did not hold the chip lease as advertised: {lease}")
    run_launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(wd, "report.json")) as f:
        report = json.load(f)
    stage_s = {**report["stages_s"], **stages}
    build_walls = [s["wall_s"] for s in shards]
    log(f"disk: the tool ran {tool_s:.1f} s; stages (s) "
        + ", ".join(f"{key} {v:.2f}" for key, v in stage_s.items())
        + f"; {len(shards)} shard builds of {min(s['nodes'] for s in shards)}-"
        f"{max(s['nodes'] for s in shards)} nodes in {min(build_walls):.1f}-{max(build_walls):.1f} s "
        f"(median {np.median(build_walls):.1f}); launches {run_launches}; peak memory {peak:.1f} GiB")
    log(f"disk: QPS at 1/2/4 threads {report['qps_vs_threads']}, 1 thread rewarmed "
        f"{report['qps_1thread_rewarmed']}; eval {report['eval']}")

    # every shard built and stitched, each build's launches checked above;
    # the whole run launched the gathered dots and nothing else
    if len(shards) != clusters or report.get("shards_built") != clusters:
        fail(f"{len(shards)} shard builds, report {report.get('shards_built')}, expected {clusters}")
    check_counts("disk (scale_bench)", run_launches, {
        **zero, "gather_dot": sum(s["gather_dot"] for s in shards),
        "gather_gram": sum(s["gather_gram"] for s in shards)}, 1)
    shard_dir = os.path.join(wd, "shards")
    for s in range(clusters):
        if not os.path.exists(os.path.join(shard_dir, f"shard_{s}.graph")):
            fail(f"shard {s} has no graph file")
    (shard_outputs, n_merged), (vertices, node_shards) = kept["merge"][0], kept["merge"][1]
    for header, adj in shard_outputs:
        m = header.max
        if len(adj) != m or not 0 <= header.medioid < m or len(header.mapping) != m:
            fail(f"shard {header.id}: {len(adj)} rows, max {m}, medioid {header.medioid}")
        flat = np.concatenate(adj)
        if flat.size and flat.max() >= m:
            fail(f"shard {header.id}: base->query edges after the stitch")
    assignment = np.load(os.path.join(wd, "assignment.npy"))
    sizes = np.bincount(assignment.ravel(), minlength=clusters)
    balance = {"max_over_ideal": float(sizes.max() / (2 * n / clusters)),
               "p95_over_median": float(np.percentile(sizes, 95) / np.median(sizes))}

    # the merged adjacency: ids in range, no self-edges, no duplicates,
    # every node with an edge and in two distinct shards
    rows, cnt = vertices.rows, vertices.counts
    live = np.arange(rows.shape[1])[None, :] < cnt[:, None]
    ids = np.where(live, rows, -1)
    srt = np.sort(ids, axis=1)
    merged_ok = {
        "n": int(n_merged == n == len(cnt)),
        "in_range": int((ids[live] >= 0).all() and (ids[live] < n).all()),
        "no_self_edges": int(not (ids == np.arange(n)[:, None]).any()),
        "no_duplicates": int(not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()),
        "min_degree": int(cnt.min()),
        "two_shards": int((node_shards.counts == 2).all()
                          and (node_shards.rows[:, 0] != node_shards.rows[:, 1]).all()),
    }
    degree = {"mean": float(cnt.mean()), "max": int(cnt.max()), "cap": int(rows.shape[1])}
    del live, ids, srt
    log(f"disk: merged adjacency {merged_ok}, degree {degree}; top-2 split max/ideal "
        f"{balance['max_over_ideal']:.3f}, p95/median {balance['p95_over_median']:.3f}")
    if not all(merged_ok.values()):
        fail(f"merged adjacency malformed: {merged_ok}")

    # the index: header counts, the dead records counted by a scan of every
    # record, and 4,096 records against the flat corpus and the merge
    index_dir = os.path.join(wd, "index")
    idx = DiskIndex(index_dir)
    pad = idx.header.record_pad_size
    recs = np.memmap(os.path.join(index_dir, "index.bin"), np.uint8, "r", shape=(n, pad))
    dead_pat, dead, longest = b"\xa3url\xa0", set(), 0
    for s0 in range(0, n, 65536):
        blob = recs[s0 : s0 + 65536].tobytes()
        lens = np.frombuffer(blob, "<u4")[:: pad // 4]
        longest = max(longest, int(lens.max()))
        pos = blob.find(dead_pat)
        while pos >= 0:
            dead.add(s0 + pos // pad)
            pos = blob.find(dead_pat, pos + 1)
    dead = {i for i in dead if PackedIndexEntry.unpack(bytes(recs[i])).url == ""}
    flat = np.memmap(os.path.join(wd, "vectors.f16"), np.float16, "r", shape=(n, d))
    sample = np.linspace(0, n - 1, 4096).astype(np.int64)
    bad = []
    for i, e in zip(sample.tolist(), idx.read_nodes(sample.tolist())):
        if (e.id != i or not np.array_equal(e.vector.astype(np.float16), flat[i])
                or list(e.vertices) != vertices[i].tolist() or list(e.shards) != node_shards[i].tolist()
                or e.url not in ("", f"https://cdn.example.com/{i}.png")):
            bad.append(i)
    log(f"disk: index.msgpack counts {idx.header.count} records, {idx.header.dead_count} dead; "
        f"the scan finds {len(dead)} dead, the longest payload {longest} B of {pad}; "
        f"{len(sample) - len(bad)} of {len(sample)} sampled records equal the corpus and the merge")
    if idx.header.count != n or idx.header.dead_count != len(dead) or longest > pad - 4 or bad:
        fail(f"index: count {idx.header.count}, dead {idx.header.dead_count} against {len(dead)}, "
             f"longest {longest}, records differing {bad[:8]}")
    del recs, flat

    # the native beam search against the numpy loop on 16 of the serve queries
    if idx._nav is None:
        fail("the disk index opened without NativeNav")
    _supers, fines = scale_bench._hier_centers(n)
    qrng = np.random.default_rng(1234)
    qs = scale_bench._hier_points(fines, qrng.integers(0, len(fines), 256), qrng)
    idx_py = DiskIndex(index_dir, io_backend=PythonReader(os.path.join(index_dir, "index.bin"), pad))
    native_gap, t_nat, t_py = 0.0, 0.0, 0.0
    for qi in range(16):
        kw = dict(beamwidth=beamwidth, search_list=search_list, dedup=bool(qi % 2))
        t0 = time.perf_counter()
        rn, cn = idx.search(qs[qi], k, **kw)
        t1 = time.perf_counter()
        rp, cp = idx_py.search(qs[qi], k, **kw)
        t_nat, t_py = t_nat + t1 - t0, t_py + time.perf_counter() - t1
        if [x.id for x in rn] != [x.id for x in rp] or (cn.node_reads, cn.pq_comparisons) != (
                cp.node_reads, cp.pq_comparisons):
            fail(f"query {qi}: the native search and the numpy loop disagree")
        native_gap = max(native_gap, float(np.abs(np.subtract([x.score for x in rn],
                                                                [x.score for x in rp])).max()))
    log(f"disk: 16 queries, native search equal to the numpy loop (ids, counters; largest score "
        f"gap {native_gap:.2e}); {t_nat / 16 * 1e3:.2f} ms against {t_py / 16 * 1e3:.1f} ms a query")
    if native_gap > NATIVE_SCORE_TOL:
        fail(f"native and numpy scores differ by {native_gap}")
    del idx_py

    ev = report["eval"]
    if not ev["recall_at_20"] >= DISK_MIN_RECALL:
        fail(f"eval recall@20 {ev['recall_at_20']} below {DISK_MIN_RECALL}")

    # where the served recall goes, over the eval queries: whether the
    # start shard (the k-means) holds each query's true top 20, and the
    # same beam search with exact scores on its frontier in place of the
    # OPQ's ADC (the graph alone)
    oracle = np.load(os.path.join(wd, "eval_oracle.npz"))
    flat = np.memmap(os.path.join(wd, "vectors.f16"), np.float16, "r", shape=(n, d))
    idx_exact = DiskIndex(index_dir, io_backend=PythonReader(os.path.join(index_dir, "index.bin"), pad))
    parts = {"served": [0, 0], "exact_frontier": [0, 0]}  # hits in the top 20, first answers past 1000
    in_start = 0
    for q, gt in zip(oracle["queries"], oracle["gt"]):
        in_start += int((assignment[gt[:k]] == idx.select_shard(q)).any(axis=1).sum())
        idx_exact._adc = lambda _lut, ids, q=q: flat[ids].astype(np.float32) @ q
        for key, index in (("served", idx), ("exact_frontier", idx_exact)):
            res, _c = index.search(q, k, beamwidth=beamwidth, search_list=search_list, dedup=False)
            parts[key][0] += len({x.id for x in res} & set(gt[:k].tolist()))
            parts[key][1] += int(not res or res[0].id not in gt)
    n_eval = len(oracle["queries"])
    breakdown = {"queries": n_eval, "top20_in_start_shard": in_start / (n_eval * k), **{
        key: {"recall_at_20": h / (n_eval * k), "first_answer_past_1000": m} for key, (h, m) in parts.items()}}
    log(f"disk: recall breakdown over {n_eval} eval queries: {breakdown}")
    if round(breakdown["served"]["recall_at_20"], 4) != ev["recall_at_20"]:
        fail(f"served recall {breakdown['served']} against the report's {ev}")
    del idx_exact, flat

    # the disk query server over HTTP, with the engine's text tower as its
    # in-process embedder: 1, 7 and 16 concurrent text queries, then one
    # fused query; the launches counted over the requests alone
    from aiohttp.test_utils import TestClient, TestServer

    from meme_search_engine_tpu_torch.serving.disk_query_server import make_app

    embedder = InProcessEmbedder(engine)
    words = ["meme", "cat", "dog", "gpu", "tpu", "funny", "sad", "frog", "reaction", "image"]
    trng = np.random.default_rng(11)

    def text():
        return " ".join(trng.choice(words, size=trng.integers(1, 12)))

    rounds = [[text() for _ in range(c)] for c in (1, 7, 16)]
    fused_terms = [(text(), 1.0), (text(), 0.5), (text(), -1.0)]
    app = make_app(idx, embedder, beamwidth=beamwidth, search_list=search_list)

    async def drive():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            init = await (await client.get("/")).json()
            answers = []
            for texts in rounds:
                resps = await asyncio.gather(*[
                    client.post("/", json={"terms": [{"text": t}], "k": k}) for t in texts])
                answers.append([await rsp.json() for rsp in resps])
            rsp = await client.post("/", json={
                "terms": [{"text": t, "weight": w} for t, w in fused_terms], "k": k})
            return init, answers, await rsp.json()
        finally:
            await client.close()

    reset_counts()
    t0 = time.perf_counter()
    init, answers, fused = asyncio.run(drive())
    server_s = time.perf_counter() - t0
    n_buckets = sum(len(pow2_buckets(c, engine.max_batch)) for c in [1] * 24 + [len(fused_terms)])
    server_launches = launch_counts()
    check_counts("disk (server)", server_launches, {**zero, "fused_mha": cfg.text_depth}, n_buckets)
    if init != {"n_total": n - idx.header.dead_count, "predefined_embedding_names":
                ["Useful", "Meme", "Aesthetic", "Time"], "d_emb": d}:
        fail(f"frontend init {init}")

    loop = asyncio.new_event_loop()

    def direct(qvec):
        res, _c = idx.search(qvec, k, beamwidth=beamwidth, search_list=search_list)
        return [x.id for x in res if x.url], [x.score for x in res if x.url]

    def served(body):
        ms = body["matches"]
        return [int(m_[1].rsplit("/", 1)[1].split(".")[0]) for m_ in ms], [m_[0] for m_ in ms]

    server_gap = 0.0
    pairs = [([t], [1.0], a) for texts, ans in zip(rounds, answers) for t, a in zip(texts, ans)]
    pairs.append(([t for t, _ in fused_terms], [w for _, w in fused_terms], fused))
    for texts, weights, body in pairs:
        embs = loop.run_until_complete(embedder.embed_texts(texts))
        qvec = np.zeros((d,), np.float32)
        qvec += np.einsum("nd,n->d", embs, np.asarray(weights, np.float32))
        (want, want_s), (got, got_s) = direct(qvec), served(body)
        if got != want or len(got) != k:
            fail(f"server answer for {texts} {got[:5]}... differs from DiskIndex.search {want[:5]}...")
        server_gap = max(server_gap, float(np.abs(np.subtract(got_s, want_s)).max()))
    log(f"disk: the server answered 1, 7 and 16 concurrent text queries and a fused one (weights 1, "
        f"0.5, -1) in {server_s:.1f} s, {n_buckets} text buckets, each answer's {k} ids equal to "
        f"DiskIndex.search on its fused vector (largest score gap {server_gap:.2e})")

    # one text query at a time, 64 of them: the text tower at B = 1 (with
    # the embedder's fp16 round trip), then the beam search
    embed_ms, search_ms = [], []
    for _ in range(64):
        t0 = time.perf_counter()
        e = loop.run_until_complete(embedder.embed_texts([text()]))[0]
        t1 = time.perf_counter()
        idx.search(e, k, beamwidth=beamwidth, search_list=search_list)
        embed_ms.append((t1 - t0) * 1e3)
        search_ms.append((time.perf_counter() - t1) * 1e3)
    loop.close()
    total_ms = np.add(embed_ms, search_ms)
    latency = {part: {"p50": float(np.percentile(v, 50)), "p99": float(np.percentile(v, 99))}
               for part, v in (("total_ms", total_ms), ("embed_ms", embed_ms), ("search_ms", search_ms))}
    log(f"disk: single text query (64, host clock): " + ", ".join(
        f"{part} p50 {v['p50']:.2f} p99 {v['p99']:.2f}" for part, v in latency.items()))

    checks = shard0_checks(dev, shard0, r, l, maxc, batch)
    phase_s = time.perf_counter() - t_phase
    log(f"disk: the phase took {phase_s:.1f} s")
    return {
        "n": n, "d": d, "clusters": clusters,
        "cut": None if n >= 1_000_000 else DISK_CUT if n == DISK_N else f"n 1e6 -> {n}",
        "search_list": search_list,
        "beamwidth": beamwidth, "tool_s": tool_s, "stages_s": stage_s, "lease": lease,
        "shard_build_s": {"min": min(build_walls), "median": float(np.median(build_walls)),
                          "max": max(build_walls), "sum": float(sum(build_walls))},
        "shards": shards, "balance": balance, "merged": merged_ok, "degree": degree,
        "count": idx.header.count, "dead": idx.header.dead_count, "longest_payload": longest,
        "launches": run_launches, "peak_gib": peak, "qps_vs_threads": report["qps_vs_threads"],
        "qps_1thread_rewarmed": report["qps_1thread_rewarmed"], "eval": ev, "recall_breakdown": breakdown,
        "native_vs_numpy_max_score_gap": native_gap, "server_s": server_s,
        "server_text_buckets": n_buckets, "server_launches": server_launches,
        "server_vs_direct_max_score_gap": server_gap,
        "single_text_query": latency, "shard0": checks, "phase_s": phase_s,
    }


def shard0_checks(dev, shard0: dict, r: int, l: int, maxc: int, batch: int) -> dict:
    """The disk phase's shard 0, as it was built: its graph's structure,
    its recall by ann_bench's protocol over 512 base rows, one round's
    greedy search and one prune profiled, and 64 nodes searched and pruned
    on the card against the CPU in bf16 and int8."""
    import torch

    from meme_search_engine_tpu_torch.index import vamana
    from meme_search_engine_tpu_torch.ops import mips

    base, queries, graph, med = shard0["base"], shard0["queries"], shard0["graph"], shard0["med"]
    stages, calls = shard0["stages"], shard0["calls"]
    n_base = len(base)
    n_total = n_base + len(queries)

    # structure
    if graph.shape != (n_total, r) or graph.min() < -1 or graph.max() >= n_total:
        fail(f"graph shape {graph.shape}, ids in [{graph.min()}, {graph.max()}]")
    if (graph[:n_base] >= n_base).any():
        fail(f"{int((graph[:n_base] >= n_base).sum())} base->query edges after the stitch")
    degrees = (graph[:n_base] >= 0).sum(axis=1)
    if degrees.min() < 1 or not 0 <= med < n_base:
        fail(f"base degree min {degrees.min()}, medioid {med}")

    # quality, by ann_bench's protocol over 512 base rows
    vectors = np.concatenate([base, queries])
    cfg = vamana.VamanaConfig(r=r, l=l, maxc=maxc, query_breakpoint=n_base)
    sample = np.random.default_rng(1).permutation(n_base)[:512]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _s, ids, steps = vamana.search(vectors, graph, base[sample], 10, cfg, device=dev)
    qps = len(sample) / (time.perf_counter() - t0)
    self_recall = float((ids[:, 0] == sample).mean())
    exact = mips.mips_topk(torch.from_numpy(base.astype(np.float16)).to(dev),
                           torch.from_numpy(base[sample]).to(dev), 10)[1].cpu().numpy()
    recall10 = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / 10 for a, b in zip(ids, exact)]))
    log(f"disk, shard 0: search of {len(sample)} base rows, k 10, L {l}: self-recall@1 {self_recall:.4f}, "
        f"recall@10 {recall10:.4f}, {qps:.1f} QPS, {steps} hops")
    if ids.max() >= n_base:
        fail("search returned an OOD query node")
    if not (self_recall >= 0.95 and recall10 >= 0.80):
        fail(f"graph quality below the floors: self-recall@1 {self_recall}, recall@10 {recall10}")

    # one round's greedy search again under the profiler: the card's time a
    # hop, set against the hop's wall time in the (unprofiled) build, whose
    # difference is the host's launch and sync overhead
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    corpus = vamana._corpus_on_device(vectors, "bf16", dev)
    round_nodes = torch.from_numpy(np.random.default_rng(3).permutation(n_total)[:batch]).to(dev)
    graph_dev = torch.from_numpy(graph).to(dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _ps, _pi, round_hops = vamana._batched_greedy_search(
            corpus, graph_dev, corpus[round_nodes], med, n_base, round_nodes >= n_base,
            l=l, maxc=maxc, max_steps=-(-2 * l // 2), expand=2,
        )
        torch.cuda.synchronize()
        round_wall = time.perf_counter() - t0
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in on_card) / 1e6 if on_card else None
    hop_wall_ms = stages["_batched_greedy_search"] / calls["hops"] * 1e3
    by_name: dict = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    profiled = {"wall_s": round_wall, "hops": round_hops, "device_ops": len(on_card),
                "device_s": busy, "build_hop_wall_ms": hop_wall_ms,
                "device_ms_per_hop": busy / round_hops * 1e3 if on_card else None,
                "top_device_ms_per_hop": {k[:100]: us / round_hops / 1e3 for k, us in top}}
    log(f"disk, shard 0: one round's greedy search profiled: {round_hops} hops in {round_wall:.3f} s "
        f"(profiled), {len(on_card) / round_hops:.1f} device ops a hop, the card busy "
        + (f"{busy / round_hops * 1e3:.3f} ms a hop against {hop_wall_ms:.3f} ms of wall time a hop "
           f"in the build ({busy / round_hops * 1e3 / hop_wall_ms:.1%})" if on_card
           else "not measured (no device events)"))
    for k, us in top:
        log(f"  {us / round_hops / 1e3:.4f} ms a hop: {k[:100]}")

    # one prune of that round's pools, profiled the same way: the card's
    # time by kernel against the build's wall time a prune
    sat = round_nodes >= n_base
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        vamana._batched_robust_prune(corpus, round_nodes.int(), _pi, _ps, cfg.alpha, cfg.query_alpha,
                                     n_base, sat, r=r)
        torch.cuda.synchronize()
        prune_wall = time.perf_counter() - t0
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    prune_device = sum(by_name.values()) if on_card else None
    prune_build_wall_ms = stages["_batched_robust_prune"] / calls["_batched_robust_prune"] * 1e3
    profiled["prune"] = {"wall_ms": prune_wall * 1e3, "device_ops": len(on_card), "device_ms": prune_device,
                         "build_prune_wall_ms": prune_build_wall_ms,
                         "top_device_ms": {k[:100]: v for k, v in top}}
    log(f"disk, shard 0: one prune of that round's {batch} pools profiled: {prune_wall * 1e3:.2f} ms (profiled), "
        f"{len(on_card)} device ops, the card busy "
        + (f"{prune_device:.3f} ms; the build's prunes took {prune_build_wall_ms:.2f} ms of wall time "
           f"each" if on_card else "not measured (no device events)"))
    for k, v in top:
        log(f"  {v:.4f} ms: {k[:100]}")
    del corpus, graph_dev, _ps, _pi, prof, sat

    # the card against the CPU: 64 nodes of the finished graph through a
    # greedy search and a prune with the build's parameters, in bf16 and in
    # int8; the CPU's prune runs once more on the card's pools
    nodes = np.sort(np.random.default_rng(2).choice(n_total, 64, replace=False)).astype(np.int32)
    is_q = nodes >= n_base

    def search_prune(c):
        ps, pi, _ = vamana._batched_greedy_search(
            c, torch.from_numpy(graph).to(c.device), c[torch.from_numpy(nodes).to(c.device).long()],
            med, n_base, torch.from_numpy(is_q).to(c.device),
            l=l, maxc=maxc, max_steps=-(-2 * l // 2), expand=2,
        )
        return ps.cpu(), pi.cpu(), prune(c, pi, ps)

    def prune(c, pi, ps):
        return vamana._batched_robust_prune(
            c, torch.from_numpy(nodes).to(c.device), pi.to(c.device), ps.to(c.device), cfg.alpha,
            cfg.query_alpha, n_base, torch.from_numpy(is_q).to(c.device), r=r,
        ).cpu().numpy()

    def prune_margin(c, node, ids, scores):
        """Smallest |alpha_c dot(c, p*) - score(c)| over the live candidates
        at each pick of one node's prune, in fp32 on the CPU as the prune:
        how near its closest decision came to flipping."""
        ok = ids != vamana.INVALID
        v = c[torch.from_numpy(np.where(ok, ids, 0)).long()].float()
        pair = (v @ v.T).numpy()
        alpha = np.where(ids >= n_base, np.float32(cfg.query_alpha), np.float32(cfg.alpha))
        alive = ok & (ids != node)
        margin = np.inf
        for _ in range(r):
            if not alive.any():
                break
            pick = int(np.argmax(alive))
            dom = alpha * pair[pick] - scores
            margin = min(margin, float(np.abs(dom[alive]).min()))
            alive &= dom < 0
            alive[pick] = False
        return margin

    agreement = {}
    for dtype in ("bf16", "int8"):
        card = vamana._corpus_on_device(vectors, dtype, dev)
        host = card.cpu()
        t0 = time.perf_counter()
        cs, ci, cp = search_prune(card)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        hs, hi, hp = search_prune(host)
        hp_same = prune(host, ci, cs)
        t_cpu = time.perf_counter() - t0
        del card
        cs, ci, hs, hi = cs.numpy(), ci.numpy(), hs.numpy(), hi.numpy()
        finite = np.isfinite(cs) | np.isfinite(hs)
        differs = ~(cp == hp).all(axis=1) | ~(cp == hp_same).all(axis=1)
        margins = [prune_margin(host, nodes[i], ci[i], cs[i]) for i in np.flatnonzero(differs)]
        a = {
            "pool_ids_equal": float((ci == hi).mean()),
            "pools_differing": int((~(ci == hi).all(axis=1)).sum()),
            "max_score_gap": float(np.abs(cs[finite] - hs[finite]).max(initial=0.0)),
            "pruned_rows_equal": float((cp == hp).all(axis=1).mean()),
            "pruned_rows_equal_on_the_cards_pools": float((cp == hp_same).all(axis=1).mean()),
            "differing_rows_min_margin": margins,
        }
        agreement[dtype] = a
        log(f"disk, shard 0: card vs CPU, {dtype}, 64 nodes (card {t_card:.1f} s, CPU {t_cpu:.1f} s): pool ids "
            f"equal on {a['pool_ids_equal']:.6f} of {ci.size} ({a['pools_differing']} pools differ "
            f"somewhere), largest score gap {a['max_score_gap']:.2e}; pruned rows equal on "
            f"{a['pruned_rows_equal']:.4f}, on the card's pools {a['pruned_rows_equal_on_the_cards_pools']:.4f}; "
            f"smallest decision margin of each differing row {margins}")
        ok = (a["pool_ids_equal"] >= 0.99 and a["max_score_gap"] <= 1e-5
              and bool((np.isinf(cs) == np.isinf(hs)).all()) and all(m <= 1e-5 for m in margins))
        if dtype == "int8":  # exact integer sums: nothing may differ
            ok = ok and a["pool_ids_equal"] == 1.0 and not differs.any()
        if not ok:
            fail(f"card and CPU disagree beyond near ties ({dtype}): {a}")

    rounds = -(-n_total // batch)
    return {
        "n_base": n_base, "n_total": n_total, "wall_s": shard0["wall"], "stages_s": stages,
        "rounds": rounds, "hops": calls["hops"], "prunes": calls["_batched_robust_prune"],
        "reprune_chunks": calls.get("_score_sort_prune", 0), "launches": shard0["launches"],
        "self_recall@1": self_recall, "recall@10": recall10, "qps": qps, "search_hops": steps,
        "profiled_round": profiled, "card_vs_cpu_64_nodes": agreement, "medioid": med,
    }


def service(engine, dev, reset_counts, launch_counts, check_counts,
            n: int = SERVICE_N, n_images: int = SERVICE_IMAGES) -> dict:
    """The small-scale deployment, a personal meme library of about 1e5
    items (SURVEY §1), on the engine of phase 4 through the service's
    ``InProcessEmbedder``: ``n_images`` images embedded by the engine and
    the rest unit-norm fp16 rows from a seed, written to the SQLite state
    as ``IngestService.ingest`` writes them; ``build_index`` and the
    handle's swap (the second half of ``reload()``: its folder scan would
    delete these rows); concurrent raw queries through the
    ``SearchBatcher`` against the CPU's exact top-k; fused text queries;
    an ingested image found by its stored embedding; then the times.
    Returns the ``service`` JSON object."""
    import asyncio
    import tempfile

    import torch

    from meme_search_engine_tpu_torch.ingest.db import IngestDB
    from meme_search_engine_tpu_torch.ingest.filename import Actual, encode_filename
    from meme_search_engine_tpu_torch.ingest.pipeline import IngestService
    from meme_search_engine_tpu_torch.ops import mips
    from meme_search_engine_tpu_torch.serving.client import InProcessEmbedder
    from meme_search_engine_tpu_torch.serving.engine import pow2_buckets
    from meme_search_engine_tpu_torch.serving.query_server import (
        DEFAULT_K, SearchBatcher, format_results, fuse_query_terms)
    from meme_search_engine_tpu_torch.serving.wire import QueryRequest, QueryTerm

    cfg = engine.cfg
    d, r = cfg.d_emb, cfg.image_size
    t_phase = time.perf_counter()
    loop = asyncio.new_event_loop()
    run = loop.run_until_complete
    with tempfile.TemporaryDirectory() as tmp:
        files = os.path.join(tmp, "memes")
        os.makedirs(files)
        config = {"files": files, "db_path": os.path.join(tmp, "state.db"), "device": str(dev)}
        embedder = InProcessEmbedder(engine)
        svc = IngestService(config, IngestDB(config["db_path"]), embedder)
        db, batch = svc.db, embedder.config.batch
        mtime_us = int(time.time() * 1e6)

        def write(name, emb, meta):
            fn = encode_filename(Actual(name))
            db.stage_file(fn, mtime_us, want_ocr=False, want_thumbs=False)
            db.write_embedding(fn, emb)
            db.write_metadata(fn, meta)

        # the images, in the embedder's batches, with its fp16 round trip
        rng = np.random.default_rng(5)
        reset_counts()
        t0 = time.perf_counter()
        img_embs = []
        for s in range(0, n_images, batch):
            imgs = rng.integers(0, 256, (min(batch, n_images - s), r, r, 3), dtype=np.uint8)
            embs = engine.embed_image_arrays(imgs).astype(np.float16)
            for j, e in enumerate(embs):
                write(f"img/{s + j}.png", e, {"dimension": [r, r]})
            db.commit()
            img_embs.append(embs)
        t_embed = time.perf_counter() - t0
        img_embs = np.concatenate(img_embs).astype(np.float32)
        n_img_buckets = sum(len(pow2_buckets(min(batch, n_images - s), engine.max_batch))
                            for s in range(0, n_images, batch))
        check_counts("service (images)", launch_counts(), {
            "ln_matmul": cfg.depth + 1, "matmul_residual": cfg.depth, "ln_mlp_residual": cfg.depth,
            "fat_vit_mha": cfg.depth, "fused_mha": 0, "fat_vit_mha_packed_proj": 0,
            "adc_scores": 0, "gather_rows": 0, "gather_dot": 0, "gather_gram": 0,
        }, n_img_buckets)
        srng = np.random.default_rng(6)
        syn = srng.standard_normal((n - n_images, d), dtype=np.float32)
        syn = (syn / np.linalg.norm(syn, axis=1, keepdims=True)).astype(np.float16)
        t0 = time.perf_counter()
        for i, e in enumerate(syn):
            write(f"syn/{i}.jpg", e, {})
        db.commit()
        t_fill = time.perf_counter() - t0
        log(f"service: {n_images} images embedded and written in {t_embed:.1f} s, "
            f"{len(syn)} more rows written in {t_fill:.1f} s")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = svc.build_index()
        svc.handle.swap(index)
        torch.cuda.synchronize()
        t_reload = time.perf_counter() - t0
        if len(index) != n or index.vectors.device.type != dev.type or index.vectors.dtype != torch.float16:
            fail(f"index of {len(index)} rows, {index.vectors.dtype} on {index.vectors.device}")
        log(f"service: build_index + swap of {n} rows in {t_reload:.2f} s")

        # 64 concurrent raw queries at k = DEFAULT_K in fewer device calls,
        # against the CPU's exact top-k over the same fp16 rows
        reset_counts()
        batcher = SearchBatcher(svc.handle)
        qs = srng.standard_normal((64, d), dtype=np.float32)
        qs /= np.linalg.norm(qs, axis=1, keepdims=True)
        calls = []
        real_search = index.search

        def counting_search(queries, k):
            calls.append((len(queries), k))
            return real_search(queries, k)

        index.search = counting_search

        async def concurrent():
            return await asyncio.gather(*[batcher.search(q, DEFAULT_K) for q in qs])

        hits = run(concurrent())
        del index.search
        corpus = index.vectors.cpu()
        cpu_s, cpu_i = (t.numpy() for t in mips.mips_topk(corpus, torch.from_numpy(qs), DEFAULT_K))
        full = mips.exact_scores(corpus, torch.from_numpy(qs)).numpy()
        gap, moved = 0.0, 0
        for row, (s, ids, snap) in enumerate(hits):
            if snap is not index or s.shape != (DEFAULT_K,) or ids.shape != (DEFAULT_K,):
                fail(f"query {row}: answer of shape {s.shape} from another index")
            gap = max(gap, float(np.abs(s - cpu_s[row]).max()))
            diff = np.flatnonzero(ids != cpu_i[row])
            moved += len(diff)
            # an id may differ only where the card put a near tie: its exact
            # score within NEAR_TIE_SEARCH of the CPU's score at that rank
            if len(diff) and np.abs(full[row, ids[diff]] - cpu_s[row, diff]).max() > NEAR_TIE_SEARCH:
                fail(f"query {row}: ids differ from the CPU's top-{DEFAULT_K} beyond near ties")
        log(f"service: 64 concurrent k={DEFAULT_K} queries in {len(calls)} device calls "
            f"{calls}; largest score gap to the CPU {gap:.2e}, {moved} ids moved within near ties")
        if not len(calls) < 64 or gap > NEAR_TIE_SEARCH:
            fail(f"search batching or scores: {len(calls)} calls, score gap {gap}")

        # fused text queries: weights 1, 0.5 and -1, text and raw terms
        raw = syn[7].astype(np.float32)
        texts = ["a cat reacting to a gpu", "funny dog"]
        req = QueryRequest(terms=[QueryTerm(text=texts[0]), QueryTerm(text=texts[1], weight=0.5),
                                  QueryTerm(embedding=raw.tolist(), weight=-1.0)], k=20)
        qvec = run(fuse_query_terms(req, embedder, d, svc.predefined_embeddings))
        embs = run(embedder.embed_texts(texts))  # the terms as the fusion embeds them
        fuse_err = float(np.abs(qvec - (embs[0] + 0.5 * embs[1] - raw)).max())
        s, ids, snap = run(batcher.search(qvec, min(req.k, len(index))))
        res = format_results(snap, s, ids, req)
        scores = [m[0] for m in res.matches]
        log(f"service: fused text query: |fused - weighted sum| {fuse_err:.2e}; top {len(scores)} "
            f"from {res.matches[0][1]} at {scores[0]:.4f} to {scores[-1]:.4f}")
        if fuse_err > NEAR_TIE_SEARCH or len(res.matches) != 20 or scores != sorted(scores, reverse=True):
            fail(f"fused query: error {fuse_err}, {len(res.matches)} matches")

        # an ingested image found by its stored embedding: the one whose
        # nearest other image lies farthest
        sims = img_embs @ img_embs.T
        margins = np.diag(sims) - np.where(np.eye(n_images, dtype=bool), -np.inf, sims).max(1)
        pick = int(np.argmax(margins))
        req = QueryRequest(terms=[QueryTerm(embedding=img_embs[pick].tolist())], k=10)
        qvec = run(fuse_query_terms(req, embedder, d, svc.predefined_embeddings))
        s, ids, snap = run(batcher.search(qvec, min(req.k, len(index))))
        top = format_results(snap, s, ids, req).matches[0]
        log(f"service: image {pick} by its stored embedding (margin to its nearest other image "
            f"{margins[pick]:.3e}, smallest margin {margins.min():.3e}): first hit {top[1]} at "
            f"{top[0]:.4f}, dims {top[4]}")
        if top[1] != f"img/{pick}.png" or tuple(top[4]) != (r, r):
            fail(f"self-retrieval of img/{pick}.png gave {top}")

        # times: the search alone (host clock around FlatIndex.search, which
        # ends in the copy to the host; and the card's time of its mips_topk),
        # and one single-text query end to end
        qdev = torch.from_numpy(qs).to(dev)
        search_ms, mips_ms = {}, {}
        for b in (1, 16):
            index.search(qs[:b], DEFAULT_K)
            ts = []
            for _ in range(20):
                t0 = time.perf_counter()
                index.search(qs[:b], DEFAULT_K)
                ts.append((time.perf_counter() - t0) * 1e3)
            search_ms[b] = float(np.median(ts))
            mips_ms[b] = time_ms(lambda: mips.mips_topk(index.vectors, qdev[:b], DEFAULT_K), reps=20)
        bound_ms = n * d * 2 / PEAK_BW * 1e3

        async def one_query(parts):
            """One single-text query as the POST handler runs it; appends
            the host ms of its fusion (the text tower at B = 1), its
            batched search and its formatting to ``parts``."""
            t0 = time.perf_counter()
            req = QueryRequest(terms=[QueryTerm(text="a frog meme")])
            qvec = await fuse_query_terms(req, embedder, d, svc.predefined_embeddings)
            t1 = time.perf_counter()
            s, ids, snap = await batcher.search(qvec, min(req.k or DEFAULT_K, len(index)))
            t2 = time.perf_counter()
            res = format_results(snap, s, ids, req)
            parts.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3))
            return res

        run(one_query([]))
        ts, parts = [], []
        for _ in range(20):
            t0 = time.perf_counter()
            res = run(one_query(parts))
            ts.append((time.perf_counter() - t0) * 1e3)
        query_ms = float(np.median(ts))
        query_parts = dict(zip(("fuse_ms", "search_ms", "format_ms"), np.median(parts, axis=0).tolist()))
        if len(res.matches) != DEFAULT_K:
            fail(f"a single-text query gave {len(res.matches)} matches")

        # one B = 1 search under the profiler: the card's time by kernel
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            index.search(qs[:1], DEFAULT_K)
            prof_wall = (time.perf_counter() - t0) * 1e3
        on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_name: dict = {}
        for e in on_card:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        profiled = {"wall_ms": prof_wall, "device_ops": len(on_card),
                    "device_ms": sum(by_name.values()) if on_card else None,
                    "top_device_ms": {k[:100]: v for k, v in top}}
        log(f"service: one B=1 search profiled: {len(on_card)} device ops, the card busy "
            + (f"{profiled['device_ms']:.3f} ms of {prof_wall:.3f} ms (profiled)" if on_card
               else "not measured (no device events)"))
        for k, v in top:
            log(f"  {v:.4f} ms: {k[:100]}")
        text_buckets = 2 + 21  # the fused query, its terms again, the timed queries
        check_counts("service (queries)", launch_counts(), {
            "fused_mha": cfg.text_depth, "ln_matmul": 0, "matmul_residual": 0,
            "ln_mlp_residual": 0, "fat_vit_mha": 0, "fat_vit_mha_packed_proj": 0,
            "adc_scores": 0, "gather_rows": 0, "gather_dot": 0, "gather_gram": 0,
        }, text_buckets)
        log(f"service: FlatIndex.search at k={DEFAULT_K}: B=1 {search_ms[1]:.3f} ms, B=16 "
            f"{search_ms[16]:.3f} ms (host clock, median of 20); its mips_topk on the card "
            f"{mips_ms[1]:.3f} and {mips_ms[16]:.3f} ms against a bound of {bound_ms:.4f} ms "
            f"(bytes); one single-text query end to end {query_ms:.2f} ms (median of 20, "
            f"from {min(ts):.2f} to {max(ts):.2f}; medians of its parts: "
            + ", ".join(f"{k} {v:.2f}" for k, v in query_parts.items()) + ")")
        db.conn.close()
    loop.close()
    phase_s = time.perf_counter() - t_phase
    log(f"service: the phase took {phase_s:.1f} s")
    return {
        "n": n, "d": d, "images": n_images, "embed_s": t_embed, "fill_s": t_fill,
        "reload_s": t_reload, "search_calls_for_64": len(calls), "search_batches": calls,
        "max_score_gap": gap, "ids_moved_within_near_ties": moved, "fuse_err": fuse_err,
        "self_retrieval_margin": float(margins[pick]),
        "search_ms": {"b1": search_ms[1], "b16": search_ms[16]},
        "mips_device_ms": {"b1": mips_ms[1], "b16": mips_ms[16]},
        "bound_ms": bound_ms, "bound_by": "bytes", "k": DEFAULT_K,
        "single_text_query_ms": query_ms, "single_text_query_parts": query_parts,
        "search_b1_profiled": profiled, "phase_s": phase_s,
    }


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_flops(cfg, b: int) -> float:
    """A train step's operations: 3 x the forward's (the backward's two
    products a forward product), the forward counted from the shapes: the
    dense layers' 2 x rows x d_in x d_out, attention's Q.K^T and P.V, 2 x
    B x H x Sq x Sk x dh each, and the loss's B x B logits."""
    def tower(rows, s, n_seq, d, m, depth):
        dense = 2 * rows * (4 * d * d + 2 * d * m)
        attn = 2 * 2 * n_seq * s * s * d
        return depth * (dense + attn)

    d, m, s = cfg.width, cfg.mlp_dim, cfg.num_patches
    img = tower(b * s, s, b, d, m, cfg.depth)
    img += 2 * b * s * (cfg.patch_size ** 2 * 3) * d  # patch embedding
    img += 2 * b * s * 2 * d * d + 2 * 2 * b * s * d + 2 * b * (2 * d * d + 2 * d * m)  # MAP head
    ts, td, tm = cfg.text_len, cfg.text_width, cfg.text_mlp_dim
    txt = tower(b * ts, ts, b, td, tm, cfg.text_depth) + 2 * b * td * cfg.d_emb
    return 3.0 * (img + txt + 2 * b * b * cfg.d_emb)


def train(engine_cfg, dev, launch_counts, reset_counts) -> dict:
    """The SigLIP train step on a 1 x 1 mesh (NCCL on the card, world size
    1), then the checkpoint and the trained weights served. Returns the
    ``train`` JSON object.

    1. SO400M widths at depth 2 for both towers, bf16 params from seed 0
       on the host, 4 pairs at 384 px: one ``make_train_step`` on the card
       and the same on the CPU (a gloo mesh over the same group): the loss
       within 2e-2 relative, each leaf's gradient finite with cosine >=
       0.99 (the k biases', zero in exact arithmetic, within 1e-3 of the
       largest gradient instead), and the share of updated entries that
       differ by more than one bf16 ulp + lr, logged.
    2. SO400M at full depth, B = 8 pairs, 5 steps: each step's ms (CUDA
       events), the peak memory, finite losses, params that moved, and no
       kernel launched (the train route is the plain one).
    3. The state saved and restored into a fresh one (params and moments
       equal), then the trained tree served by an ``EmbeddingEngine``
       through the kernels, against the plain route on 4 images (cos >=
       0.999).
    """
    import dataclasses
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from meme_search_engine_tpu_torch.models import siglip
    from meme_search_engine_tpu_torch.ops.attention import mha_xla
    from meme_search_engine_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
    from meme_search_engine_tpu_torch.parallel.mesh import make_mesh, tree_flat, tree_leaves, tree_map
    from meme_search_engine_tpu_torch.parallel.train import make_train_state, make_train_step
    from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine

    t_phase = time.perf_counter()
    lr = 1e-4
    port = free_port()
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, device=dev)
        mesh_cpu = make_mesh(1, 1, device="cpu")
        out: dict = {"mesh": mesh.shape, "backend": dist.get_backend(), "lr": lr}

        # 1. card against CPU at SO400M widths, depth 2
        cfg2 = dataclasses.replace(engine_cfg, depth=2, text_depth=2)
        whole = siglip.init_params(cfg2, torch.Generator().manual_seed(0), "cpu")
        rng = np.random.default_rng(0)
        r = cfg2.image_size
        images = torch.from_numpy(rng.uniform(-1, 1, (4, r, r, 3)).astype(np.float32))
        tokens = torch.from_numpy(rng.integers(0, cfg2.vocab_size, (4, cfg2.text_len)).astype(np.int32))
        steps = {}
        for name, m in (("card", mesh), ("cpu", mesh_cpu)):
            t0 = time.perf_counter()
            params, opt, state = make_train_state(0, cfg2, m, lr, params=whole)
            _, _, loss = make_train_step(cfg2, m, opt)(params, state, images, tokens)
            grads = {k: v.grad.float().cpu() for k, v in tree_flat(params).items()}
            after = {k: v.detach().float().cpu() for k, v in tree_flat(params).items()}
            steps[name] = (float(loss), grads, after)
            log(f"train: depth-2 step on the {name} in {time.perf_counter() - t0:.1f} s, "
                f"loss {float(loss):.6f}")
            del params, opt, state
        (l_card, g_card, p_card), (l_cpu, g_cpu, p_cpu) = steps["card"], steps["cpu"]
        loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
        scale = max(float(g.abs().max()) for g in g_cpu.values())
        coss, worst = {}, (None, 2.0)
        for k, gc in g_cpu.items():
            gk = g_card[k]
            if not bool(gk.isfinite().all()):
                fail(f"train: gradient of {k} on the card is not finite")
            if k in siglip.ZERO_GRAD_LEAVES:  # zero in exact arithmetic: rounding noise on both
                if max(float(gk.abs().max()), float(gc.abs().max())) > 1e-3 * scale:
                    fail(f"train: gradient of {k} should be about zero")
                continue
            coss[k] = float((gk * gc).sum() / (gk.norm() * gc.norm()))
            if coss[k] < worst[1]:
                worst = (k, coss[k])
        ulp_share = {}
        moved_apart = 0
        total = 0
        for k, pc in p_cpu.items():
            ulp = 2.0 ** (torch.floor(torch.log2(pc.abs().clamp_min(1e-30))) - 7)
            apart = (p_card[k] - pc).abs() > ulp + lr
            moved_apart += int(apart.sum())
            total += pc.numel()
            ulp_share[k] = float(apart.float().mean())
        share = moved_apart / total
        log(f"train: card vs CPU at depth 2: loss {l_card:.6f} / {l_cpu:.6f} (rel {loss_rel:.2e}, "
            f"tol 2e-2); gradient cos min {worst[1]:.6f} ({worst[0]}) over {len(coss)} leaves; "
            f"updated params apart by more than one bf16 ulp + lr: {share:.2e} of {total}")
        if not loss_rel <= 2e-2 or not worst[1] >= 0.99:
            fail(f"train: card and CPU steps disagree: loss rel {loss_rel}, grad cos {worst}")
        out["check_depth2"] = {"loss_card": l_card, "loss_cpu": l_cpu, "loss_rel": loss_rel,
                               "grad_cos_min": worst[1], "grad_cos_min_leaf": worst[0],
                               "params_apart_share": share, "batch": 4}
        del steps, g_card, g_cpu, p_card, p_cpu, whole

        # 2. full depth, B = 8, 5 steps
        cfg = engine_cfg
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        params, opt, state = make_train_state(0, cfg, mesh, lr)
        n_params = sum(t.numel() for t in tree_leaves(params))
        step = make_train_step(cfg, mesh, opt)
        b = 8
        images = torch.from_numpy(rng.uniform(-1, 1, (b, r, r, 3)).astype(np.float32))
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, cfg.text_len)).astype(np.int32))
        probe = params["img"]["blocks"]["mlp"]["fc1"]["w"][0, :4, :4].detach().clone()
        reset_counts()
        step_ms, losses = [], []
        for _ in range(5):
            a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            params, state, loss = step(params, state, images, tokens)
            e.record()
            torch.cuda.synchronize()
            step_ms.append(a.elapsed_time(e))
            losses.append(float(loss))
        counts = launch_counts()
        peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
        moved = float((params["img"]["blocks"]["mlp"]["fc1"]["w"][0, :4, :4].detach() - probe).abs().max())
        profiled = profile_step(lambda: step(params, state, images, tokens))
        if profiled["device_ms"] is not None:
            log(f"  the card busy {profiled['device_ms']:.1f} ms a step: "
                f"{profiled['device_ms'] / min(step_ms[1:]):.1%} of the fastest unprofiled step")
        flops = train_flops(cfg, b)
        best = min(step_ms[1:])
        log(f"train: SO400M full depth ({cfg.depth} + {cfg.text_depth} layers, {n_params / 1e9:.4f}e9 "
            f"params), B={b}: step ms {[round(t, 2) for t in step_ms]}, losses {losses}; peak "
            f"{peak:.2f} GiB above the {mem0 / 2**30:.2f} allocated before; {flops / 1e12:.2f} TFLOP "
            f"a step (3 x forward) -> {flops / best / 1e9:.1f} TFLOP/s at the fastest step after the "
            f"first; a probe of fc1.w moved by {moved:.3g}; launches {counts}")
        if not all(np.isfinite(losses)):
            fail(f"train: a loss is not finite: {losses}")
        if not moved > 0:
            fail("train: the params did not change")
        if any(counts.values()):
            fail(f"train: a kernel launched in the train step: {counts}")
        out["full"] = {"depth": cfg.depth, "text_depth": cfg.text_depth, "params": n_params,
                       "batch": b, "steps": 5, "step_ms": step_ms, "losses": losses,
                       "peak_gib": peak, "flops_per_step": flops,
                       "tflops_at_fastest": flops / best / 1e9, "launches": counts,
                       "profiled_step": profiled}

        # 3. checkpoint round trip, then the trained tree through the kernels
        work = os.path.join(ROOT, "build")
        os.makedirs(work, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="train_ckpt_", dir=work)
        try:
            t0 = time.perf_counter()
            save_train_state(tmp, params, state, step=5)
            t_save = time.perf_counter() - t0
            fresh, _, fresh_state = make_train_state(1, cfg, mesh, lr)
            t0 = time.perf_counter()
            fresh, fresh_state, got_step = restore_train_state(tmp, fresh, fresh_state)
            t_restore = time.perf_counter() - t0
            size = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(tmp) for f in fs)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        equal = got_step == 5 and all(
            torch.equal(x, y) for part in ("params", "mu", "nu", "count")
            for x, y in zip(tree_leaves(fresh if part == "params" else getattr(fresh_state, part)),
                            tree_leaves(params if part == "params" else getattr(state, part))))
        log(f"train: checkpoint {size / 2**30:.2f} GiB saved in {t_save:.1f} s, restored in "
            f"{t_restore:.1f} s; restored state equal: {equal}")
        if not equal:
            fail("train: the restored state differs from the saved one")
        del fresh, fresh_state, opt, state
        trained = tree_map(lambda t: t.detach(), params)
        del params
        torch.cuda.empty_cache()
        served = EmbeddingEngine(trained, cfg, max_batch=4, device=dev)
        imgs = rng.integers(0, 256, (4, r, r, 3), dtype=np.uint8)
        reset_counts()
        got = served.embed_image_arrays(imgs)
        serve_counts = launch_counts()
        with torch.inference_mode():
            want = siglip._embed_image(
                trained, siglip.preprocess_image(torch.from_numpy(imgs).to(dev), cfg), cfg,
                attention=mha_xla).cpu().numpy()
        cos = [float(got[i] @ want[i]) for i in range(4)]
        log(f"train: the trained tree served through the kernels against the plain route: cos "
            f"{[round(c, 6) for c in cos]}; launches {serve_counts}")
        expect = {"ln_matmul": cfg.depth + 1, "matmul_residual": cfg.depth,
                  "ln_mlp_residual": cfg.depth, "fat_vit_mha": cfg.depth}
        if any(serve_counts[k] != n for k, n in expect.items()) or not min(cos) >= 0.999:
            fail(f"train: serving the trained tree: cos {cos}, launches {serve_counts}")
        out["checkpoint"] = {"gib": size / 2**30, "save_s": t_save, "restore_s": t_restore,
                             "equal": equal}
        out["served_cos"] = cos
        del served, trained
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"train: the phase took {out['phase_s']:.1f} s")
    return out


def _kernel_kind(name: str) -> str:
    """A device kernel's family by its name: GEMMs (cuBLAS, CUTLASS), the
    fp32 ones on the CUDA cores apart (``f32f32``, ``sgemm``: the plain
    attention's fp32 products), softmax, NCCL, and the rest (elementwise
    passes, reductions, copies)."""
    n = name.lower()
    if any(w in n for w in ("gemm", "xmma", "cutlass", "nvjet")):
        return "gemm fp32 (f32f32, sgemm)" if ("f32f32" in n or "sgemm" in n) else "gemm, other"
    if "softmax" in n:
        return "softmax"
    if "nccl" in n:
        return "nccl"
    return "elementwise, reductions, copies"


def profile_step(fn) -> dict:
    """One call of ``fn`` (a train step) under torch.profiler, summed up
    by ``device_summary``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return device_summary(prof, wall)


def device_summary(prof, wall: float, what: str = "profiled step") -> dict:
    """A finished torch.profiler run of ``wall`` ms: the card's busy time
    (the sum of its kernels' times), that time by kernel family
    (``_kernel_kind``) and the top kernels."""
    from torch.autograd import DeviceType

    # kernels only: a user annotation's range on the card (the optimizer's
    # step, each all-gather) spans kernels already counted
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    by_name: dict = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    by_kind: dict = {}
    for name, ms in by_name.items():
        by_kind[_kernel_kind(name)] = by_kind.get(_kernel_kind(name), 0.0) + ms
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"  {what}: {wall:.1f} ms wall (profiled), {len(on_card)} device ops, the card busy "
        + (f"{busy:.1f} ms ({busy / wall:.1%}); by kind (ms): "
           + ", ".join(f"{k} {v:.1f}" for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1]))
           if on_card else "not measured (no device events)"))
    for k, v in top:
        log(f"    {v:.2f} ms: {k[:110]}")
    return {"wall_ms": wall, "device_ops": len(on_card), "device_ms": busy if on_card else None,
            "device_ms_by_kind": by_kind, "top_device_ms": {k[:110]: v for k, v in top}}


def sharded_search(dev, n: int = SERVICE_N, d: int = 1152, nq: int = 64, k: int = 1000) -> dict:
    """``ShardedFlatIndex`` on a 1 x 1 mesh over n x d fp16 unit rows, 64
    queries at k = 1,000, against ``FlatIndex.search`` on the card: the ids
    equal up to near ties (an id may differ only where its exact score is
    within 1e-5 of the flat index's at that rank). Returns the
    ``sharded_search`` JSON object."""
    import torch
    import torch.distributed as dist

    from meme_search_engine_tpu_torch.index.flat import FlatIndex
    from meme_search_engine_tpu_torch.ops import mips
    from meme_search_engine_tpu_torch.parallel.mesh import make_mesh
    from meme_search_engine_tpu_torch.parallel.sharded import ShardedFlatIndex

    t_phase = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, device=dev)
        rng = np.random.default_rng(1)
        x = rng.standard_normal((n, d), dtype=np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        x = x.astype(np.float16)
        q = rng.standard_normal((nq, d), dtype=np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        index = ShardedFlatIndex(x, mesh)
        flat = FlatIndex.build(x, list(range(n)), device=dev)
        index.search(q[:1], k)  # allocator at this size
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, i = index.search(q, k)
        search_s = time.perf_counter() - t0
        fs, fi = flat.search(q, k)
        full = mips.exact_scores(flat.vectors, torch.from_numpy(q).to(dev)).cpu().numpy()
        gap = float(np.abs(s - fs).max())
        moved = 0
        for row in range(nq):
            diff = np.flatnonzero(i[row] != fi[row])
            moved += len(diff)
            if len(diff) and np.abs(full[row, i[row, diff]] - fs[row, diff]).max() > NEAR_TIE_SEARCH:
                fail(f"sharded search: query {row} differs from FlatIndex beyond near ties")
        log(f"sharded_search: {n} x {d} fp16 on a {mesh.shape} mesh, {nq} queries at k={k} in "
            f"{search_s:.4f} s (host clock); largest score gap to FlatIndex {gap:.2e}, {moved} ids "
            f"moved within near ties")
        if s.shape != (nq, k) or gap > NEAR_TIE_SEARCH:
            fail(f"sharded search: shape {s.shape}, score gap {gap}")
        del index, flat
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {"n": n, "d": d, "queries": nq, "k": k, "mesh": mesh.shape, "search_s": search_s,
            "score_gap": gap, "ids_moved_within_ties": moved,
            "phase_s": time.perf_counter() - t_phase}


SCRAPE_IMAGES, SCRAPE_REJECT = 256, 26


def scrape(engine, launch_counts, reset_counts) -> dict:
    """The scraper end to end, as users run it, with nothing leaving this
    host: a local aiohttp host serves 256 JPEG and PNG images made from a
    seed (32 at 500 x 400), a zstd NDJSON submissions dump points at them
    with 26 links that triage must reject (and an NSFW and a deleted
    submission, which the reader drops), the port's clip server runs on
    the engine of phase 4, and ``scraper.scrape`` embeds through its
    default ``RemoteEmbedder``. The dump read back must hold every
    accepted URL once and no other, each embedding equal to the engine's
    own ``embed_image_bytes`` of the same bytes (cos >= 0.999); the image
    kernels launched and the text kernel did not. Then ``dump_tool
    stats`` on the dump, and ``get_embedding`` of one text through the
    same server (the text kernel, 27 launches). Returns the ``scrape``
    JSON object.

    The reference's triage rewrites ``http://`` to ``https://``; this host
    speaks plain HTTP, so the dump's links spell the scheme ``HTTP://``,
    which triage leaves alone and aiohttp reads as http."""
    import asyncio
    import base64
    import contextlib
    import io
    import tempfile

    from aiohttp import web
    from PIL import Image

    from meme_search_engine_tpu_torch.pipeline import dump, scraper
    from meme_search_engine_tpu_torch.serving import clip_server
    from meme_search_engine_tpu_torch.serving.client import InProcessEmbedder
    from meme_search_engine_tpu_torch.tools import dump_tool, get_embedding
    from meme_search_engine_tpu_torch.utils.fp16 import decode_fp16_buffer

    t_phase = time.perf_counter()
    cfg = engine.cfg
    rng = np.random.default_rng(2)
    blobs = {}
    for j in range(SCRAPE_IMAGES):
        h, w = (400, 500) if j % 8 == 0 else (cfg.image_size, cfg.image_size)
        small = rng.integers(0, 256, (h // 16, w // 16, 3), dtype=np.uint8)
        img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
        buf = io.BytesIO()
        fmt, mime, ext = ("PNG", "image/png", "png") if j % 2 else ("JPEG", "image/jpeg", "jpg")
        img.save(buf, format=fmt)
        blobs[f"{j:04d}.{ext}"] = (buf.getvalue(), mime)

    async def serve_image(request):
        blob = blobs.get(request.match_info["name"])
        if blob is None:
            raise web.HTTPNotFound()
        return web.Response(body=blob[0], content_type=blob[1])

    async def run(tmp):
        host = web.Application()
        host.router.add_get("/img/{name}", serve_image)
        runners = []
        for app in (host, clip_server.make_app(engine, {"max_batch_size": engine.max_batch})):
            runner = web.AppRunner(app)
            await runner.setup()
            await web.TCPSite(runner, "127.0.0.1", 0).start()
            runners.append(runner)
        try:
            img_port = runners[0].addresses[0][1]
            clip_url = f"http://127.0.0.1:{runners[1].addresses[0][1]}"
            base = f"HTTP://127.0.0.1:{img_port}"
            rows, accepted = [], set()
            for j, name in enumerate(sorted(blobs)):
                url = f"{base}/img/{name}"
                accepted.add(url)
                rows.append({"url": url, "title": f"meme {j}", "author": f"user{j % 7}",
                             "subreddit": "memes", "id": f"s{j}", "created_utc": 1_600_000_000 + j})
            rejected = [f"{base}/page{j}.html" if j % 2 else f"{base}/nothing-here/{j}"
                        for j in range(SCRAPE_REJECT)]
            for j, url in enumerate(rejected):
                rows.insert(10 * j + 3, {"url": url, "title": "no", "author": "u", "subreddit": "memes",
                                         "id": f"r{j}", "created_utc": 1_600_000_000 + j})
            rows.append({"url": f"{base}/img/0000.jpg", "title": "nsfw", "author": "u", "id": "x",
                         "over_18": True, "created_utc": 1})
            rows.append({"url": f"{base}/img/0001.png", "title": "gone", "author": "[deleted]",
                         "id": "y", "created_utc": 1})
            sub = os.path.join(tmp, "RS_synthetic.zst")
            with open(sub, "wb") as f:
                w = dump._StoredFrameWriter(f)
                w.write("\n".join(json.dumps(r) for r in rows).encode())
                w.close()
            out_dir = os.path.join(tmp, "dumps")
            scfg = scraper.ScraperConfig(input_files=[sub], output_dir=out_dir, clip_server=clip_url,
                                         max_fetch_concurrency=64)
            reset_counts()
            t0 = time.perf_counter()
            written = await scraper.scrape(scfg)
            scrape_s = time.perf_counter() - t0
            scrape_counts = launch_counts()
            reset_counts()
            loop = asyncio.get_running_loop()
            text_out = io.StringIO()

            def text_query():
                with contextlib.redirect_stdout(text_out):
                    get_embedding.main(["--server", clip_url, "--text", "a cat reacting to a gpu"])

            await loop.run_in_executor(None, text_query)
            text_counts = launch_counts()
            return (written, scrape_s, scrape_counts, text_counts, accepted, set(rejected), out_dir,
                    text_out.getvalue())
        finally:
            for runner in runners:
                await runner.cleanup()

    with tempfile.TemporaryDirectory() as tmp:
        (written, scrape_s, scrape_counts, text_counts, accepted, rejected, out_dir,
         text_b64) = asyncio.run(run(tmp))
        path = os.path.join(out_dir, "000000001.dump.zst")
        entries = list(dump.read_dump(path))
        stats_out = io.StringIO()
        with contextlib.redirect_stdout(stats_out):
            dump_tool.main(["stats", "--dumps", path])
        stats = json.loads(stats_out.getvalue().strip().splitlines()[-1])
    urls = [e.url for e in entries]
    log(f"scrape: {written} entries written of {len(accepted)} accepted links in {scrape_s:.2f} s "
        f"({written / scrape_s:.1f} images/s); launches {scrape_counts}; dump_tool stats {stats}")
    if written != len(accepted) or len(urls) != len(set(urls)) or set(urls) != accepted:
        fail(f"scrape: {written} written, {len(set(urls))} distinct URLs, "
             f"{len(set(urls) - accepted)} not accepted, {len(accepted - set(urls))} missing")
    if set(urls) & rejected:
        fail("scrape: a rejected link reached the dump")
    if stats["entries"] != written:
        fail(f"scrape: dump_tool stats counts {stats['entries']} entries of {written}")
    depth = cfg.depth
    nb = scrape_counts["matmul_residual"] // depth
    if (scrape_counts["fused_mha"] or not nb or scrape_counts["ln_matmul"] != (depth + 1) * nb
            or scrape_counts["ln_mlp_residual"] != depth * nb or scrape_counts["fat_vit_mha"] != depth * nb):
        fail(f"scrape: the image kernels' launches {scrape_counts} are not {depth} a layer of "
             f"{nb} buckets")
    embedder = InProcessEmbedder(engine)
    names = {f"/img/{n}": b for n, (b, _) in blobs.items()}
    order = [names[u[u.index("/img/"):]] for u in urls]
    direct = asyncio.run(embedder.embed_image_bytes(order))
    got = np.stack([e.embedding for e in entries])
    cos = np.sum(got * direct, axis=1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(direct, axis=1))
    text = decode_fp16_buffer(base64.urlsafe_b64decode(text_b64.strip().splitlines()[-1]))
    text_cos = float(text @ engine.embed_texts(["a cat reacting to a gpu"])[0] / np.linalg.norm(text))
    log(f"scrape: dump embeddings against the engine's embed_image_bytes: cos min {cos.min():.6f}; "
        f"get_embedding's text against embed_texts: cos {text_cos:.6f}, launches {text_counts}")
    if not cos.min() >= 0.999 or not text_cos >= 0.999:
        fail(f"scrape: embeddings disagree: images cos min {cos.min()}, text cos {text_cos}")
    if text_counts["fused_mha"] != cfg.text_depth or any(
            v for k, v in text_counts.items() if k != "fused_mha"):
        fail(f"scrape: get_embedding's text launched {text_counts}")
    return {"images": len(blobs), "rejected_links": len(rejected), "written": written,
            "scrape_s": scrape_s, "images_per_s": written / scrape_s, "buckets": nb,
            "launches": scrape_counts, "text_launches": text_counts, "cos_min": float(cos.min()),
            "text_cos": text_cos, "dump_stats": stats, "phase_s": time.perf_counter() - t_phase}


# the quality phase at the reference's widths: the ensemble of 16 at d = 1152
# with 3 channels and one hidden layer (meme-rater/model.py), the SAE of
# 262,144 features at top-k 128 (sae/model.py); every input from a seed
QUALITY = {
    "d": 1152, "ensemble": 16, "channels": 3,
    "items": 8192, "ratings": 16384, "steps": 600, "batch": 128, "lr": 3e-4, "dropout": 0.1,
    "corpus": 1_000_000, "pack_n": 20_000, "pack_shards": 4, "al_pairs": 256,
    "crawl": 64, "copies": 8, "library": SERVICE_N,
    "sae_hidden": 262144, "sae_k": 128, "sae_steps": 30, "sae_batch": 1024, "sae_lr": 1e-4,
}
AXES = ("useful", "meme", "aesthetic")
# the disk server's scale for a slider at +1 (serving/disk_query_server.py)
SLIDER_SCALE = 1.0 / 512


def _unit_rows(rng, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d), dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _rate(z: np.ndarray) -> np.ndarray:
    """A hidden scorer's standardised margin -> the rater's five strings."""
    return np.select([z > 0.5, z > 0.1, z > -0.1, z > -0.5], ["1+", "1", "eq", "2"], "2+")


def _step_events(owner, name):
    """Wrap ``owner.name`` (a training step's forward) to record a CUDA
    event at each call made with grad enabled; returns the event list and
    a function that puts ``owner.name`` back."""
    import torch

    fn = getattr(owner, name)
    events = []

    def wrapper(*a, **k):
        if torch.is_grad_enabled():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        return fn(*a, **k)

    setattr(owner, name, wrapper)
    return events, lambda: setattr(owner, name, fn)


def _step_ms(events) -> float:
    """Median ms from one step's forward to the next, after the first."""
    import torch

    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in zip(events[1:], events[2:])]))


def _test_card(rng, j: int, r: int) -> np.ndarray:
    """A uint8 r x r test card of family j % 4 with colours and periods
    from ``rng``: stripes at an angle, a checkerboard, rings, a two-colour
    gradient. The random-weight engine maps noise images close together,
    some distinct pairs above the duplicate threshold; these cards land
    further apart."""
    y, x = np.mgrid[0:r, 0:r]
    c0 = rng.integers(0, 256, 3)
    c1 = (c0 + 128 + rng.integers(-48, 49, 3)) % 256  # far from c0 in every channel
    kind = j % 4
    if kind == 3:
        angle = rng.uniform(0, 2 * np.pi)
        t = (x * np.cos(angle) + y * np.sin(angle)) / (r * 1.42) + 0.5
        return (c0 * (1 - t[..., None]) + c1 * t[..., None]).clip(0, 255).astype(np.uint8)
    if kind == 0:
        angle = rng.uniform(0, np.pi)
        m = ((x * np.cos(angle) + y * np.sin(angle)) // rng.integers(3, 48)) % 2 == 0
    elif kind == 1:
        f = rng.integers(4, 96)
        m = ((x // f) + (y // f)) % 2 == 0
    else:
        cx, cy = rng.integers(0, r, 2)
        m = (np.hypot(x - cx, y - cy) // rng.integers(4, 64)) % 2 == 0
    return np.where(m[..., None], c0, c1).astype(np.uint8)


def quality(engine, dev, launch_counts, reset_counts, check_counts, q: dict = QUALITY) -> dict:
    """The quality model, the rater stack and the SAE on the card at the
    reference's widths (``QUALITY``), through the port's entry points:

    1. ``rater.train`` on a ``RatingsDB`` of unit items rated by a hidden
       linear scorer over three axes (the loss falls below 0.8x its first,
       pairwise AUROC >= 0.8 on the ``is_validation`` split; 3 steps at
       dropout 0 card against CPU: loss 1e-4 relative, params 1e-3);
    2. ``export_wide`` (its own 1e-4 check) and the safetensors round trip;
    3. ``score_batch`` over a 1e6 x d corpus (4,096 rows against a float64
       numpy ensemble mean at 1e-4), one chunk profiled;
    4. ``dump_tool`` sample, kmeans, shard, build-shards and ``pack
       --score-model`` (the descriptor codes equal ``bucketize_scores`` of
       the wide model's scores), then ``DiskIndex`` queries with the Useful
       slider at 0 and +1 (the answers' mean Useful code rises);
    5. active learning: variances, 256 pairs through the DB's queue,
       gradient norms (16 against the CPU at 1e-4 relative), the top
       decile's pairs;
    6. the meme pipeline: a crawl from a local aiohttp host, the images
       embedded by ``engine`` (the image kernels' launches checked), the
       median scores, the duplicates planted in the small-scale library
       flagged and no others, the queue app over HTTP;
    7. ``train_sae`` on the library, ``sae_forward`` card against CPU,
       one step under ``profiling.trace``, feature exemplars.

    Every failed check calls ``fail``. Returns the ``quality`` JSON
    object."""
    import tempfile

    import torch

    from meme_search_engine_tpu_torch.models import score_model as sm

    t_phase = time.perf_counter()
    d, n_e, ch = q["d"], q["ensemble"], q["channels"]
    cfg = sm.ScoreModelConfig(d_emb=d, n_hidden=1, n_ensemble=n_e, output_channels=ch, dropout=q["dropout"])
    out = {"config": dict(q)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model, items, names, db, hidden_w = _quality_train(cfg, dev, q, tmp, out)
        out["train_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        wide, model_path = _quality_export(model, cfg, tmp, out)
        _quality_score(model, wide, dev, q, tmp, out)
        out["score_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _quality_pack(wide, model_path, dev, q, tmp, out)
        out["pack_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _quality_active(model, items, names, db, hidden_w, dev, q, out)
        out["active_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        library = _quality_pipeline(engine, model, dev, q, tmp, out, launch_counts, reset_counts,
                                    check_counts)
        out["pipeline_phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _quality_sae(library, dev, q, tmp, out)
        out["sae_phase_s"] = time.perf_counter() - t0
        db.conn.close()
    del model, wide
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"quality: the phase took {out['phase_s']:.1f} s")
    return out


def _quality_train(cfg, dev, q, tmp, out):
    """Step 1: ratings, training, AUROC, the card against the CPU."""
    import torch

    from meme_search_engine_tpu_torch.models import score_model as sm
    from meme_search_engine_tpu_torch.rater import evaluate
    from meme_search_engine_tpu_torch.rater import train as rtrain
    from meme_search_engine_tpu_torch.rater.data import RatingsDB, is_validation
    from meme_search_engine_tpu_torch.utils.fp16 import encode_fp16_buffer

    rng = np.random.default_rng(11)
    n, d = q["items"], q["d"]
    items = _unit_rows(rng, n, d)
    names = [f"meme{i:05d}.png" for i in range(n)]
    hidden_w = rng.standard_normal((d, 3)).astype(np.float32)
    truth = items @ hidden_w
    idx = rng.integers(0, n, (2 * q["ratings"], 2))
    idx = idx[idx[:, 0] != idx[:, 1]][: q["ratings"]]
    z = (truth[idx[:, 0]] - truth[idx[:, 1]]) / (truth.std(0) * np.sqrt(2))
    ratings = _rate(z)
    db = RatingsDB(os.path.join(tmp, "ratings.db"))
    # in bulk, as add_file and add_rating write them (each commits a row)
    db.conn.executemany("INSERT OR REPLACE INTO files VALUES (?, ?)",
                        [(nm, encode_fp16_buffer(v)) for nm, v in zip(names, items)])
    db.conn.executemany("INSERT INTO ratings VALUES (?, ?, ?, ?)",
                        [(names[a], names[b], ratings[k, c], AXES[c])
                         for k, (a, b) in enumerate(idx) for c in range(3)])
    db.conn.commit()
    (tr_p, tr_t), (va_p, va_t) = db.train_val_split()
    _, all_t, pair_names = db.pairs()
    log(f"quality: {n} items x {d}, {len(idx)} rated pairs on {len(AXES)} axes "
        f"({len(tr_p)} train, {len(va_p)} validation after merging repeats)")

    log_path = os.path.join(tmp, "train.jsonl")
    settings = rtrain.TrainSettings(lr=q["lr"], batch_size=q["batch"], steps=q["steps"],
                                    dropout=q["dropout"], seed=0, log_path=log_path)
    events, restore = _step_events(rtrain, "bradley_terry_prob")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        model, hist = rtrain.train(tr_p, tr_t, cfg, settings, val=(va_p, va_t), device=dev)
    finally:
        restore()
    train_s = time.perf_counter() - t0
    step_ms = _step_ms(events)
    curves = evaluate.loss_curves(log_path)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    # the Useful channel of the mean score against the human choice on the
    # validation pairs that are not rated equal
    scores = sm.ensemble_forward(model, items).mean(0)[:, 0].detach().cpu().numpy()
    row = {nm: i for i, nm in enumerate(names)}
    val = [(row[a], row[b], t[0]) for (a, b), t in zip(pair_names, all_t)
           if (is_validation(a) or is_validation(b)) and t[0] != 0.5]
    auroc = evaluate.pairwise_auroc(scores, [(a, b) for a, b, _ in val], [t > 0.5 for _, _, t in val])
    log(f"quality: rater.train {q['steps']} steps at B={q['batch']} in {train_s:.2f} s, {step_ms:.3f} ms a "
        f"step (CUDA events, median after the first); loss {first:.4f} -> {last:.4f} "
        f"({last / first:.3f}x), val_loss {curves['val_loss'][0]:.4f} -> {curves['val_loss'][-1]:.4f}; "
        f"pairwise AUROC on {len(val)} validation pairs {auroc:.4f}")
    if len(curves["loss"]) != q["steps"] or len(curves["val_loss"]) != -(-q["steps"] // rtrain.CHECKPOINT_EVERY):
        fail(f"quality: the JSONL log holds {len(curves['loss'])} losses and {len(curves['val_loss'])} val_losses")
    if not last < 0.8 * first:
        fail(f"quality: the rater's loss went from {first} to {last}, not below 0.8x")
    if not auroc >= 0.8:
        fail(f"quality: pairwise AUROC {auroc} < 0.8")

    # 3 steps at dropout 0 from one start, on the card and on the CPU
    start = sm.init_ensemble(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    three = rtrain.TrainSettings(lr=q["lr"], batch_size=q["batch"], steps=3, dropout=0.0, seed=0)
    card_m, card_h = rtrain.train(tr_p, tr_t, cfg, three, device=dev, params=start)
    cpu_m, cpu_h = rtrain.train(tr_p, tr_t, cfg, three, device="cpu", params=sm.on_device(start, "cpu"))
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(card_h, cpu_h))
    param_err = max(float((a.detach().cpu() - b.detach()).abs().max())
                    for a, b in zip(card_m.parameters(), cpu_m.parameters()))
    log(f"quality: 3 steps card against CPU: loss {loss_rel:.2e} relative (tol 1e-4), params "
        f"{param_err:.2e} (tol 1e-3)")
    if not (loss_rel <= 1e-4 and param_err <= 1e-3):
        fail(f"quality: the rater's card and CPU steps disagree: loss {loss_rel}, params {param_err}")
    out["rater"] = {"pairs_train": len(tr_p), "pairs_val": len(va_p), "train_s": train_s,
                    "step_ms": step_ms, "loss_first": first, "loss_last": last,
                    "val_loss": [curves["val_loss"][0], curves["val_loss"][-1]], "auroc": auroc,
                    "auroc_pairs": len(val), "card_cpu_loss_rel": loss_rel, "card_cpu_param_err": param_err}
    return model, items, names, db, hidden_w


def _quality_export(model, cfg, tmp, out):
    """Step 2: the wide export and its safetensors file."""
    from meme_search_engine_tpu_torch.models import score_model as sm

    t0 = time.perf_counter()
    try:
        wide = sm.export_wide(model, cfg)
    except AssertionError as e:
        fail(f"quality: {e}")
    path = os.path.join(tmp, "model.safetensors")
    wide.save_safetensors(path)
    back = sm.WideScoreModel.load_safetensors(path)
    same = all(np.array_equal(getattr(back, k), getattr(wide, k)) for k in ("up_proj", "bias", "down_proj"))
    log(f"quality: export_wide up_proj {wide.up_proj.shape}, down_proj {wide.down_proj.shape}, scale "
        f"{wide.scale:.6f}; {os.path.getsize(path) / 2**20:.1f} MiB of safetensors read back "
        f"{'equal' if same else 'DIFFERENT'} ({time.perf_counter() - t0:.2f} s)")
    if not same:
        fail("quality: the wide model's safetensors file did not read back equal")
    out["export"] = {"up_proj": list(wide.up_proj.shape), "down_proj": list(wide.down_proj.shape),
                     "file_mib": os.path.getsize(path) / 2**20, "s": time.perf_counter() - t0}
    return wide, path


def _quality_score(model, wide, dev, q, tmp, out):
    """Step 3: the corpus scored in chunks; 4,096 rows in float64 numpy."""
    import torch

    from meme_search_engine_tpu_torch.models.score_model import SCORE_CHUNK
    from meme_search_engine_tpu_torch.utils import profiling

    n, d, e = q["corpus"], q["d"], q["ensemble"]
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((n, d), generator=gen, device=dev)
    x /= x.norm(dim=1, keepdim=True)
    wide.score_batch(x[:1024], device=dev)  # cuBLAS and the allocator at these shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    scores = wide.score_batch(x, device=dev)
    score_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    flops = 2.0 * n * d * e * d + 2.0 * n * e * d * q["channels"]
    rows = np.linspace(0, n - 1, 4096).astype(np.int64)
    xs = x[torch.from_numpy(rows).to(dev)].cpu().double().numpy()
    ref = np.zeros((len(rows), q["channels"]))
    hw, hb = model.hidden[0].w.detach().cpu().double().numpy(), model.hidden[0].b.detach().cpu().double().numpy()
    ow = model.output.w.detach().cpu().double().numpy()
    for m in range(e):
        h = xs @ hw[m] + hb[m]
        ref += (h / (1 + np.exp(-h))) @ ow[m]
    err = float(np.abs(scores[rows] - ref / e).max())
    torch.cuda.synchronize()
    wall = time.perf_counter()
    with profiling.trace(os.path.join(tmp, "trace_score")) as prof:
        wide.score_batch(x[:SCORE_CHUNK], device=dev)
    prof_wall = (time.perf_counter() - wall) * 1e3
    log(f"quality: score_batch {n} x {d} in {score_s:.3f} s: {n / score_s:,.0f} rows/s, "
        f"{flops / score_s / 1e12:.1f} TFLOP/s ({flops / 1e12:.2f} TFLOP, fp32), peak {peak:.2f} GiB above "
        f"the corpus; 4,096 rows against a float64 ensemble mean: max abs err {err:.2e} (tol 1e-4)")
    summary = device_summary(prof, prof_wall, f"score_batch of {SCORE_CHUNK} rows")
    if scores.shape != (n, q["channels"]) or not np.isfinite(scores).all() or not err <= 1e-4:
        fail(f"quality: corpus scores {scores.shape}, finite {np.isfinite(scores).all()}, err {err}")
    out["score"] = {"rows": n, "s": score_s, "rows_per_s": n / score_s, "tflop": flops / 1e12,
                    "tflops": flops / score_s / 1e12, "peak_gib": peak, "max_abs_err": err,
                    "chunk": SCORE_CHUNK, "profile": summary}
    del x


def _quality_pack(wide, model_path, dev, q, tmp, out):
    """Step 4: the dump_tool chain with ``pack --score-model``, then the
    sliders of the packed index."""
    import contextlib
    import glob
    import io
    import json as json_

    from meme_search_engine_tpu_torch.index.disk_index import DiskIndex
    from meme_search_engine_tpu_torch.index.opq import train_opq
    from meme_search_engine_tpu_torch.pipeline.descriptors import bucketize_scores, compute_cdfs
    from meme_search_engine_tpu_torch.pipeline.dump import DumpWriter, OriginalImageMetadata, ProcessedEntry
    from meme_search_engine_tpu_torch.pipeline.formats import IndexHeader, read_shard_input
    from meme_search_engine_tpu_torch.tools import dump_tool

    n, d = q["pack_n"], q["d"]
    rng = np.random.default_rng(4)
    base = os.path.join(tmp, "pack")
    os.makedirs(base)
    dump = os.path.join(base, "000000001.dump.zst")
    emb = _unit_rows(rng, n, d)
    stages = {}
    t0 = time.perf_counter()
    with DumpWriter(dump) as w:
        for i in range(n):
            w.write(ProcessedEntry(url=f"https://example.com/{i}.png", id=f"p{i}", title="t",
                                   subreddit="memes", author="a", timestamp=1_600_000_000 + 37 * i,
                                   embedding=emb[i],
                                   metadata=OriginalImageMetadata("image/png", 1, (384, 384), f"f{i}")))
    stages["dump"] = time.perf_counter() - t0
    shards, index_dir = os.path.join(base, "shards"), os.path.join(base, "index")
    dims = ["--d-emb", str(d)]
    argvs = {
        "sample": ["sample", "--dumps", dump, "--fraction", "0.25", "--output", os.path.join(base, "s.bin")],
        "kmeans": ["kmeans", "--sample", os.path.join(base, "s.bin"), *dims, "--clusters",
                   str(q["pack_shards"]), "--output", os.path.join(base, "c.bin"), "--device", str(dev)],
        "shard": ["shard", "--dumps", dump, "--centroids", os.path.join(base, "c.bin"), *dims, "--out-dir", shards],
        "build-shards": ["build-shards", "--shard-dir", shards, *dims, "--device", str(dev)],
    }
    said = io.StringIO()
    for name, argv in argvs.items():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            dump_tool.main(argv)
        stages[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sample = np.fromfile(os.path.join(base, "s.bin"), np.float16).reshape(-1, d).astype(np.float32)
    pq = train_opq(sample, sample[:1024], n_chunks=64, n_centroids=256, outer_iters=1, adam_iters=20,
                   device=dev)
    opq_path = os.path.join(base, "opq.msgpack")
    with open(opq_path, "wb") as f:
        f.write(pq.to_msgpack())
    stages["opq"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        dump_tool.main(["pack", "--shard-dir", shards, "--out-dir", index_dir, "--opq", opq_path,
                        "--score-model", model_path, "--device", str(dev)])
    stages["pack"] = time.perf_counter() - t0
    lines = said.getvalue().strip().splitlines()
    log(f"quality: dump_tool chain on {n} records x {d} in {q['pack_shards']} shards; stages (s) "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()) + f"; {lines[-1]}")

    # the codes against the wide model's own scores of the packed rows
    with open(os.path.join(shards, "manifest.json")) as f:
        manifest = json_.load(f)
    vectors = np.zeros((len(manifest), d), np.float32)
    for path in glob.glob(os.path.join(shards, "shard_*.msgpack")):
        for rid, vec in read_shard_input(path)[1]:
            vectors[rid] = vec
    scores = wide.score_batch(vectors, device=dev)
    stamps = [m["timestamp"] for m in manifest]
    cdfs = compute_cdfs(scores, stamps)
    want = bucketize_scores(scores, stamps, cdfs)
    got = np.fromfile(os.path.join(index_dir, "index.descriptor-codes.bin"), np.uint8)
    header = IndexHeader.load(os.path.join(index_dir, "index.msgpack"))
    same_cdfs = len(header.descriptor_cdfs) == len(cdfs) and all(
        np.array_equal(np.asarray(a, np.float32), b) for a, b in zip(header.descriptor_cdfs, cdfs))
    if len(manifest) != n or got.shape != want.reshape(-1).shape or not np.array_equal(got, want.reshape(-1)) \
            or not same_cdfs:
        fail(f"quality: the packed descriptor codes ({got.shape}) or CDFs ({same_cdfs}) are not those of "
             f"the wide model's scores of the {len(manifest)} records")

    # the Useful slider through the disk index: at +1 the answers' codes rise
    index = DiskIndex(index_dir)
    queries = _unit_rows(rng, 16, d)
    up = np.zeros(index.n_descriptors, np.float32)
    up[0] = SLIDER_SCALE
    mean_code = []
    t0 = time.perf_counter()
    for scales in (None, up):
        codes = [index.descriptors[r.id, 0] for qv in queries
                 for r in index.search(qv, 20, beamwidth=4, search_list=500, descriptor_scales=scales)[0]]
        mean_code.append(float(np.mean(codes)))
    log(f"quality: 16 queries x 20 answers, mean Useful code {mean_code[0]:.2f} with the slider at 0, "
        f"{mean_code[1]:.2f} at +1 ({time.perf_counter() - t0:.2f} s)")
    if not mean_code[1] > mean_code[0]:
        fail(f"quality: the Useful slider at +1 did not raise the answers' codes: {mean_code}")
    out["pack"] = {"records": n, "shards": q["pack_shards"], "stages_s": stages,
                   "mean_useful_code": mean_code}


def _quality_active(model, items, names, db, hidden_w, dev, q, out):
    """Step 5: active learning at full width."""
    from meme_search_engine_tpu_torch.rater import active_learning as al
    from meme_search_engine_tpu_torch.rater.data import RATING_PROBS

    t0 = time.perf_counter()
    var = al.ensemble_variance(model, items, device=dev)
    pairs = al.select_pairs_by_variance(model, items, q["al_pairs"], seed=0, device=dev)
    named = [(names[a], names[b]) for a, b in pairs]
    db.push_queue(named)
    back = [db.pop_queue() for _ in named]
    if var.shape != (len(items),) or not (var >= 0).all() or len(pairs) != q["al_pairs"] \
            or back != named or db.pop_queue() is not None:
        fail(f"quality: variances {var.shape}, {len(pairs)} pairs, the queue read back "
             f"{'equal' if back == named else 'different'}")
    ab = np.asarray(pairs)
    truth = items @ hidden_w
    z = (truth[ab[:, 0]] - truth[ab[:, 1]]) / (truth.std(0) * np.sqrt(2))
    targets = np.vectorize(RATING_PROBS.get)(_rate(z)).astype(np.float32)
    t1 = time.perf_counter()
    norms = al.gradient_norms(model, items[ab], targets, device=dev)
    grad_s = time.perf_counter() - t1
    cpu = al.gradient_norms(model, items[ab[:16]], targets[:16], device="cpu")
    rel = float(np.abs(norms[:16] - cpu).max() / np.abs(cpu).min())
    top = al.select_top_percentile_pairs(var, 64, percentile=90)
    cut = np.percentile(var, 90)
    log(f"quality: active learning over {len(items)} items: {len(pairs)} pairs queued and read back; "
        f"gradient norms of {len(norms)} pairs in {grad_s:.2f} s (16 against the CPU: {rel:.2e} "
        f"relative, tol 1e-4); {len(top)} top-decile pairs ({time.perf_counter() - t0:.2f} s)")
    if norms.shape != (len(pairs),) or not (norms > 0).all() or not rel <= 1e-4:
        fail(f"quality: gradient norms {norms.shape}, card against CPU {rel}")
    if len(top) != 64 or any(a == b or var[a] < cut or var[b] < cut for a, b in top):
        fail("quality: select_top_percentile_pairs gave pairs outside the top decile")
    out["active"] = {"pairs": len(pairs), "grad_norms_s": grad_s, "grad_card_cpu_rel": rel,
                     "s": time.perf_counter() - t0}


def _quality_pipeline(engine, model, dev, q, tmp, out, launch_counts, reset_counts, check_counts):
    """Step 6: crawl, embed, score, dedup, queue, all against one local
    aiohttp host. Returns the library (fp16 rows) for step 7."""
    import asyncio
    import io
    import urllib.request

    import torch
    from aiohttp import ClientSession, web
    from PIL import Image

    from meme_search_engine_tpu_torch.models import score_model as sm
    from meme_search_engine_tpu_torch.rater import crawler
    from meme_search_engine_tpu_torch.rater import meme_pipeline as mp
    from meme_search_engine_tpu_torch.serving.client import InProcessEmbedder
    from meme_search_engine_tpu_torch.serving.engine import pow2_buckets

    cfg = engine.cfg
    rng = np.random.default_rng(6)
    blobs = []
    for j in range(q["crawl"]):
        buf = io.BytesIO()
        Image.fromarray(_test_card(rng, j, cfg.image_size)).save(buf, format="PNG")
        blobs.append(buf.getvalue())
    copies = np.sort(rng.choice(q["crawl"], q["copies"], replace=False))
    # the small-scale service's library: unit fp16 rows from a seed, with the
    # engine's own embeddings of the copied images planted in it
    library = _unit_rows(np.random.default_rng(5), q["library"], q["d"]).astype(np.float16)
    slots = np.sort(rng.choice(q["library"], q["copies"], replace=False))
    embedder = InProcessEmbedder(engine)
    # every download goes to the local host, whatever proxy the environment names
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    urllib.request.install_opener(opener)
    posts = [{"id": f"p{j}", "title": f"meme {j}"} for j in range(q["crawl"])]
    page = 24
    queue_path, memes = os.path.join(tmp, "queue.json"), os.path.join(tmp, "memes")
    os.makedirs(memes)

    async def listing(request):
        after = request.query.get("after")
        start = int(after[3:]) if after else 0
        nxt = f"t3_{start + page}" if start + page < len(posts) else None
        return web.json_response({"data": {"children": [{"data": p} for p in posts[start:start + page]],
                                           "after": nxt}}, headers={"x-ratelimit-remaining": "50"})

    async def image(request):
        return web.Response(body=blobs[int(request.match_info["j"])], content_type="image/png")

    def scored(embs, base):
        """Score, dedup, filter and enqueue (blocking, on the card)."""
        urls = [f"{base}/img/{j}.png" for j in range(len(embs))]
        scores = mp.score_candidates(embs, model, 0, device=dev)
        with torch.no_grad():
            members = sm.ensemble_forward(model, embs)[:, :, 0].cpu().numpy()
        if not np.array_equal(scores, np.median(members, axis=0)):
            fail("quality: score_candidates is not the median of the members' scores")
        lib_dev = torch.from_numpy(library).to(dev)
        dups = mp.near_duplicates(embs, lib_dev, device=dev)
        sims = (embs.astype(np.float64) @ library.astype(np.float64).T).max(axis=1)
        others = np.delete(sims, copies)
        log(f"quality: median scores of {len(embs)} crawled images over {q['ensemble']} members; near "
            f"duplicates flagged {np.flatnonzero(dups).tolist()} (planted {copies.tolist()}): their best "
            f"library dot {sims[copies].min():.6f} or more, the others' at most {others.max():.6f}")
        if not np.array_equal(np.flatnonzero(dups), copies):
            fail(f"quality: near_duplicates flagged {np.flatnonzero(dups).tolist()}, planted {copies.tolist()}")
        threshold = float(np.quantile(scores, 0.25))
        accepted = mp.filter_candidates(urls, embs, model, lib_dev, score_threshold=threshold, device=dev)
        want = {urls[j] for j in range(len(urls)) if not dups[j] and scores[j] >= threshold}
        got = [c.score for c in accepted]
        if {c.url for c in accepted} != want or len(accepted) != len(want) or got != sorted(got, reverse=True):
            fail(f"quality: filter_candidates accepted {len(accepted)}, expected {len(want)}")
        mp.enqueue_candidates(queue_path, accepted)
        return accepted, threshold, sims, others

    async def run():
        loop = asyncio.get_running_loop()
        host = web.Application()
        host.router.add_get("/user/{user}/m/{multi}.json", listing)
        host.router.add_get("/img/{j}.png", image)
        runners = []
        for app in (host, mp.make_queue_app(queue_path, memes)):
            runner = web.AppRunner(app)
            await runner.setup()
            await web.TCPSite(runner, "127.0.0.1", 0).start()
            runners.append(runner)
        try:
            base, qurl = (f"http://127.0.0.1:{r.addresses[0][1]}" for r in runners)
            for j, p in enumerate(posts):
                p["url"] = f"{base}/img/{j}.png"
            prefix = "https://www.reddit.com/"

            def fetch(url):
                if not url.startswith(prefix):
                    raise ValueError(f"the crawler asked for {url}")
                with opener.open(base + "/" + url[len(prefix):], timeout=30) as r:
                    return r.status, dict(r.headers), r.read()

            def get(url):
                with opener.open(url, timeout=30) as r:
                    return r.read()

            t0 = time.perf_counter()
            crawled = await loop.run_in_executor(
                None, lambda: list(crawler.crawl_multireddit("smoke", "memes", fetch=fetch)))
            got = await asyncio.gather(*(loop.run_in_executor(None, get, p["url"]) for p in crawled))
            crawl_s = time.perf_counter() - t0
            if [p["url"] for p in crawled] != [p["url"] for p in posts] or list(got) != blobs:
                fail(f"quality: the crawl gave {len(crawled)} posts, "
                     f"{sum(a == b for a, b in zip(got, blobs))} images equal to the host's")
            planted = await embedder.embed_image_bytes([blobs[j] for j in copies])
            library[slots] = planted.astype(np.float16)
            reset_counts()
            t0 = time.perf_counter()
            embs = await embedder.embed_image_bytes(list(got))
            embed_s = time.perf_counter() - t0
            counts = launch_counts()
            accepted, threshold, sims, others = scored(embs, base)
            async with ClientSession() as s:
                first = await (await s.get(qurl + "/")).text()
                skip = (await s.post(qurl + "/skip", allow_redirects=False)).status
                second = await (await s.get(qurl + "/")).text()
                assign = (await s.post(qurl + "/assign", data={"filename": "saved.png"},
                                       allow_redirects=False)).status
            return (crawled, crawl_s, embs, embed_s, counts, accepted, threshold, sims, others, base,
                    (first, skip, second, assign))
        finally:
            for runner in runners:
                await runner.cleanup()

    (crawled, crawl_s, embs, embed_s, counts, accepted, threshold, sims, others, base,
     (first, skip, second, assign)) = asyncio.run(run())
    n_buckets = len(pow2_buckets(len(embs), engine.max_batch))
    log(f"quality: crawled {len(crawled)} posts over {-(-len(posts) // page)} pages and fetched them in "
        f"{crawl_s:.2f} s; embedded in {embed_s:.2f} s, {n_buckets} bucket(s), launches {counts}")
    check_counts("quality crawl", counts, {
        "ln_matmul": cfg.depth + 1, "matmul_residual": cfg.depth, "ln_mlp_residual": cfg.depth,
        "fat_vit_mha": cfg.depth, "fused_mha": 0, "fat_vit_mha_packed_proj": 0, "adc_scores": 0,
        "gather_rows": 0, "gather_dot": 0, "gather_gram": 0,
    }, n_buckets)
    saved = os.path.join(memes, "saved.png")
    with open(queue_path) as f:
        left = [e["url"] for e in json.load(f)]
    ok = (accepted[0].url in first and skip == 302 and accepted[1].url in second and assign == 302
          and os.path.exists(saved) and left == [c.url for c in accepted[2:]])
    if ok:
        with open(saved, "rb") as f:
            ok = f.read() == blobs[int(accepted[1].url.rsplit("/", 1)[1][:-4])]
    log(f"quality: {len(accepted)} candidates above the score quartile {threshold:.4f} queued; the queue "
        f"app showed, skipped and saved one over HTTP: {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"quality: the queue app: skip {skip}, assign {assign}, {len(left)} left")
    out["pipeline"] = {"crawled": len(crawled), "copies": len(copies), "crawl_s": crawl_s,
                       "embed_s": embed_s, "buckets": n_buckets, "launches": counts,
                       "copy_dot_min": float(sims[copies].min()), "other_dot_max": float(others.max()),
                       "accepted": len(accepted)}
    return library


def _quality_sae(library, dev, q, tmp, out):
    """Step 7: the SAE at full width on the library rows."""
    import glob

    import torch

    from meme_search_engine_tpu_torch.index.flat import FlatIndex
    from meme_search_engine_tpu_torch.models import sae
    from meme_search_engine_tpu_torch.models.sae_tools import exemplar_sheet_html, feature_exemplars
    from meme_search_engine_tpu_torch.utils import profiling

    d, h, k, b = q["d"], q["sae_hidden"], q["sae_k"], q["sae_batch"]
    scfg = sae.SAEConfig(d_emb=d, d_hidden=h, top_k=k)
    x = torch.from_numpy(library).to(dev).float()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    events, restore = _step_events(sae, "sae_forward")
    t0 = time.perf_counter()
    try:
        params, counters = sae.train_sae(x, scfg, steps=q["sae_steps"], batch_size=b, lr=q["sae_lr"],
                                         seed=0, device=dev)
    finally:
        restore()
    train_s = time.perf_counter() - t0
    step_ms = _step_ms(events)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    flops = 5 * 2.0 * b * d * h  # up, recon, and the three products of the backward
    log(f"quality: train_sae {q['sae_steps']} steps, B={b}, {d} -> {h} top-{k}, in {train_s:.2f} s: "
        f"{step_ms:.2f} ms a step (CUDA events, median after the first), {flops / step_ms / 1e9:.1f} TFLOP/s "
        f"({flops / 1e12:.2f} TFLOP a step, fp32), peak {peak:.2f} GiB above the library; "
        f"{int((counters > 0).sum())} features fired")
    if counters.dtype != np.int32 or counters.shape != (h,) or not 0 < counters.sum() <= q["sae_steps"] * b * k:
        fail(f"quality: SAE counters {counters.dtype} {counters.shape} sum {counters.sum()}")

    # 64 rows card against CPU from the same parameters
    rows = x[:64]
    with torch.no_grad():
        recon, counts = sae.sae_forward(params, rows, scfg)
        cpu_params = {key: v.cpu() for key, v in params.items()}
        cpu_rows = rows.cpu()
        cpu_recon, _ = sae.sae_forward(cpu_params, cpu_rows, scfg)
        top = torch.topk(torch.relu(cpu_rows @ cpu_params["up_w"]), k + 1, dim=1).values
        tie = (top[:, k - 1] - top[:, k]) <= 1e-6
        keep = torch.nonzero(~tie).flatten()
        _, card_counts = sae.sae_forward(params, rows[keep.to(dev)], scfg)
        _, cpu_counts = sae.sae_forward(cpu_params, cpu_rows[keep], scfg)
        per_row = [int(sae.sae_forward(params, rows[i:i + 1], scfg)[1].sum()) for i in range(len(rows))]
    err = float((recon.cpu() - cpu_recon).abs().max())
    same = bool(torch.equal(card_counts.cpu(), cpu_counts))
    log(f"quality: sae_forward on 64 rows card against CPU: recon max abs err {err:.2e} (tol 1e-4); counts "
        f"{'equal' if same else 'DIFFERENT'} outside {int(tie.sum())} rows with the k-th and (k+1)-th "
        f"values within 1e-6; features a row {min(per_row)}-{max(per_row)} (at most {k})")
    if not (err <= 1e-4 and same and max(per_row) <= k and int(counts.sum()) <= 64 * k):
        fail(f"quality: sae_forward card against CPU: err {err}, counts equal {same}, per row {max(per_row)}")
    del cpu_params, cpu_rows, cpu_recon

    # one step under profiling.trace
    live = {key: v.clone().requires_grad_(True) for key, v in params.items()}
    opt = torch.optim.AdamW(list(live.values()), lr=q["sae_lr"], **sae.ADAMW_DEFAULTS)
    step = sae.make_sae_train_step(scfg, opt)
    batch = x[torch.from_numpy(np.random.default_rng(9).integers(0, len(x), b)).to(dev)]
    zero = torch.zeros(h, dtype=torch.int32, device=dev)
    step(live, batch, zero)  # the optimizer's state
    trace_dir = os.path.join(tmp, "trace_sae")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profiling.trace(trace_dir) as prof:
        with profiling.annotate("sae_step"):
            step(live, batch, zero)
    wall = (time.perf_counter() - t0) * 1e3
    (path,) = glob.glob(os.path.join(trace_dir, "*.json"))
    with open(path) as f:
        events_ = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events_ if e.get("cat") == "kernel")
    annotated = any(e.get("name") == "sae_step" for e in events_)
    log(f"quality: the profiled SAE step's trace ({os.path.getsize(path) / 2**20:.1f} MiB) holds "
        f"'sae_step' {annotated}, {kernels} kernel events")
    summary = device_summary(prof, wall, "profiled SAE step")
    if not annotated or not kernels:
        fail(f"quality: the SAE step's trace holds the annotation {annotated}, {kernels} kernel events")
    del live, opt, step

    # feature exemplars through the flat index over the library
    index = FlatIndex.build(library, [f"library/{i}.png" for i in range(len(library))], device=dev)

    def search(vec, n):
        s, i = index.search(vec, n)
        return [(float(a), index.filenames[j]) for a, j in zip(s[0], i[0])]

    features = np.argsort(-counters, kind="stable")[:8].tolist()
    exemplars = feature_exemplars(params, search, features, k=10)
    sheet = exemplar_sheet_html(exemplars, image_prefix="/")
    if len(exemplars) != 8 or sheet.count("<h3>") != 16 or sheet.count("<img") != 160:
        fail(f"quality: {len(exemplars)} features' exemplars, a sheet of {sheet.count('<img')} images")
    out["sae"] = {"hidden": h, "top_k": k, "batch": b, "steps": q["sae_steps"], "train_s": train_s,
                  "step_ms": step_ms, "tflop_per_step": flops / 1e12, "tflops": flops / step_ms / 1e9,
                  "peak_gib": peak, "features_fired": int((counters > 0).sum()),
                  "card_cpu_recon_err": err, "tie_rows": int(tie.sum()), "profile": summary,
                  "trace_kernel_events": kernels}
    del index, params, x


def fat_rows(attention, qkvf, n_heads: int, head_dim: int, s: int) -> dict:
    """The fat attention's two rows over one packed (B, SP, 3*H*C) qkvf:
    name -> (kernel call, plain call, library call, flops, bytes,
    tolerance, valid rows). The library call is SDPA with the key mask
    over each head's head_dim columns at scale 1 (q comes pre-scaled),
    the same function. Flops: Q.K^T sums all C columns;
    of P.V's, out = O[:, :d] / O[:, d] needs d + 1."""
    import torch
    import torch.nn.functional as F

    b, sp, hc3 = qkvf.shape
    hc = hc3 // 3
    c = hc // n_heads
    heads = qkvf.view(b, sp, 3, n_heads, c)[..., :head_dim]
    qh, kh, vh = (heads[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    qf, kf, vf = (qkvf[..., i * hc : (i + 1) * hc].contiguous() for i in range(3))
    key_ok = (torch.arange(sp, device=qkvf.device) < s)[None, None, None, :]
    flops = 2.0 * b * n_heads * sp * sp * (c + head_dim + 1)
    nbytes = qkvf.element_size() * (b * sp * hc3 + b * sp * n_heads * head_dim)

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=key_ok, scale=1.0)

    return {
        "fat_vit_mha_packed": (
            lambda: attention.fat_vit_mha_packed(qkvf, n_heads, head_dim),
            lambda: attention.fat_vit_mha_packed_plain(qkvf, n_heads, head_dim),
            library, flops, nbytes, ATTN_TOL, s,
        ),
        # the unpacked wrapper: the same kernel over three separate arrays
        "fat_vit_mha": (
            lambda: attention.fat_vit_mha(qf, kf, vf, n_heads, head_dim),
            lambda: attention.fat_vit_mha_plain(qf, kf, vf, n_heads, head_dim),
            library, flops, nbytes, ATTN_TOL, s,
        ),
    }


def fat_qkvf(gen, b: int, sp: int, n_valid: int, h: int, d: int):
    """A packed fat-layout (B, SP, 3*H*C) bf16 qkvf on the card, as the QKV
    projection emits it: q's features pre-scaled by 1/sqrt(d) with its
    constant 1, k's constant -1e30 on the pad rows (whose features are 0),
    v's constant 1; features from ``gen``."""
    import torch

    from meme_search_engine_tpu_torch.ops.attention import fat_width

    c = fat_width(d)
    f = torch.randn((b, sp, 3, h, c), generator=gen, device="cuda")
    f[..., d:] = 0
    f[:, :, 0, :, :d] *= d**-0.5
    f[:, :, 0, :, d] = 1
    f[:, n_valid:, 1] = 0
    f[:, n_valid:, 1, :, d] = -1e30
    f[:, :, 2, :, d] = 1
    return f.reshape(b, sp, 3 * h * c).to(torch.bfloat16)


def fat_bench(root: str) -> int:
    """``python3 chip_smoke.py --fat-bench [ROOT]``: the fat attention
    alone, from the package under ROOT (this checkout by default), at the
    image tower's shape with B = 128 beside SDPA, after a check against
    the plain version at B = 2; one JSON line, then the card's name and
    power limit. The input is a packed qkvf as the QKV projection emits
    it (q pre-scaled with its constant 1, k's constant -1e30 on pad rows,
    v's constant 1). For an A/B in one call, run it on the parent's
    checkout and on this one in turn: parent, change, change, parent."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.abspath(root))
    from meme_search_engine_tpu_torch.models import siglip
    from meme_search_engine_tpu_torch.ops import attention

    cfg = siglip.SO400M_14_384
    h, dh, s = cfg.num_heads, cfg.head_dim, cfg.num_patches
    sp = (s + 15) // 16 * 16
    gen = torch.Generator(device="cuda").manual_seed(0)

    def packed(b):
        return fat_qkvf(gen, b, sp, s, h, dh)

    out = {"root": os.path.abspath(root), "b": B_TIME}
    for name, (kern, plain, _lib, _f, _n, tol, rows) in fat_rows(attention, packed(B_CHECK), h, dh, s).items():
        err, _ = compare(kern(), plain(), tol, rows)
        if not err <= tol:
            fail(f"{name} disagrees with its plain version at B={B_CHECK}: max_abs_err {err}")
        out[f"{name}_max_abs_err_b{B_CHECK}"] = err
    big = fat_rows(attention, packed(B_TIME), h, dh, s)
    flops, nbytes = big["fat_vit_mha_packed"][3:5]
    exp_ms = B_TIME * h * sp * sp / PEAK_EXP * 1e3
    out["bounds_ms"] = {"products": flops / PEAK_FLOPS * 1e3, "exponentials": exp_ms,
                        "bytes": nbytes / PEAK_BW * 1e3}
    for name, fn in (("fat_vit_mha_packed", big["fat_vit_mha_packed"][0]),
                     ("fat_vit_mha", big["fat_vit_mha"][0]),
                     ("sdpa", big["fat_vit_mha"][2])):
        ms = time_ms(fn, reps=20)
        out[name] = {"ms": ms, "tflops": flops / ms / 1e9, "peak_share": flops / ms * 1e3 / PEAK_FLOPS}
    print(json.dumps(out), flush=True)
    print(nvidia_smi(), flush=True)
    return 0


def _bench_package(root: str):
    """Import the port's ops from the checkout under ROOT (its kernels build
    into ROOT's own build directory); fails without a card."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(root))
    from meme_search_engine_tpu_torch.ops import _build, adc, attention

    _build.build_all()
    return adc, attention


def mha_bench(root: str) -> int:
    """``python3 chip_smoke.py --mha-bench [ROOT]``: the fused attention
    kernel alone, from the package under ROOT (this checkout by default),
    at the text tower's (128, 64, 16, 72) and a single text's (1, 64, 16,
    72) beside SDPA, after a check against the plain version in all three
    stable modes at both shapes; one JSON line, then the card's name and
    power limit. For an A/B in one call: parent, change, change, parent."""
    import torch
    import torch.nn.functional as F

    _, attention = _bench_package(root)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": os.path.abspath(root)}
    for b in (B_TIME, 1):
        q, k, v = (torch.randn((b, 64, 16, 72), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        row = {}
        for stable in ("scalar", "row", "none"):
            err, _ = compare(attention.fused_mha(q, k, v, stable), attention.fused_mha_plain(q, k, v, stable),
                             ATTN_TOL)
            if not err <= ATTN_TOL:
                fail(f"fused_mha[{stable}] disagrees with its plain version at B={b}: max_abs_err {err}")
            row[f"max_abs_err_{stable}"] = err
        row["ms"] = time_ms(lambda: attention.fused_mha(q, k, v), reps=20, inner=20)
        row["sdpa_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), reps=20, inner=20)
        row["bound_ms"] = 2 * 4 * b * 64 * 16 * 72 / PEAK_BW * 1e3
        out[f"b{b}"] = row
    print(json.dumps(out), flush=True)
    print(nvidia_smi(), flush=True)
    return 0


def adc_bench(root: str) -> int:
    """``python3 chip_smoke.py --adc-bench [ROOT]``: the ADC kernel alone,
    from the package under ROOT (this checkout by default), at N = 1e6,
    M = 64, C = 256 with B = 1, 3 and 64 LUTs, each checked against the
    plain version at 1e-4 (over a ragged 1,000,003 rows) and timed; one JSON
    line, then the card's name and power limit. For an A/B in one call:
    parent, change, change, parent."""
    import torch

    adc, _ = _bench_package(root)
    gen = torch.Generator(device="cuda").manual_seed(0)
    codes = torch.randint(0, 256, (ADC_N, ADC_M), generator=gen, device="cuda", dtype=torch.uint8)
    luts = torch.randn((64, ADC_M, 256), generator=gen, device="cuda")
    timed = codes[:1_000_000]
    n = timed.shape[0]
    out = {"root": os.path.abspath(root), "n": n, "m": ADC_M}
    for b, inner in ((1, 20), (3, 10), (64, 2)):
        lt = luts[:b]
        err, ok = compare(adc.adc_scores_batched(codes, lt), adc.adc_scores_plain(codes, lt), ADC_TOL)
        if not ok:
            fail(f"adc_scores disagrees with its plain version at B={b}: max_abs_err {err}")
        t_bytes = (n * ADC_M + b * n * 4 + lt.numel() * 4) / PEAK_BW * 1e3
        t_ops = b * n * ADC_M / PEAK_SMEM_WORDS * 1e3
        out[f"b{b}"] = {"max_abs_err": err,
                        "ms": time_ms(lambda: adc.adc_scores_batched(timed, lt), reps=20, inner=inner),
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    print(json.dumps(out), flush=True)
    print(nvidia_smi(), flush=True)
    return 0


def proj_bench(root: str) -> int:
    """``python3 chip_smoke.py --proj-bench [ROOT]``: kernel 8 alone, from
    the package under ROOT (this checkout by default), on one image layer's
    shapes with B = 128 beside kernels 7 + 2 (the same function in two
    launches), after a check of both against the plain version at B = 2
    (valid rows, rtol = atol = 2e-2); one JSON line with each one's
    CUDA-event median, then the card's name and power limit. For an A/B in
    one call: parent, change, change, parent."""
    import torch

    _bench_package(root)
    from meme_search_engine_tpu_torch.models import siglip
    from meme_search_engine_tpu_torch.ops import attention, fused

    cfg = siglip.SO400M_14_384
    h, dh, s, d = cfg.num_heads, cfg.head_dim, cfg.num_patches, cfg.width
    sp = (s + 15) // 16 * 16
    gen = torch.Generator(device="cuda").manual_seed(0)
    wo = (torch.randn((h * dh, d), generator=gen, device="cuda") * (h * dh) ** -0.5).to(torch.bfloat16)
    bo = (torch.randn((d,), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    out = {"root": os.path.abspath(root), "b": B_TIME}
    for b in (B_CHECK, B_TIME):
        qkvf = fat_qkvf(gen, b, sp, s, h, dh)
        x = torch.randn((b, sp, d), generator=gen, device="cuda").to(torch.bfloat16)
        routes = {
            "kernel": lambda: attention.fat_vit_mha_packed_proj(qkvf, wo, bo, x, h, dh),
            "composed": lambda: fused.matmul_residual(attention.fat_vit_mha_packed(qkvf, h, dh), wo, bo, x),
        }
        if b == B_CHECK:
            want = attention.fat_vit_mha_packed_proj_plain(qkvf, wo, bo, x, h, dh)
            for name, fn in routes.items():
                err, ok = compare(fn(), want, ATTN_TOL, s)
                if not ok:
                    fail(f"{name} disagrees with kernel 8's plain version at B={b}: max_abs_err {err}")
                out[f"{name}_max_abs_err_b{b}"] = err
        else:
            out["ms"] = time_ms(routes["kernel"], reps=20)
            out["composed_ms"] = time_ms(routes["composed"], reps=20)
    print(json.dumps(out), flush=True)
    print(nvidia_smi(), flush=True)
    return 0


def gather_bench() -> int:
    """``python3 chip_smoke.py --gather-bench``: phase 3's gathered dots
    alone (``gathered_dots``: the checks, then the times of both kernels
    beside what they are compared with), one JSON line, then the card's
    name and power limit."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    from meme_search_engine_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    out = gathered_dots(dev, torch.Generator(device=dev).manual_seed(1234))
    print(json.dumps(out), flush=True)
    print(nvidia_smi(), flush=True)
    return 0


def check_kernel(name, b, kern, plain, tol, rows) -> float:
    """One kernel call against its plain version on the same inputs; fails
    the script where they disagree. ``rows``: None for every element at
    rtol = atol = tol, else the first rows of dim 1 at atol tol only
    (attention's valid rows, as tests/test_attention.py)."""
    import torch

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err, ok = compare(got, want, tol, rows)
    if rows is not None:
        ok = err <= tol
    log(f"check {name} B={b}: max_abs_err {err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version at B={b}: max_abs_err {err}")
    return err


def timed_row(name, b, kern, plain, lib, flops, nbytes, exp_ops=0.0) -> dict:
    """A kernel's CUDA-event time beside its plain version's, the library
    call's and its bound (the larger of its operations, or exponentials,
    over the card's peak and its bytes over the memory rate)."""
    inner = 20 if flops < 1e10 else 1  # a kernel of tens of microseconds
    t_k = time_ms(kern, reps=10, inner=inner)
    t_p = time_ms(plain, reps=3, inner=inner)
    t_l = time_ms(lib, reps=10, inner=inner)
    t_ops = max(flops / PEAK_FLOPS, exp_ops / PEAK_EXP) * 1e3
    t_bytes = nbytes / PEAK_BW * 1e3
    row = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "tflops": flops / t_k / 1e9, "peak_share": flops / t_k * 1e3 / PEAK_FLOPS}
    log(f"time {name} B={b}: kernel {t_k:.4f} ms, plain {t_p:.3f} ms, library {t_l:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), {row['tflops']:.1f} TFLOP/s = "
        f"{row['peak_share']:.1%} of the bf16 peak")
    return row


def gemm_weights(cfg, rn) -> dict:
    """One image layer's GEMM weights at SO400M widths, random (``rn``
    draws bf16 on the card), in the kernels' layouts: the packed fat QKV
    (N = 3 x 16 x 80) with its key mask, the MAP head's k|v (N = 2304), o,
    LN1's gamma and beta, fc1 and fc2 as drawn and padded to the hidden
    width of the kernels' tiles (4304 to 4352)."""
    import torch

    from meme_search_engine_tpu_torch.models import siglip
    from meme_search_engine_tpu_torch.ops import attention, fused

    d, h, dh = cfg.width, cfg.num_heads, cfg.head_dim

    def dense(d_in, d_out):
        return {"w": rn(d_in, d_out, std=d_in**-0.5), "b": rn(d_out, std=0.02)}

    attn_p = {n: dense(d, d) for n in "qkvo"}
    (wq, bq), (wk, bk), (wv, bv) = siglip._fat_qkv_weights(attn_p, h, dh)
    fc1, fc2 = dense(d, cfg.mlp_dim), dense(cfg.mlp_dim, d)
    w1, b1, w2 = (t.contiguous() for t in fused.pad_hidden(fc1["w"], fc1["b"], fc2["w"]))
    return {
        "attn_p": attn_p,
        "wqkv": torch.cat([wq, wk, wv], 1).contiguous(), "bqkv": torch.cat([bq, bk, bv]).contiguous(),
        "g1": (1 + rn(d, std=0.1)).contiguous(), "be1": rn(d, std=0.1),
        "fc1": fc1, "fc2": fc2, "w1": w1, "b1": b1, "w2": w2,
        "wkv": torch.cat([attn_p["k"]["w"], attn_p["v"]["w"]], 1).contiguous(),
        "bkv": torch.cat([attn_p["k"]["b"], attn_p["v"]["b"]]).contiguous(),
        "kmask": (cfg.num_patches, h, attention.fat_width(dh), dh),
    }


def gemm_cases(cfg, wt, x, attn_out) -> dict:
    """The image tower's GEMM launches on x (B, 736, 1152) and the
    attention's output: kernel 1 as QKV and as the MAP head's k|v, kernel 2
    as the o-projection, kernel 3 whole and as its two launches (LN + fc1 +
    gelu at the padded hidden width, fc2 + residual). name -> (kernel call,
    plain call, library call, flops, bytes, tolerance, rows compared: None,
    every row at rtol = atol = tolerance)."""
    import torch
    import torch.nn.functional as F

    from meme_search_engine_tpu_torch.ops import fused

    d = cfg.width
    m, mr, mp, nq = x.shape[0] * x.shape[1], cfg.mlp_dim, wt["w1"].shape[1], wt["wqkv"].shape[1]
    g1, be1, fc1, fc2, o = wt["g1"], wt["be1"], wt["fc1"], wt["fc2"], wt["attn_p"]["o"]
    x2 = x.reshape(m, d)
    h = fused.ln_matmul_plain(x, g1, be1, wt["w1"], wt["b1"], act="gelu")  # fc2's input
    el = 2  # bytes per bf16

    def ln():
        return F.layer_norm(x2, (d,), g1, be1, 1e-6)

    def ln_row(w, b, **kw):
        return (lambda: fused.ln_matmul(x, g1, be1, w, b, **kw),
                lambda: fused.ln_matmul_plain(x, g1, be1, w, b, **kw))

    return {
        "ln_matmul": (
            *ln_row(wt["wqkv"], wt["bqkv"], k_mask=wt["kmask"]),
            lambda: torch.addmm(wt["bqkv"], ln(), wt["wqkv"]),
            2.0 * m * d * nq, el * (m * d + d * nq + m * nq + 2 * d + nq), CHECK_TOL, None,
        ),
        "ln_matmul[map_kv]": (
            *ln_row(wt["wkv"], wt["bkv"]),
            lambda: torch.addmm(wt["bkv"], ln(), wt["wkv"]),
            2.0 * m * d * 2 * d, el * (m * d + d * 2 * d + m * 2 * d + 2 * d + 2 * d), CHECK_TOL, None,
        ),
        "matmul_residual": (
            lambda: fused.matmul_residual(attn_out, o["w"], o["b"], x),
            lambda: fused.matmul_residual_plain(attn_out, o["w"], o["b"], x),
            lambda: torch.addmm(x2, attn_out.reshape(m, d), o["w"]),
            2.0 * m * d * d, el * (3 * m * d + d * d + d), CHECK_TOL, None,
        ),
        # with x as the residual (b2 left out, as matmul_residual's yardstick)
        "ln_mlp_residual": (
            lambda: fused.ln_mlp_residual(x, g1, be1, wt["w1"], wt["b1"], wt["w2"], fc2["b"]),
            lambda: fused.ln_mlp_residual_plain(x, g1, be1, fc1["w"], fc1["b"], fc2["w"], fc2["b"]),
            lambda: torch.addmm(
                x2, F.gelu(torch.addmm(fc1["b"], ln(), fc1["w"]), approximate="tanh"), fc2["w"]),
            2.0 * 2 * m * d * mr, el * (2 * m * d + 2 * d * mr + mr + 3 * d), CHECK_TOL, None,
        ),
        # its two launches apart, at the padded hidden width: LN + fc1 +
        # gelu into the (rows, MP) scratch, then fc2 + b2 + x
        "ln_mlp_residual[fc1]": (
            *ln_row(wt["w1"], wt["b1"], act="gelu"),
            lambda: F.gelu(torch.addmm(wt["b1"], ln(), wt["w1"]), approximate="tanh"),
            2.0 * m * d * mp, el * (m * d + d * mp + m * mp + 2 * d + mp), CHECK_TOL, None,
        ),
        "ln_mlp_residual[fc2]": (
            lambda: fused.matmul_residual(h, wt["w2"], fc2["b"], x),
            lambda: fused.matmul_residual_plain(h, wt["w2"], fc2["b"], x),
            lambda: torch.addmm(x2, h.reshape(m, mp), wt["w2"]),
            2.0 * m * mp * d, el * (m * mp + mp * d + d + 2 * m * d), CHECK_TOL, None,
        ),
    }


def naflex_gemm_cases(cfg, wt, x, lens) -> dict:
    """Kernel 1 at the NaFlex tower's shapes, x (B, 1024, 1152): the packed
    fat QKV with each sequence's own key mask (``lens``, an int32 (B,)
    tensor) and LN + fc1 + gelu. As :func:`gemm_cases`' rows."""
    import torch
    import torch.nn.functional as F

    from meme_search_engine_tpu_torch.ops import attention, fused

    d, h, dh = cfg.width, cfg.num_heads, cfg.head_dim
    m, nq, mp = x.shape[0] * x.shape[1], wt["wqkv"].shape[1], wt["w1"].shape[1]
    g1, be1, x2, el = wt["g1"], wt["be1"], x.reshape(-1, d), 2
    kmask = (lens, h, attention.fat_width(dh), dh)

    def ln():
        return F.layer_norm(x2, (d,), g1, be1, 1e-6)

    return {
        "ln_matmul[naflex_qkv]": (
            lambda: fused.ln_matmul(x, g1, be1, wt["wqkv"], wt["bqkv"], k_mask=kmask),
            lambda: fused.ln_matmul_plain(x, g1, be1, wt["wqkv"], wt["bqkv"], k_mask=kmask),
            lambda: torch.addmm(wt["bqkv"], ln(), wt["wqkv"]),
            2.0 * m * d * nq, el * (m * d + d * nq + m * nq + 2 * d + nq), CHECK_TOL, None,
        ),
        "ln_mlp_residual[naflex_fc1]": (
            lambda: fused.ln_matmul(x, g1, be1, wt["w1"], wt["b1"], act="gelu"),
            lambda: fused.ln_matmul_plain(x, g1, be1, wt["w1"], wt["b1"], act="gelu"),
            lambda: F.gelu(torch.addmm(wt["b1"], ln(), wt["w1"]), approximate="tanh"),
            2.0 * m * d * mp, el * (m * d + d * mp + m * mp + 2 * d + mp), CHECK_TOL, None,
        ),
    }


def ln_copy_routes(cfg, wt, x) -> dict:
    """The LN GEMMs' other route, timed and run by no path: the LayerNorm
    written out first (``F.layer_norm`` into a bf16 copy that the GEMM
    reads back), then the kernel's no-LN form on the copy
    (``matmul_residual`` with a zero residual, whose reads it adds; no key
    mask for QKV, no gelu for fc1). Each kernel is held against the route
    timed in the same process: CUDA-event medians in ms."""
    import torch
    import torch.nn.functional as F

    from meme_search_engine_tpu_torch.ops import fused

    xn = F.layer_norm(x, (cfg.width,), wt["g1"], wt["be1"], 1e-6)
    out = {}
    for name, w, b in (("ln_matmul", wt["wqkv"], wt["bqkv"]), ("ln_mlp_residual[fc1]", wt["w1"], wt["b1"])):
        zero = torch.zeros((*x.shape[:2], w.shape[1]), dtype=torch.bfloat16, device=x.device)
        out[name] = {
            "layer_norm": time_ms(lambda: F.layer_norm(x, (cfg.width,), wt["g1"], wt["be1"], 1e-6), reps=10),
            "ss_gemm": time_ms(lambda: fused.matmul_residual(xn, w, b, zero), reps=10),
        }
        out[name]["total"] = out[name]["layer_norm"] + out[name]["ss_gemm"]
        del zero
    return out


def gemm_ptxas(build_log: dict):
    """ptxas's report (``-Xptxas -v``) for each instantiation of the GEMM
    kernel in gemm.cu's build output: "gemm_kernel<BN, LN>" -> its
    registers, spill stores and loads (bytes) and any C75xx note (such as
    C7512, wgmma serialised for want of registers) that names it. None,
    and a line in the log that says so, where this process built no
    gemm.cu (the library came from the build directory): there is no
    report to read then, and an empty one would read as "no spills"."""
    if "gemm" not in build_log:
        log("ptxas gemm.cu: no report, the library was loaded as built before "
            "(empty the build directory for one)")
        return None
    name_re = re.compile(r"gemm_kernelILi(\d+)ELb([01])E")
    report, current = {}, None
    for line in build_log["gemm"].splitlines():
        m = name_re.search(line)
        if m:
            key = f"gemm_kernel<{m.group(1)}, {'true' if m.group(2) == '1' else 'false'}>"
            entry = report.setdefault(key, {"registers": None, "spill_stores": None,
                                            "spill_loads": None, "notes": []})
            if re.search(r"\(C75\d\d\)", line):
                entry["notes"].append(line.strip())
            else:
                current = entry
            continue
        if current is None:
            continue
        if (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)):
            current["registers"] = int(m.group(1))
            current = None
    return report


def gemm_bench(root: str) -> int:
    """``python3 chip_smoke.py --gemm-bench [ROOT]``: the GEMM kernels alone,
    from the package under ROOT (this checkout by default): ptxas's report
    for each instantiation, then the image tower's GEMM launches
    (``gemm_cases``) checked against their plain versions at B = 2 and 128
    and timed at B = 128 beside the library call and the bound, the LN
    GEMMs' normalised-copy routes (``ln_copy_routes``), kernel 1 at the
    NaFlex tower's shapes where the package has it (``naflex_gemm_cases``)
    and kernels 1, 2 and 3 at the text routes' shapes
    (``text_kernel_cases``, 128 texts);
    one JSON line, then the card's name and power limit. For an A/B in
    one call: parent, change, change, parent."""
    import torch

    _bench_package(root)
    from meme_search_engine_tpu_torch.models import siglip
    from meme_search_engine_tpu_torch.ops import _build, attention

    cfg = siglip.SO400M_14_384
    gen = torch.Generator(device="cuda").manual_seed(1234)
    sp = (cfg.num_patches + 15) // 16 * 16

    def rn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

    out = {"root": os.path.abspath(root), "b": B_TIME, "ptxas": gemm_ptxas(_build.build_log)}
    if out["ptxas"] is not None:
        log(f"ptxas gemm.cu: {out['ptxas']}")
    wt = gemm_weights(cfg, rn)
    for b in (B_CHECK, B_TIME):
        x, ao = rn(b, sp, cfg.width), rn(b, sp, cfg.width)
        for name, (kern, plain, lib, flops, nbytes, tol, rows) in gemm_cases(cfg, wt, x, ao).items():
            err = check_kernel(name, b, kern, plain, tol, rows)
            if b == B_TIME:
                out[name] = {"max_abs_err": err, **timed_row(name, b, kern, plain, lib, flops, nbytes)}
    out["normalised_copy_route_ms"] = ln_copy_routes(cfg, wt, x)
    del x, ao, kern, plain, lib
    if "max_num_patches" in siglip.SigLIPConfig.__dataclass_fields__:
        # the NaFlex tower's LN GEMMs: 1024-row sequences, a key mask a sequence
        nf = siglip.SO400M_16_NAFLEX_1024
        for b in (B_CHECK, B_TIME):
            x = rn(b, nf.max_num_patches, nf.width)
            lens = torch.randint(960, nf.max_num_patches + 1, (b,), generator=gen, device="cuda",
                                 dtype=torch.int32)
            for name, (kern, plain, lib, flops, nbytes, tol, rows) in naflex_gemm_cases(
                    nf, wt, x, lens).items():
                err = check_kernel(name, b, kern, plain, tol, rows)
                if b == B_TIME:
                    out[name] = {"max_abs_err": err,
                                 **timed_row(name, b, kern, plain, lib, flops, nbytes)}
        del x, kern, plain, lib
    for name, (kern, plain, lib, flops, nbytes, exp_ops, tol, rows) in text_kernel_cases(cfg, rn, B_TIME).items():
        if name.startswith("fat_vit_mha"):
            continue
        err = check_kernel(name, B_TIME, kern, plain, tol, rows)
        out[name] = {"max_abs_err": err, **timed_row(name, B_TIME, kern, plain, lib, flops, nbytes)}
    print(json.dumps(out), flush=True)
    print(nvidia_smi(), flush=True)
    return 0


def text_kernel_cases(cfg, rn, b: int) -> dict:
    """Kernels 1, 2, 3 and 7 at the text routes' shapes, B texts of S = 64
    (B * 64 rows): the fused route's packed QKV (N = 3 x 1152 = 3456, no
    key mask), its o-projection and its MLP (hidden 4304 padded to 4352),
    and the fat route's QKV (N = 3 x 16 x 80, the key mask at n_valid =
    S) and attention over SP = 64, half a 128-row query tile a text.
    name -> (kernel call, plain call, library call, flops, bytes,
    exponentials, tolerance, rows compared)."""
    import torch
    import torch.nn.functional as F

    from meme_search_engine_tpu_torch.models import siglip
    from meme_search_engine_tpu_torch.ops import attention, fused

    d, s, h, m_real = cfg.text_width, cfg.text_len, cfg.text_num_heads, cfg.text_mlp_dim
    dh = d // h
    hc = h * attention.fat_width(dh)
    x, o_in = rn(b, s, d), rn(b, s, d)
    x2, m, el = x.reshape(-1, d), b * s, 2
    g, be = (1 + rn(d, std=0.1)).contiguous(), rn(d, std=0.1)

    def dense(i, o):
        return {"w": rn(i, o, std=i**-0.5), "b": rn(o, std=0.02)}

    attn = {n: dense(d, d) for n in "qkvo"}
    wqkv = torch.cat([attn[n]["w"] for n in "qkv"], 1).contiguous()
    bqkv = torch.cat([attn[n]["b"] for n in "qkv"]).contiguous()
    fat = siglip._fat_qkv_weights(attn, h, dh)
    wfat = torch.cat([w for w, _ in fat], 1).contiguous()
    bfat = torch.cat([bb for _, bb in fat]).contiguous()
    fc1, fc2 = dense(d, m_real), dense(m_real, d)
    w1, b1, w2 = (t.contiguous() for t in fused.pad_hidden(fc1["w"], fc1["b"], fc2["w"]))
    kmask = (s, h, attention.fat_width(dh), dh)
    qkvf = fused.ln_matmul_plain(x, g, be, wfat, bfat, k_mask=kmask)
    heads = qkvf.view(b, s, 3, h, -1)[..., :dh]
    qh, kh, vh = (heads[:, :, i].transpose(1, 2).contiguous() for i in range(3))

    def ln():
        return F.layer_norm(x2, (d,), g, be, 1e-6)

    return {
        "ln_matmul[text_qkv]": (
            lambda: fused.ln_matmul(x, g, be, wqkv, bqkv),
            lambda: fused.ln_matmul_plain(x, g, be, wqkv, bqkv),
            lambda: torch.addmm(bqkv, ln(), wqkv),
            2.0 * m * d * 3 * d, el * (m * d + 3 * d * d + 3 * m * d + 2 * d + 3 * d), 0.0,
            CHECK_TOL, None,
        ),
        "ln_matmul[text_fat_qkv]": (
            lambda: fused.ln_matmul(x, g, be, wfat, bfat, k_mask=kmask),
            lambda: fused.ln_matmul_plain(x, g, be, wfat, bfat, k_mask=kmask),
            lambda: torch.addmm(bfat, ln(), wfat),
            2.0 * m * d * 3 * hc, el * (m * d + 3 * d * hc + 3 * m * hc + 2 * d + 3 * hc), 0.0,
            CHECK_TOL, None,
        ),
        "matmul_residual[text_o]": (
            lambda: fused.matmul_residual(o_in, attn["o"]["w"], attn["o"]["b"], x),
            lambda: fused.matmul_residual_plain(o_in, attn["o"]["w"], attn["o"]["b"], x),
            lambda: torch.addmm(x2, o_in.reshape(m, d), attn["o"]["w"]),
            2.0 * m * d * d, el * (3 * m * d + d * d + d), 0.0, CHECK_TOL, None,
        ),
        "ln_mlp_residual[text]": (
            lambda: fused.ln_mlp_residual(x, g, be, w1, b1, w2, fc2["b"]),
            lambda: fused.ln_mlp_residual_plain(x, g, be, fc1["w"], fc1["b"], fc2["w"], fc2["b"]),
            lambda: torch.addmm(x2, F.gelu(torch.addmm(fc1["b"], ln(), fc1["w"]), approximate="tanh"),
                                fc2["w"]),
            4.0 * m * d * m_real, el * (2 * m * d + 2 * d * m_real + m_real + 3 * d), 0.0,
            CHECK_TOL, None,
        ),
        # every key valid, so SDPA without a mask at scale 1 (q pre-scaled)
        "fat_vit_mha_packed[text]": (
            lambda: attention.fat_vit_mha_packed(qkvf, h, dh),
            lambda: attention.fat_vit_mha_packed_plain(qkvf, h, dh),
            lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0),
            2.0 * b * h * s * s * (hc // h + dh + 1), el * (3 * m * hc + m * h * dh), float(b * h * s * s),
            ATTN_TOL, s,
        ),
    }


# The text tower's four routes (models/siglip.encode_text): the routing
# variables, cfg.attn_impl, and each kernel's launches a layer
_TEXT_VARS = ("MSE_TEXT_FUSED", "MSE_TEXT_QKV", "MSE_TEXT_O", "MSE_TEXT_MLP")
TEXT_ROUTES = {
    "default": ({}, "auto", {"fused_mha": 1}),
    "fused_xla": (dict(zip(_TEXT_VARS, ("1", "xla", "xla", "xla"))), "auto", {"fused_mha": 1}),
    "fused": (dict(zip(_TEXT_VARS, ("1", "fused", "fused", "fused"))), "auto",
              {"fused_mha": 1, "ln_matmul": 1, "matmul_residual": 1, "ln_mlp_residual": 1}),
    "fat": ({}, "fat_interpret",
            {"fat_vit_mha": 1, "ln_matmul": 1, "matmul_residual": 1, "ln_mlp_residual": 1}),
}


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def text_routes(engine, launch_counts, reset_counts, n_text: int = 2 * B_TIME) -> dict:
    """The ``text_routes`` phase: SO400M's text tower at full width and
    depth through the engine on ``n_text`` texts (two buckets of 128) by
    each route of ``TEXT_ROUTES``: (a) the default, (b) ``MSE_TEXT_FUSED=1``
    with the three sub-blocks ``xla``, (c) with all three ``fused``, (d)
    ``attn_impl="fat_interpret"``. Each route's exact launches a bucket,
    its embeddings against (a)'s (cos >= 0.999, max |d| logged) and three
    texts against the CPU plain path of the same route (cos >= 0.999),
    texts/s as the median of three; then kernels 1, 2, 3 and 7 at the
    routes' shapes, held against their plain versions at B = 2 and 128
    and timed at 128. Returns the phase's JSON object."""
    import copy
    import dataclasses

    import torch

    from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine, pow2_buckets

    t_phase = time.perf_counter()
    cfg = engine.cfg
    rng = np.random.default_rng(14)
    words = ["meme", "cat", "dog", "gpu", "tpu", "funny", "sad", "frog", "reaction", "image"]
    texts = [" ".join(rng.choice(words, size=rng.integers(1, 20))) for _ in range(n_text)]
    probe = [0, 129, n_text - 1]
    n_buckets = len(pow2_buckets(n_text, engine.max_batch))
    zero = {k: 0 for k in launch_counts()}
    cpu = EmbeddingEngine(engine.params, cfg, max_batch=4, device="cpu")
    saved = {k: os.environ.get(k) for k in _TEXT_VARS}
    out: dict = {"texts": n_text, "buckets": n_buckets, "routes": {}}
    ref = None
    try:
        for name, (env, impl, per_layer) in TEXT_ROUTES.items():
            for k in _TEXT_VARS:
                os.environ.pop(k, None)
            os.environ.update(env)
            route = copy.copy(engine)
            route.cfg = dataclasses.replace(cfg, attn_impl=impl)
            route.embed_texts(texts)  # builds the route's layout on its first use
            reset_counts()
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e = route.embed_texts(texts)
                times.append(time.perf_counter() - t0)
            counts = launch_counts()
            check_counts(f"text route {name}", counts,
                         {**zero, **{k: v * cfg.text_depth for k, v in per_layer.items()}}, 3 * n_buckets)
            if e.shape != (n_text, cfg.d_emb) or not np.isfinite(e).all():
                fail(f"text route {name}: bad output {e.shape}")
            ref = e if ref is None else ref
            cos, dmax = float((e * ref).sum(-1).min()), float(np.abs(e - ref).max())
            cpu_route = copy.copy(cpu)
            cpu_route.cfg = route.cfg
            cpu_cos = (cpu_route.embed_texts([texts[i] for i in probe]) * e[probe]).sum(-1)
            ms = float(np.median(times)) * 1e3
            out["routes"][name] = {
                "texts_per_s": n_text / ms * 1e3, "ms": ms, "times_ms": [t * 1e3 for t in times],
                "launches_per_bucket": {k: v // (3 * n_buckets) for k, v in counts.items() if v},
                "cos_min_vs_default": cos, "max_abs_diff_vs_default": dmax,
                "cpu_cos": [float(c) for c in cpu_cos],
            }
            log(f"text route {name}: {n_text} texts in {ms:.1f} ms (median of 3), "
                f"{n_text / ms * 1e3:.1f} texts/s; launches a bucket "
                f"{out['routes'][name]['launches_per_bucket']}; against the default route cos min "
                f"{cos:.6f}, max |d| {dmax:.3e}; against the CPU plain path cos {cpu_cos.round(6).tolist()}")
            if cos < 0.999 or not (cpu_cos >= 0.999).all():
                fail(f"text route {name} disagrees: cos {cos} against the default route, "
                     f"{cpu_cos.tolist()} against the CPU")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    del cpu
    txt = engine.params["txt"]
    mlp = txt["blocks"]["mlp"]
    out["weight_bytes"] = {
        "text_tower": _tree_bytes({k: v for k, v in txt.items() if k != "layouts"}),
        "text_mlp_padded": _tree_bytes(mlp),
        "text_mlp_unpadded": 2 * cfg.text_depth * cfg.text_width * cfg.text_mlp_dim * 2
        + cfg.text_depth * (cfg.text_mlp_dim + cfg.text_width) * 2,
        "fused_qkv": _tree_bytes(txt["layouts"].get("qkv", [])),
        "fat_qkv": _tree_bytes([blk["qkv"] for blk in txt["layouts"].get("fat", [])]),
    }
    log(f"text routes: weight bytes on the card {out['weight_bytes']}")

    gen = torch.Generator(device=engine.device).manual_seed(1414)

    def rn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=engine.device) * std).to(torch.bfloat16)

    kernels: dict = {}
    for b in (B_CHECK, B_TIME):
        for name, (kern, plain, lib, flops, nbytes, exps, tol, rows) in text_kernel_cases(cfg, rn, b).items():
            kernels.setdefault(name, {})[f"max_abs_err_b{b}"] = check_kernel(name, b, kern, plain, tol, rows)
            if b == B_TIME:
                kernels[name].update(timed_row(name, b, kern, plain, lib, flops, nbytes, exps))
        torch.cuda.empty_cache()
    out["kernels"] = kernels
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"text routes: the phase took {out['phase_s']:.1f} s")
    return out


def model_parallel(engine, launch_counts, reset_counts) -> dict:
    """The ``model_parallel`` phase: the SO400M engine (seed 0) over
    ``mesh=[[d, d]]`` with ``model_parallel=True``, ``d`` the engine's card,
    two model shards on one card: requests of 16 images and 16 texts against the
    single-device ``engine`` (rtol = atol = 2e-2 and cos >= 0.999, as
    tests/test_parallel.py:91-106), each kernel once a shard a layer (the
    MAP head's ``ln_matmul`` once a shard); the weight bytes of each
    shard; images/s at 128 and texts/s at 256 (median of three)."""
    import torch

    from meme_search_engine_tpu_torch.models import siglip
    from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine

    t_phase = time.perf_counter()
    cfg, dev = engine.cfg, engine.device
    mem0 = torch.cuda.memory_allocated()
    params = siglip.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tp = EmbeddingEngine(params, cfg, max_batch=engine.max_batch, mesh=[[dev, dev]], model_parallel=True)
    del params
    tree = tp.params
    shard_bytes = [_tree_bytes(tree["img"]["blocks"][c]) + _tree_bytes(tree["img"]["map_head"][c])
                   + _tree_bytes(tree["txt"]["blocks"][c]) for c in range(2)]
    shared = _tree_bytes({t: {k: v for k, v in tree[t].items() if k not in ("blocks", "map_head")}
                          for t in ("img", "txt")})
    log(f"model_parallel: 2 shards on {dev}, weight bytes a shard {shard_bytes} (blocks and MAP head), "
        f"{shared} held once (embeddings, final LN, head); the engine took "
        f"{(torch.cuda.memory_allocated() - mem0) / 2**30:.3f} GiB")
    rng = np.random.default_rng(15)
    r = cfg.image_size
    images = rng.integers(0, 256, (16, r, r, 3), dtype=np.uint8)
    words = ["meme", "cat", "dog", "gpu", "tpu", "funny", "sad", "frog", "reaction", "image"]
    texts = [" ".join(rng.choice(words, size=rng.integers(1, 12))) for _ in range(16)]
    zero = {k: 0 for k in launch_counts()}
    out = {"shards": 2, "weight_bytes_per_shard": shard_bytes, "weight_bytes_shared": shared}
    for kind, embed, single, item, per_bucket in (
        ("image", tp.embed_image_arrays, engine.embed_image_arrays, images,
         {"ln_matmul": 2 * cfg.depth + 2, "fat_vit_mha": 2 * cfg.depth,
          "matmul_residual": 2 * cfg.depth, "ln_mlp_residual": 2 * cfg.depth}),
        ("text", tp.embed_texts, engine.embed_texts, texts, {"fused_mha": 2 * cfg.text_depth}),
    ):
        reset_counts()
        got = embed(item)
        counts = launch_counts()
        check_counts(f"model_parallel {kind}", counts, {**zero, **per_bucket}, 1)
        want = single(item)
        err = float(np.abs(got - want).max())
        cos = float((got * want).sum(-1).min())
        ok = np.allclose(got, want, rtol=2e-2, atol=2e-2) and cos >= 0.999
        log(f"model_parallel {kind}: 16 against the single-device engine: max |d| {err:.3e}, "
            f"cos min {cos:.6f} {'ok' if ok else 'FAIL'}; launches {counts}")
        if not ok:
            fail(f"the model-parallel engine disagrees with one device on {kind}s: {err}, cos {cos}")
        out[kind] = {"max_abs_err": err, "cos_min": cos,
                     "launches": {k: v for k, v in counts.items() if v}}
    batch = rng.integers(0, 256, (B_TIME, r, r, 3), dtype=np.uint8)
    many = [" ".join(rng.choice(words, size=rng.integers(1, 20))) for _ in range(2 * B_TIME)]
    for kind, embed, item in (("images_per_s", tp.embed_image_arrays, batch),
                              ("texts_per_s", tp.embed_texts, many)):
        embed(item)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            embed(item)
            times.append(time.perf_counter() - t0)
        out[kind] = len(item) / float(np.median(times))
        out[f"{kind}_times_s"] = times
        log(f"model_parallel: {kind} {out[kind]:.1f} ({len(item)} a call, median of 3)")
    del tp, tree
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"model_parallel: the phase took {out['phase_s']:.1f} s")
    return out


def flash_check(dev) -> dict:
    """``ops.attention.flash_mha`` (plain torch, fp32, as the JAX package's
    XLA-only blocked attention) against ``mha_xla`` on the card at (2, 729,
    16, 72), rtol = atol = 2e-3 (tests/test_attention.py:35-39)."""
    import torch

    from meme_search_engine_tpu_torch.ops import attention

    gen = torch.Generator(device=dev).manual_seed(16)
    q, k, v = (torch.randn((2, 729, 16, 72), generator=gen, device=dev) for _ in range(3))
    got, want = attention.flash_mha(q, k, v), attention.mha_xla(q, k, v)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=2e-3, atol=2e-3))
    ms = time_ms(lambda: attention.flash_mha(q, k, v), reps=5)
    log(f"flash_mha (2, 729, 16, 72) fp32 against mha_xla: max |d| {err:.3e} {'ok' if ok else 'FAIL'}; "
        f"{ms:.3f} ms")
    if not ok:
        fail(f"flash_mha disagrees with mha_xla: {err}")
    return {"max_abs_err": err, "ms": ms}


def check_counts(kind, counts, per_bucket, n_buckets):
    """Each kernel's launches on a path: ``per_bucket[k]`` a bucket."""
    for k, n in per_bucket.items():
        if counts[k] != n * n_buckets:
            fail(f"{k} launched {counts[k]} times on the {kind} path, "
                 f"expected {n * n_buckets}")


def naflex_serve(launch_counts, reset_counts) -> dict:
    """SigLIP 2 SO400M/16 NaFlex at 1024 patches as users serve it: the
    clip server's ``build_engine`` by ``model_name``
    ("siglip2-so400m/16-naflex", random weights from seed 0), eight PNG
    pictures of eight aspect ratios (wide, tall, larger than the cap, a
    small one the decode enlarges) posted to ``make_app`` and sent through
    ``InProcessEmbedder``, each embedding against ``embed_image_list`` of
    that picture alone at its own grid (cos >= 0.999); ``/config`` must
    name the grid rule's numbers, no square; the fat attention and kernel
    1 launched as on the 384 px path, once a bucket. Returns the ``naflex`` JSON object."""
    import asyncio
    import io

    import msgpack
    import torch
    from aiohttp.test_utils import TestClient, TestServer
    from PIL import Image

    from meme_search_engine_tpu_torch.serving import clip_server, preprocess
    from meme_search_engine_tpu_torch.serving.client import InProcessEmbedder
    from meme_search_engine_tpu_torch.utils.fp16 import decode_fp16_buffer

    t_phase = time.perf_counter()
    engine = clip_server.build_engine({"model_name": "siglip2-so400m/16-naflex", "device": "cuda",
                                       "max_batch_size": 8})
    cfg = engine.cfg
    if (cfg.max_num_patches, cfg.patch_size, cfg.vocab_size) != (1024, 16, 256_000):
        fail(f"naflex: build_engine gave {cfg}")
    rng = np.random.default_rng(19)
    sizes = [(480, 1600), (1600, 480), (700, 700), (2400, 900), (96, 40), (333, 1000),
             (1200, 1180), (20, 300)]
    bodies, grids = [], []
    for h, w in sizes:
        small = rng.integers(0, 256, (max(h // 16, 2), max(w // 16, 2), 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(small).resize((w, h), Image.BILINEAR).save(buf, format="PNG")
        bodies.append(buf.getvalue())
        grids.append(preprocess.naflex_grid(h, w, 16, 1024))
    pics = [preprocess.decode_and_resize_naflex(b, 16, 1024) for b in bodies]
    alone = np.concatenate([engine.embed_image_list([p]) for p in pics])

    def worst_cos(got):
        return float(np.min(np.sum(got * alone, axis=1)
                            / np.linalg.norm(got, axis=1) / np.linalg.norm(alone, axis=1)))

    reset_counts()
    in_process = asyncio.run(InProcessEmbedder(engine).embed_image_bytes(bodies))
    torch.cuda.synchronize()
    check_counts("NaFlex in-process", launch_counts(),
                 {"ln_matmul": cfg.depth + 1, "matmul_residual": cfg.depth,
                  "ln_mlp_residual": cfg.depth, "fat_vit_mha": cfg.depth}, 1)

    async def drive():
        client = TestClient(TestServer(clip_server.make_app(engine, {"max_batch_size": 8})))
        await client.start_server()
        try:
            conf = msgpack.unpackb(await (await client.get("/config")).read(), raw=False)
            resp = await client.post("/", data=msgpack.packb({"images": bodies}))
            if resp.status != 200:
                fail(f"naflex: the clip server answered {resp.status}")
            body = msgpack.unpackb(await resp.read(), raw=False)
            return conf, np.stack([decode_fp16_buffer(b) for b in body])
        finally:
            await client.close()

    conf, served = asyncio.run(drive())
    if conf.get("image_size") is not None or (conf.get("patch_size"), conf.get("max_num_patches")) != (16, 1024):
        fail(f"naflex: /config {conf}")
    out = {"grids": grids, "cos_in_process": worst_cos(in_process), "cos_served": worst_cos(served),
           "phase_s": time.perf_counter() - t_phase}
    if min(out["cos_in_process"], out["cos_served"]) < 0.999:
        fail(f"naflex: a picture's embedding in a batch is not its own: {out}")
    log(f"naflex: grids {grids}; worst cos in process {out['cos_in_process']:.6f}, "
        f"through the clip server {out['cos_served']:.6f}; {out['phase_s']:.1f} s")
    del engine
    torch.cuda.empty_cache()
    return out


def naflex_only() -> int:
    """``python3 chip_smoke.py --naflex``: the ``naflex`` phase alone after
    the kernels' build; one JSON line, then the card's name and power
    limit."""
    smi, _, _, engine, launch_counts, reset_counts = _alone()
    del engine
    print(json.dumps({"naflex": naflex_serve(launch_counts, reset_counts)}), flush=True)
    print(smi, flush=True)
    return 0


def _alone():
    """For a phase run alone: the card's name and power limit, TF32 off,
    the kernels' build and a fresh SO400M engine (seed 0). Returns (smi,
    dev, cfg, engine, launch_counts, reset_counts)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    from meme_search_engine_tpu_torch.models import siglip
    from meme_search_engine_tpu_torch.ops import _build, adc, attention, fused, gather
    from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    cfg = siglip.SO400M_14_384
    engine = EmbeddingEngine(
        siglip.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev), cfg,
        max_batch=128, device="cuda")
    modules = (fused, attention, adc, gather)

    def launch_counts():
        return {k: v for m in modules for k, v in m.launches.items()}

    def reset_counts():
        for m in modules:
            m.reset_launches()

    return smi, dev, cfg, engine, launch_counts, reset_counts


def train_scrape() -> int:
    """``python3 chip_smoke.py --train-scrape``: the ``train``,
    ``sharded_search`` and ``scrape`` phases alone, on a fresh SO400M engine
    (seed 0) after the kernels' build; one JSON line, then the card's name
    and power limit."""
    smi, dev, cfg, engine, launch_counts, reset_counts = _alone()
    out = {"train": train(cfg, dev, launch_counts, reset_counts),
           "sharded_search": sharded_search(dev),
           "scrape": scrape(engine, launch_counts, reset_counts)}
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    return 0


def routes_only() -> int:
    """``python3 chip_smoke.py --routes``: the ``text_routes`` and
    ``model_parallel`` phases and the blocked attention's check alone, on a
    fresh SO400M engine (seed 0) after the kernels' build; one JSON line,
    then the card's name and power limit."""
    smi, _, _, engine, launch_counts, reset_counts = _alone()
    out = {"text_routes": text_routes(engine, launch_counts, reset_counts),
           "model_parallel": model_parallel(engine, launch_counts, reset_counts),
           "flash_mha": flash_check(engine.device)}
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    return 0


def quality_only() -> int:
    """``python3 chip_smoke.py --quality``: the ``quality`` phase alone, on
    a fresh SO400M engine (seed 0) after the kernels' build; one JSON line,
    then the card's name and power limit."""
    smi, dev, _, engine, launch_counts, reset_counts = _alone()
    print(json.dumps({"quality": quality(engine, dev, launch_counts, reset_counts, check_counts)}),
          flush=True)
    print(smi, flush=True)
    return 0


def main(disk_n: int = DISK_N) -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from meme_search_engine_tpu_torch.models import siglip
    from meme_search_engine_tpu_torch.ops import _build, adc, attention, fused, gather
    from meme_search_engine_tpu_torch.serving.clip_server import InferenceWorker
    from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine

    # -- 1. device -----------------------------------------------------------
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    if CARD not in kind:
        fail(f"no published peak for {kind!r}: this script's bounds are for the {CARD}")
    peak_flops, peak_bw = PEAK_FLOPS, PEAK_BW
    log(f"device: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; peaks {peak_flops:.4g} FLOP/s "
        f"{peak_bw:.4g} B/s")
    dev = torch.device("cuda")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, out in sorted(_build.build_log.items()):
        for line in out.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma", "setmaxnreg", "arning")):
                log(f"  ptxas {name}: {line.strip()}")
    gemm_report = gemm_ptxas(_build.build_log)
    for inst, rep in sorted((gemm_report or {}).items()):
        log(f"  ptxas {inst}: {rep}")

    # -- 3. kernel checks and timings ---------------------------------------
    cfg = siglip.SO400M_14_384
    D, H, DH = cfg.width, cfg.num_heads, cfg.head_dim
    C = attention.fat_width(DH)
    HC = H * C
    S = cfg.num_patches
    SP = ((S + 15) // 16) * 16
    TS, TH = cfg.text_len, cfg.text_num_heads
    TDH = cfg.text_width // TH
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    wt = gemm_weights(cfg, rn)
    attn_p = wt["attn_p"]

    def inputs(b):
        x = rn(b, SP, D)
        qkvf = fused.ln_matmul_plain(x, wt["g1"], wt["be1"], wt["wqkv"], wt["bqkv"], k_mask=wt["kmask"])
        attn_out = attention.fat_vit_mha_packed_plain(qkvf, H, DH)
        return x, qkvf, attn_out

    # name -> (kernel call, plain call, library call, flops, bytes,
    #          tolerance, rows compared: None for all rows with rtol = atol
    #          = tolerance; an int for attention, the first rows (the
    #          valid ones), atol only)
    def cases(b):
        x, qkvf, attn_out = inputs(b)
        rows = gemm_cases(cfg, wt, x, attn_out)
        return {"ln_matmul": rows["ln_matmul"], "ln_matmul[map_kv]": rows["ln_matmul[map_kv]"],
                **fat_rows(attention, qkvf, H, DH, S), **rows}

    def text_cases(b, s):
        """The fused attention kernel at the text tower's shapes: q/k/v
        (B, s, 16, 72) as the text encoder's projections give them, in
        the stable mode mha() uses ("scalar"). Every row is compared,
        atol only."""
        tq, tk, tv = (rn(b, s, TH, TDH) for _ in range(3))
        el = 2
        return {
            "fused_mha": (
                lambda: attention.fused_mha(tq, tk, tv),
                lambda: attention.fused_mha_plain(tq, tk, tv),
                lambda: F.scaled_dot_product_attention(
                    tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2)
                ),
                4.0 * b * TH * s * s * TDH,
                el * 4 * b * s * TH * TDH,
                ATTN_TOL, s,
            ),
        }

    check = check_kernel

    def all_cases(b):
        return {**cases(b), **text_cases(b, TS)}

    results = {}
    small = all_cases(B_CHECK)
    for name, (kern, plain, _lib, _f, _b, tol, rows) in small.items():
        err = check(name, B_CHECK, kern, plain, tol, rows)
        results[name] = {"max_abs_err": err, "tolerance": tol}
    # the fused attention kernel's other stable modes, and the longest
    # sequence mha() sends it on the main paths' towers (S=729, the image
    # tower's attn_impl="xla" route: more than one query block per head)
    tq, tk, tv = (rn(B_CHECK, TS, TH, TDH) for _ in range(3))
    for stable in ("row", "none"):
        results["fused_mha"][f"max_abs_err_{stable}"] = check(
            f"fused_mha[{stable}]", B_CHECK,
            lambda: attention.fused_mha(tq, tk, tv, stable),
            lambda: attention.fused_mha_plain(tq, tk, tv, stable), ATTN_TOL, TS,
        )
    lq, lk, lv = (rn(B_CHECK, S, TH, TDH) for _ in range(3))
    for stable in ("scalar", "row"):
        results["fused_mha"][f"max_abs_err_s{S}_{stable}"] = check(
            f"fused_mha[S={S}, {stable}]", B_CHECK,
            lambda: attention.fused_mha(lq, lk, lv, stable),
            lambda: attention.fused_mha_plain(lq, lk, lv, stable), ATTN_TOL, S,
        )
    del small, tq, tk, tv, lq, lk, lv
    torch.cuda.empty_cache()

    big = all_cases(B_TIME)
    for name, (kern, plain, lib, flops, nbytes, tol, rows) in big.items():
        # the timed launch geometry is held against the plain version too
        results[name]["max_abs_err_b128"] = check(name, B_TIME, kern, plain, tol, rows)
        inner = 20 if name == "fused_mha" else 1  # a kernel of tens of microseconds
        t_k = time_ms(kern, reps=10, inner=inner)
        t_p = time_ms(plain, reps=3, inner=inner)
        t_l = time_ms(lib, reps=10, inner=inner)
        t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        if name.startswith("fat_vit_mha"):
            # B * H * SP^2 scores, one exponential each: operations of the
            # special-function units, beside the products' on the tensor cores
            results[name]["exp_bound_ms"] = B_TIME * H * SP * SP / PEAK_EXP * 1e3
            t_ops = max(t_ops, results[name]["exp_bound_ms"])
        results[name].update(
            ms=t_k, plain_ms=t_p, library_ms=t_l,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            tflops=flops / t_k / 1e9,
            peak_share=flops / t_k * 1e3 / peak_flops,
        )
        log(f"time {name} B={B_TIME}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
            f"library {t_l:.3f} ms, bound {max(t_ops, t_bytes):.3f} ms "
            f"({results[name]['bound_by']}), {flops / t_k / 1e9:.1f} TFLOP/s = "
            f"{results[name]['peak_share']:.1%} of the bf16 peak")
        if name.startswith("fat_vit_mha"):
            log(f"  {name}: products' bound {flops / peak_flops * 1e3:.3f} ms, "
                f"exponentials' {results[name]['exp_bound_ms']:.3f} ms")
    del big, kern, plain, lib  # the closures hold the B=128 inputs
    # the fused attention kernel at a single text query's shape, (1, 64, 16, 72)
    oq, okk, ov = (rn(1, TS, TH, TDH) for _ in range(3))
    one = results["fused_mha"]
    one["max_abs_err_b1"] = check("fused_mha", 1, lambda: attention.fused_mha(oq, okk, ov),
                                  lambda: attention.fused_mha_plain(oq, okk, ov), ATTN_TOL, TS)
    one["ms_b1"] = time_ms(lambda: attention.fused_mha(oq, okk, ov), reps=10, inner=20)
    one["plain_ms_b1"] = time_ms(lambda: attention.fused_mha_plain(oq, okk, ov), reps=3, inner=20)
    one["library_ms_b1"] = time_ms(lambda: F.scaled_dot_product_attention(
        oq.transpose(1, 2), okk.transpose(1, 2), ov.transpose(1, 2)), reps=10, inner=20)
    one["bound_ms_b1"] = 2 * 4 * TS * TH * TDH / peak_bw * 1e3
    log(f"time fused_mha B=1: kernel {one['ms_b1']:.4f} ms, plain {one['plain_ms_b1']:.4f} ms, "
        f"library {one['library_ms_b1']:.4f} ms, bound {one['bound_ms_b1']:.5f} ms (bytes)")
    del oq, okk, ov
    # the LN GEMMs' other route, timed beside them and run by no path
    routes_ms = ln_copy_routes(cfg, wt, rn(B_TIME, SP, D))
    for name, r in routes_ms.items():
        results[name]["normalised_copy_route_ms"] = r
        log(f"time {name}'s normalised-copy route B={B_TIME}: F.layer_norm {r['layer_norm']:.3f} ms "
            f"+ SS GEMM {r['ss_gemm']:.3f} ms, against the kernel's {results[name]['ms']:.3f} ms")
    torch.cuda.empty_cache()

    # kernel 8, the attention fused with the o-projection and the residual:
    # no main path runs it (the towers run kernels 7 then 2, as the JAX
    # package's do), so it is held, on the image tower's layer shapes and
    # activations, against its plain version and against 7 + 2 on the
    # card, valid rows, rtol = atol = ATTN_TOL; then timed against both
    wo, bo = attn_p["o"]["w"], attn_p["o"]["b"]
    HD = H * DH

    def check_proj(what, b, got, want, rows=S):
        err, ok = compare(got, want, ATTN_TOL, rows)
        log(f"check {what} B={b}: max_abs_err {err:.3e} on the valid rows (rtol = atol = {ATTN_TOL}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{what} disagrees at B={b}: max_abs_err {err}")
        return err

    proj = {"tolerance": ATTN_TOL}
    proj["cluster"], proj["max_active_clusters"] = attention.fat_vit_mha_packed_proj_occupancy(H, DH, D)
    proj["ptxas"] = [line.strip() for line in _build.build_log.get("fat_attention_proj", "").splitlines()
                     if "registers" in line or "spill" in line]
    log(f"fat_vit_mha_packed_proj: clusters of {proj['cluster']} CTAs, "
        f"cudaOccupancyMaxActiveClusters {proj['max_active_clusters']}; ptxas: {proj['ptxas']}")
    for b, suffix in ((B_CHECK, ""), (B_TIME, "_b128")):
        x, qkvf, _ = inputs(b)
        kern = lambda: attention.fat_vit_mha_packed_proj(qkvf, wo, bo, x, H, DH)  # noqa: E731
        plain = lambda: attention.fat_vit_mha_packed_proj_plain(qkvf, wo, bo, x, H, DH)  # noqa: E731
        composed = lambda: fused.matmul_residual(attention.fat_vit_mha_packed(qkvf, H, DH), wo, bo, x)  # noqa: E731
        got = kern()
        proj[f"max_abs_err{suffix}"] = check_proj("fat_vit_mha_packed_proj", b, got, plain())
        proj[f"max_abs_err_composed{suffix}"] = check_proj(
            "fat_vit_mha_packed_proj against 7 + 2", b, got, composed())
        del got
    # the library's yardstick, two calls (no one PyTorch call computes this
    # function): SDPA with the key mask over (B, SP, H, DH) q/k/v viewed as
    # (B, H, SP, DH), whose output reshapes to rows in place, then addmm
    # with x as the residual (bo left out, as matmul_residual's yardstick)
    m = B_TIME * SP
    qkv4 = qkvf.view(B_TIME, SP, 3, H, C)[..., :DH]
    qs, ks, vs = (qkv4[:, :, i].contiguous() for i in range(3))
    key_ok = (torch.arange(SP, device=dev) < S)[None, None, None, :]
    x2 = x.reshape(m, D)

    def library():
        o = F.scaled_dot_product_attention(qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2),
                                           attn_mask=key_ok, scale=1.0)
        return torch.addmm(x2, o.transpose(1, 2).reshape(m, HD), wo)

    t_k = time_ms(kern, reps=10)
    t_p = time_ms(plain, reps=3)
    t_c = time_ms(composed, reps=10)
    t_l = time_ms(library, reps=10)
    # Q.K^T over C columns, P.V over the DH + 1 the output reads, Wo
    flops = 2.0 * B_TIME * H * SP * SP * (C + DH + 1) + 2.0 * m * HD * D
    nbytes = 2 * (m * 3 * HC + 2 * m * D + HD * D + D)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    proj.update(ms=t_k, plain_ms=t_p, composed_ms=t_c, library_ms=t_l,
                library_calls="F.scaled_dot_product_attention + torch.addmm, two calls",
                bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                tflops=flops / t_k / 1e9, peak_share=flops / t_k * 1e3 / peak_flops)
    log(f"time fat_vit_mha_packed_proj B={B_TIME}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
        f"7 + 2 composed {t_c:.3f} ms, library (SDPA + addmm, two calls) {t_l:.3f} ms, bound "
        f"{max(t_ops, t_bytes):.3f} ms ({proj['bound_by']}: operations {t_ops:.3f}, bytes "
        f"{t_bytes:.3f}), {flops / t_k / 1e9:.1f} TFLOP/s = {proj['peak_share']:.1%} of the bf16 peak")
    del x, qkvf, qkv4, qs, ks, vs, x2, kern, plain, composed
    # a ragged SP over two query blocks, the second holding one valid row:
    # SP = 200 with 129 valid rows, SO400M heads and Wo
    rq, rr = fat_qkvf(gen, B_CHECK, 200, 129, H, DH), rn(B_CHECK, 200, D)
    got = attention.fat_vit_mha_packed_proj(rq, wo, bo, rr, H, DH)
    proj["max_abs_err_sp200"] = check_proj(
        "fat_vit_mha_packed_proj [SP=200, 129 valid]", B_CHECK, got,
        attention.fat_vit_mha_packed_proj_plain(rq, wo, bo, rr, H, DH), 129)
    proj["max_abs_err_composed_sp200"] = check_proj(
        "fat_vit_mha_packed_proj against 7 + 2 [SP=200, 129 valid]", B_CHECK, got,
        fused.matmul_residual(attention.fat_vit_mha_packed(rq, H, DH), wo, bo, rr), 129)
    del rq, rr, got
    # the tiny geometries: tiny_test_config (C 24 -> 32, H*DH = DM = 64,
    # clusters of 2) and tiny_fat_test_config (C 8 -> 16, H*DH = DM = 112,
    # clusters of 8), 4 valid rows of 16
    for tag, (th, td) in {"tiny": (4, 16), "tiny_fat": (16, 7)}.items():
        tq = fat_qkvf(gen, B_CHECK, 16, 4, th, td)
        tw, tb, tr = rn(th * td, th * td, std=(th * td) ** -0.5), rn(th * td, std=0.02), rn(B_CHECK, 16, th * td)
        got = attention.fat_vit_mha_packed_proj(tq, tw, tb, tr, th, td)
        proj[f"max_abs_err_{tag}"] = check_proj(
            f"fat_vit_mha_packed_proj [{tag}]", B_CHECK, got,
            attention.fat_vit_mha_packed_proj_plain(tq, tw, tb, tr, th, td), 4)
        proj[f"max_abs_err_composed_{tag}"] = check_proj(
            f"fat_vit_mha_packed_proj against 7 + 2 [{tag}]", B_CHECK, got,
            fused.matmul_residual(attention.fat_vit_mha_packed(tq, th, td), tw, tb, tr), 4)
    results["fat_vit_mha_packed_proj"] = proj
    torch.cuda.empty_cache()

    # the ADC kernel: N = 1,000,003 codes (a ragged last tile), LUTs of 256
    codes = torch.randint(0, 256, (ADC_N, ADC_M), generator=gen, device=dev, dtype=torch.uint8)
    luts = torch.randn((64, ADC_M, 256), generator=gen, device=dev)
    small_codes = torch.randint(0, 256, (300, 16), generator=gen, device=dev, dtype=torch.uint8)
    small_luts = torch.randn((3, 16, 256), generator=gen, device=dev)
    narrow_luts = torch.randn((3, ADC_M, 16), generator=gen, device=dev)  # codes >= 16 score 0
    adc_errs = {}
    for key, cd, lt in (
        ("max_abs_err", codes, luts[:1]),
        ("max_abs_err_b64", codes, luts),
        ("max_abs_err_n300_m16_b3", small_codes, small_luts),
        ("max_abs_err_c16", codes[:100_003], narrow_luts),
    ):
        adc_errs[key] = check(f"adc_scores {key}", lt.shape[0],
                              lambda: adc.adc_scores_batched(cd, lt),
                              lambda: adc.adc_scores_plain(cd, lt), ADC_TOL, None)
    results["adc_scores"] = {**adc_errs, "tolerance": ADC_TOL}
    timed_codes = codes[:1_000_000]
    n_t = timed_codes.shape[0]
    # the library's call for the same function: bag n sums rows
    # codes[n, m] + 256 m of the (M * 256, B) table of zero-padded LUTs
    bag_idx = timed_codes.long() + torch.arange(ADC_M, device=dev) * 256
    for b, inner, suffix in ((1, 20, ""), (64, 2, "_b64")):
        lt = luts[:b]
        table = F.pad(lt, (0, 256 - lt.shape[-1])).permute(1, 2, 0).reshape(ADC_M * 256, b).contiguous()
        results["adc_scores"][f"library_max_abs_err{suffix}"] = check(
            f"embedding_bag (library) B={b}", b,
            lambda: F.embedding_bag(bag_idx, table, mode="sum").T,
            lambda: adc.adc_scores_plain(timed_codes, lt), ADC_TOL, None)
        t_k = time_ms(lambda: adc.adc_scores_batched(timed_codes, lt), reps=10, inner=inner)
        t_p = time_ms(lambda: adc.adc_scores_plain(timed_codes, lt), reps=3)
        t_l = time_ms(lambda: F.embedding_bag(bag_idx, table, mode="sum"), reps=10, inner=inner)
        t_bytes = (n_t * ADC_M + b * n_t * 4 + lt.numel() * 4) / peak_bw * 1e3
        t_ops = b * n_t * ADC_M / PEAK_SMEM_WORDS * 1e3
        results["adc_scores"].update({
            f"ms{suffix}": t_k, f"plain_ms{suffix}": t_p, f"library_ms{suffix}": t_l,
            f"bound_ms{suffix}": max(t_ops, t_bytes),
            f"bound_by{suffix}": "operations" if t_ops >= t_bytes else "bytes",
        })
        log(f"time adc_scores B={b} N={n_t}: kernel {t_k:.4f} ms, plain {t_p:.3f} ms, "
            f"library (embedding_bag) {t_l:.4f} ms, "
            f"bound {max(t_ops, t_bytes):.4f} ms ({results['adc_scores'][f'bound_by{suffix}']}: "
            f"bytes {t_bytes:.4f}, lookups {t_ops:.4f}), "
            f"{b * n_t * ADC_M / t_k / 1e9:.1f} G lookups/s")
    # both routes of the kernel at ragged N: M = 32, 64 and 128 take the
    # conflict-free one, M = 48 the other; B = 1, 3 and 64 (groups of three
    # queries a CTA, and a last group of one)
    edges = {}
    for m_ in ADC_EDGE_M:
        cd = torch.randint(0, 256, (ADC_EDGE_N, m_), generator=gen, device=dev, dtype=torch.uint8)
        lt_all = torch.randn((64, m_, 256), generator=gen, device=dev)
        for b in (1, 3, 64):
            lt = lt_all[:b]
            key = f"m{m_}_b{b}"
            err = check(f"adc_scores {key} N={ADC_EDGE_N}", b, lambda: adc.adc_scores_batched(cd, lt),
                        lambda: adc.adc_scores_plain(cd, lt), ADC_TOL, None)
            edges[key] = {"max_abs_err": err,
                          "ms": time_ms(lambda: adc.adc_scores_batched(cd, lt), reps=5, inner=2)}
            log(f"time adc_scores {key} N={ADC_EDGE_N}: kernel {edges[key]['ms']:.4f} ms")
    results["adc_scores"]["edges"] = {"n": ADC_EDGE_N, **edges}
    del cd, lt_all, lt
    del codes, luts, small_codes, small_luts, narrow_luts, timed_codes, bag_idx, table
    torch.cuda.empty_cache()

    # the row gather: bit-equal to its plain version (tolerance 0)
    def ids(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    gx = rn(GATHER_N, D)
    gx8 = torch.randint(-127, 128, (GATHER_N, D), generator=gen, device=dev, dtype=torch.int8)
    huge = torch.empty((1_000_000, D), device=dev, dtype=torch.bfloat16)  # 2.3 GB, past 2^31 B
    huge[-1000:] = rn(1000, D)
    hop_ids, prune_ids = ids(GATHER_HOP, 0, GATHER_N), ids(GATHER_PRUNE, 0, GATHER_N)
    wild = ids((64, 50), -100_000, GATHER_N + 100_000)
    wild[0, :2] = torch.tensor([-(2**31), 2**31 - 1], dtype=torch.int32)
    gather_cases = {
        "hop_bf16": (gx, hop_ids),
        "prune_bf16": (gx, prune_ids),
        "hop_int8": (gx8, hop_ids),
        "64bit_offsets": (huge, ids((256, 100), 1_000_000 - 1000, 1_000_000)),
        "d32_int8": (gx8[:, :32].contiguous(), ids((64, 50), 0, GATHER_N)),
        "d72_int8": (gx8[:, :72].contiguous(), ids((64, 50), 0, GATHER_N)),
        "ids_3x50": (gx, ids((3, 50), 0, GATHER_N)),
        "ids_1x1": (gx, ids((1, 1), 0, GATHER_N)),
        "out_of_range_clamped": (gx, wild),
        "no_ids": (gx, ids((0, 128), 0, GATHER_N)),
    }
    gather_err = 0.0
    for key, (gv, gi) in gather_cases.items():
        gather.reset_launches()
        got = gather.gather_rows(gv, gi)
        torch.cuda.synchronize()
        want = gather.gather_rows_plain(gv, gi)  # the plain version clamps too
        ok = got.shape == want.shape and torch.equal(got, want)
        if got.numel():
            gather_err = max(gather_err, float((got.float() - want.float()).abs().max()))
        launched = gather.launches["gather_rows"]
        ok = ok and launched == (1 if gi.numel() else 0)
        log(f"check gather_rows {key} {tuple(gv.shape)} {gv.dtype} ids {tuple(gi.shape)}: "
            f"bit-equal {torch.equal(got, want)}, launches {launched} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"gather_rows disagrees with its plain version or launched {launched} times: {key}")
    results["gather_rows"] = {"max_abs_err": gather_err, "tolerance": 0.0, "checked": list(gather_cases)}
    del huge, wild, gather_cases, got, want
    torch.cuda.empty_cache()
    for gi, inner, suffix in ((hop_ids, 20, ""), (prune_ids, 4, "_prune")):
        flat = gi.reshape(-1)
        b, k = gi.shape
        t_k = time_ms(lambda: gather.gather_rows(gx, gi), reps=10, inner=inner)
        t_p = time_ms(lambda: gather.gather_rows_plain(gx, gi), reps=5, inner=inner)
        t_l = time_ms(lambda: torch.index_select(gx, 0, flat).view(b, k, D), reps=10, inner=inner)
        # each distinct row read once, the output written once, the ids read
        row_bytes = D * gx.element_size()
        distinct = int(torch.unique(flat).numel())
        nbytes = (distinct + gi.numel()) * row_bytes + gi.numel() * 4
        results["gather_rows"].update({
            f"ms{suffix}": t_k, f"plain_ms{suffix}": t_p, f"library_ms{suffix}": t_l,
            f"bound_ms{suffix}": nbytes / peak_bw * 1e3, f"bound_by{suffix}": "bytes",
            f"distinct_rows{suffix}": distinct,
        })
        log(f"time gather_rows ids {tuple(gi.shape)} from {GATHER_N} x {D} bf16: kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms, library (index_select) {t_l:.4f} ms, bound "
            f"{nbytes / peak_bw * 1e3:.4f} ms (bytes: {distinct} distinct rows read, "
            f"{gi.numel()} written), {gi.numel() * row_bytes / t_k / 1e6:.1f} GB/s written")
    del gx, gx8, hop_ids, prune_ids, flat
    torch.cuda.empty_cache()
    results.update(gathered_dots(dev, gen))

    # -- 4. main path at full width -----------------------------------------
    from meme_search_engine_tpu_torch.serving.engine import pow2_buckets

    t0 = time.perf_counter()
    mem0 = torch.cuda.memory_allocated()
    params = siglip.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = {k: siglip.param_count(params[k]) for k in ("img", "txt")}
    engine = EmbeddingEngine(params, cfg, max_batch=128, device="cuda")
    del params
    log(f"main path: SO400M params {n_params['img'] / 1e6:.1f} M (image tower), "
        f"{n_params['txt'] / 1e6:.1f} M (text tower), built in "
        f"{time.perf_counter() - t0:.1f} s; the engine's weights take "
        f"{(torch.cuda.memory_allocated() - mem0) / 2**30:.3f} GiB on the card "
        f"({mem0 / 2**30:.3f} GiB allocated before); tokenizer "
        f"{type(engine.tokenizer).__name__}")
    worker = InferenceWorker(engine, "siglip-so400m/14@384")
    rng = np.random.default_rng(0)
    r = cfg.image_size
    done: "queue.Queue" = queue.Queue()

    def launch_counts():
        return {**fused.launches, **attention.launches, **adc.launches, **gather.launches}

    def reset_counts():
        fused.reset_launches()
        attention.reset_launches()
        adc.reset_launches()
        gather.reset_launches()

    def serve(kind, requests):
        """Submit every request to the worker with the counts set to 0;
        returns the outputs and the launch counts of this run."""
        reset_counts()
        t0 = time.perf_counter()
        for i, payload in enumerate(requests):
            worker.submit(kind, payload, lambda ok, v, i=i: done.put((i, ok, v)))
        outs = {}
        for _ in requests:
            i, ok, v = done.get(timeout=600)
            if not ok:
                fail(f"{kind} request {i} failed: {v}")
            outs[i] = v
        counts = launch_counts()
        n_buckets = sum(len(pow2_buckets(len(x), engine.max_batch)) for x in requests)
        log(f"main path ({kind}): {len(requests)} requests, {n_buckets} buckets, "
            f"{time.perf_counter() - t0:.1f} s, launches {counts}")
        return outs, counts, n_buckets

    def check_embeddings(what, e, n):
        if e.shape != (n, cfg.d_emb) or not np.isfinite(e).all():
            fail(f"{what}: bad output shape {e.shape} or non-finite values")
        nrm = np.linalg.norm(e, axis=-1)
        if np.abs(nrm - 1).max() > 1e-3:
            fail(f"{what}: norms {nrm}")

    # images
    requests = [
        rng.integers(0, 256, (1, r, r, 3), dtype=np.uint8),
        rng.integers(0, 256, (7, r, r, 3), dtype=np.uint8),
        rng.integers(0, 256, (16, r, r, 3), dtype=np.uint8),
        rng.integers(0, 256, (1, 500, 400, 3), dtype=np.uint8),
    ]
    outs, counts, n_buckets = serve("image", requests)
    check_counts("image", counts, {
        "ln_matmul": cfg.depth + 1,
        "matmul_residual": cfg.depth,
        "ln_mlp_residual": cfg.depth,
        "fat_vit_mha": cfg.depth,
        "fused_mha": 0,
        "fat_vit_mha_packed_proj": 0,
        "adc_scores": 0,
        "gather_rows": 0,
        "gather_dot": 0,
        "gather_gram": 0,
    }, n_buckets)
    for i, imgs in enumerate(requests):
        check_embeddings(f"image request {i}", outs[i], len(imgs))

    # texts: as a user types them, through the hash tokenizer
    words = ["meme", "cat", "dog", "gpu", "tpu", "funny", "sad", "frog", "reaction", "image"]
    text_requests = [
        [" ".join(rng.choice(words, size=rng.integers(1, 12))) for _ in range(n)]
        for n in (1, 7, 16)
    ]
    text_outs, text_counts, n_text_buckets = serve("text", text_requests)
    check_counts("text", text_counts, {
        "fused_mha": cfg.text_depth,
        "ln_matmul": 0,
        "matmul_residual": 0,
        "ln_mlp_residual": 0,
        "fat_vit_mha": 0,
        "fat_vit_mha_packed_proj": 0,
        "adc_scores": 0,
        "gather_rows": 0,
        "gather_dot": 0,
        "gather_gram": 0,
    }, n_text_buckets)
    for i, texts in enumerate(text_requests):
        check_embeddings(f"text request {i}", text_outs[i], len(texts))
    worker.stop(timeout=60)

    # one full image batch through the engine
    batch = rng.integers(0, 256, (B_TIME, r, r, 3), dtype=np.uint8)
    engine.embed_image_arrays(batch)  # warm the allocator at this size
    fused.reset_launches()
    attention.reset_launches()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch_out = engine.embed_image_arrays(batch)
        times.append(time.perf_counter() - t0)
    batch_ms = float(np.median(times)) * 1e3
    per_batch = {k: v // 3 for k, v in launch_counts().items()}
    check_embeddings(f"batch of {B_TIME}", batch_out, B_TIME)

    # a 256-text request: two buckets of 128
    n_text = 2 * B_TIME
    text_batch = [" ".join(rng.choice(words, size=rng.integers(1, 20))) for _ in range(n_text)]
    engine.embed_texts(text_batch)  # warm the allocator at this size
    attention.reset_launches()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text_out = engine.embed_texts(text_batch)
        times.append(time.perf_counter() - t0)
    text_ms = float(np.median(times)) * 1e3
    text_launches = attention.launches["fused_mha"] // 3
    check_embeddings(f"text request of {n_text}", text_out, n_text)
    text_buckets = len(pow2_buckets(n_text, engine.max_batch))
    if text_launches != text_buckets * cfg.text_depth:
        fail(f"fused_mha launched {text_launches} times per {n_text} texts, "
             f"expected {text_buckets * cfg.text_depth}")

    # one text layer's parts at B=128 (the engine's layer-0 weights), each
    # timed as the encoder runs it; x stands in for the residual stream
    blk = siglip._layers(engine.params["txt"]["blocks"])[0]
    x = rn(B_TIME, TS, cfg.text_width)
    parts = {
        "layer_norm": (2, lambda: siglip._layer_norm(x, blk["ln1"])),
        "dense q,k,v,o": (4, lambda: siglip._dense(x, blk["attn"]["q"])),
        "mlp (fc1, gelu, fc2)": (1, lambda: siglip._mlp(x, blk["mlp"])),
        "residual add": (2, lambda: x + x),
    }
    split = {k: n * time_ms(fn, reps=5) * cfg.text_depth for k, (n, fn) in parts.items()}
    split["fused_mha"] = results["fused_mha"]["ms"] * cfg.text_depth
    split_total = sum(split.values())
    text_kernel_ms = results["fused_mha"]["ms"] * text_launches
    del x, blk

    # the same weights on the CPU, through the plain versions: one image of
    # a small request, the resized one, and one of the timed batch of 128;
    # likewise three texts
    cpu_engine = EmbeddingEngine(engine.params, cfg, max_batch=1, device="cpu")

    def cpu_check(what, embed, item, card):
        t0 = time.perf_counter()
        cos = float(embed(item)[0] @ card)
        log(f"cpu reference: {what}: cos {cos:.6f} ({time.perf_counter() - t0:.1f} s on the CPU)")
        if not cos >= 0.999:
            fail(f"card and CPU embeddings disagree on {what}: cos {cos}")
        return cos

    coss = [
        cpu_check("request 1 image 3", cpu_engine.embed_image_arrays, requests[1][3:4], outs[1][3]),
        cpu_check("request 3 image 0 (500x400)", cpu_engine.embed_image_arrays,
                  requests[3][0:1], outs[3][0]),
        cpu_check(f"batch of {B_TIME} image 77", cpu_engine.embed_image_arrays,
                  batch[77:78], batch_out[77]),
    ]
    text_coss = [
        cpu_check("text request 0 text 0", cpu_engine.embed_texts,
                  text_requests[0][:1], text_outs[0][0]),
        cpu_check("text request 1 text 5", cpu_engine.embed_texts,
                  text_requests[1][5:6], text_outs[1][5]),
        cpu_check(f"text request of {n_text} text 200", cpu_engine.embed_texts,
                  text_batch[200:201], text_out[200]),
    ]
    del cpu_engine
    kernel_ms = sum(
        results[k]["ms"] * per_batch[k]
        for k in ("matmul_residual", "ln_mlp_residual")
    ) + results["ln_matmul"]["ms"] * cfg.depth + results["ln_matmul[map_kv]"]["ms"] \
        + results["fat_vit_mha_packed"]["ms"] * per_batch["fat_vit_mha"]
    log(f"engine B={B_TIME}: {batch_ms:.1f} ms/batch (median of 3), "
        f"{B_TIME / batch_ms * 1e3:.1f} images/s; kernels' share (from their timed "
        f"ms x launches) {kernel_ms:.1f} ms = {kernel_ms / batch_ms:.1%}")
    log(f"engine texts: {n_text} texts in {text_ms:.1f} ms (median of 3), "
        f"{n_text / text_ms * 1e3:.1f} texts/s; fused_mha's share (timed ms x "
        f"{text_launches} launches) {text_kernel_ms:.2f} ms = {text_kernel_ms / text_ms:.1%}")
    log(f"text layer split per bucket of {B_TIME} (ms, {cfg.text_depth} layers): " + ", ".join(
        f"{k} {v:.2f}" for k, v in split.items())
        + f"; sum {split_total:.1f} ms of {text_ms / text_buckets:.1f} ms per bucket")
    log(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # the text tower's other routes, the model-parallel engine and the
    # blocked attention
    routes = text_routes(engine, launch_counts, reset_counts)
    mp = model_parallel(engine, launch_counts, reset_counts)
    flash = flash_check(dev)

    # the small-scale service on the same engine
    svc = service(engine, dev, reset_counts, launch_counts, check_counts)
    del worker, batch_out, text_out
    torch.cuda.empty_cache()

    # the train step, the sharded search and the scraper through the clip
    # server on the same engine
    train_paths = {"train": train(cfg, dev, launch_counts, reset_counts),
               "sharded_search": sharded_search(dev),
               "scrape": scrape(engine, launch_counts, reset_counts)}

    # the quality model, the rater stack and the SAE at the reference's
    # widths; the crawl is embedded by the same engine
    qual = quality(engine, dev, launch_counts, reset_counts, check_counts)

    # SigLIP 2 NaFlex through the clip server and the in-process embedder
    naflex = naflex_serve(launch_counts, reset_counts)

    # quantizers at the deployment size of docs/scale1m_report.json, through
    # the port's tool as a user runs it; the training and encoding stages
    # are timed by wrapping the functions the tool calls
    from meme_search_engine_tpu_torch.index import opq, rabitq, scalar
    from meme_search_engine_tpu_torch.tools import quantizer_bench

    stages: dict = {}

    def timed(owner, name, into, calls=None):
        """Wrap ``owner.name`` to add its synchronised host seconds to
        ``into[name]`` and, with ``calls``, its calls to ``calls[name]``
        (a greedy search's hops to ``calls["hops"]``, the products a
        stitch asked of ``gather_dot`` to ``calls["stitch_products"]``);
        returns the function it replaced."""
        fn = getattr(owner, name)

        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if calls is not None and name == "robust_stitch":
                # the stitch multiplies only when the build left base->query
                # edges: count the products it asks for while it runs
                dot = owner._gather.gather_dot

                def counted(*da, **dk):
                    calls["stitch_products"] = calls.get("stitch_products", 0) + 1
                    return dot(*da, **dk)

                owner._gather.gather_dot = counted
                try:
                    out = fn(*a, **k)
                finally:
                    owner._gather.gather_dot = dot
            else:
                out = fn(*a, **k)
            torch.cuda.synchronize()
            into[name] = into.get(name, 0.0) + time.perf_counter() - t0
            if calls is not None:
                calls[name] = calls.get(name, 0) + 1
                if name == "_batched_greedy_search":
                    calls["hops"] = calls.get("hops", 0) + out[2]
            return out

        setattr(owner, name, wrapper)
        return fn

    wrapped = [(o, n, timed(o, n, stages)) for o, n in (
        (opq, "train_opq"), (opq.ProductQuantizer, "asymmetric_dot"),
        (rabitq, "train_rabitq"), (scalar, "train_scalar_quantizer"))]
    n_corpus = 1_000_000
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = quantizer_bench.main(["--n", str(n_corpus)])
    torch.cuda.synchronize()
    q_wall = time.perf_counter() - t0
    q_counts = launch_counts()
    for o, n, fn in wrapped:
        setattr(o, n, fn)
    q_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"quantizer path: N={n_corpus} d={run.x.shape[1]} in {q_wall:.1f} s; stages (s) "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f"; launches {q_counts}; peak memory {q_peak:.1f} GiB")
    if run.x.shape != (n_corpus, cfg.d_emb) or run.x.device.type != "cuda":
        fail(f"quantizer corpus {tuple(run.x.shape)} on {run.x.device}")
    check_counts("quantizer", q_counts, {
        "adc_scores": len(run.q), "ln_matmul": 0, "matmul_residual": 0,
        "ln_mlp_residual": 0, "fat_vit_mha": 0, "fused_mha": 0, "gather_rows": 0,
        "gather_dot": 0, "gather_gram": 0, "fat_vit_mha_packed_proj": 0,
    }, 1)
    if len(run.q) != 64:
        fail(f"the tool scored {len(run.q)} queries, expected 64")
    if set(run.results) != {"opq_64x256", "rabitq_512", "scalar_u8", "faiss"}:
        fail(f"quantizer tool keys {sorted(run.results)}")
    for name, r in run.results.items():
        if name != "faiss" and not (r["encode_vecs_per_s"] > 0 and 0 < r["rank_agreement@20"] <= 1):
            fail(f"quantizer tool {name}: {r}")
    pq = run.pq
    ortho = float(np.abs(pq.transform.astype(np.float64) @ pq.transform.T - np.eye(pq.n_dims)).max())
    log(f"quantizer: max |R R^T - I| = {ortho:.2e}")
    if not ortho <= 1e-3:
        fail(f"the trained OPQ transform is not orthonormal: {ortho}")
    # 4,096 rows spread over the corpus: the card's codes against the CPU's
    rows = np.linspace(0, n_corpus - 1, 4096).astype(np.int64)
    x_rows = run.x[torch.from_numpy(rows).to(dev)].cpu().numpy()
    card_codes = run.codes[torch.from_numpy(rows).to(dev)].cpu().numpy()
    cpu_codes = pq.quantize(x_rows, device="cpu")
    r_i, k_i = np.nonzero(card_codes != cpu_codes)
    dpc = pq.n_dims_per_code
    xt = pq.apply_transform(x_rows[r_i], device="cpu").reshape(len(r_i), pq.n_chunks, dpc)
    sims = np.einsum("rd,crd->rc", xt[np.arange(len(r_i)), k_i],
                     pq.centroids.reshape(pq.n_centroids, pq.n_chunks, dpc)[:, k_i])
    gap = sims.max(-1, initial=-np.inf) - sims[np.arange(len(r_i)), card_codes[r_i, k_i]]
    code_share = float((card_codes == cpu_codes).mean())
    log(f"quantizer: card codes equal to the CPU's: {code_share:.6f} of {card_codes.size} "
        f"({len(r_i)} differ; largest gap to the CPU's best sim {gap.max(initial=0):.2e})")
    if not (gap <= NEAR_TIE).all():
        fail(f"{int((gap > NEAR_TIE).sum())} card codes differ from the CPU's by more than "
             f"a near tie (largest gap {gap.max()})")
    adc_vs_cpu = []
    for b in range(2):
        lut = pq.preprocess_query(run.q[b].cpu().numpy())
        got = pq.asymmetric_dot(lut, run.codes).cpu()
        want = torch.from_numpy(pq.asymmetric_dot(lut, run.codes.cpu().numpy(), device="cpu"))
        err, ok = compare(got[None], want[None], ADC_TOL)
        adc_vs_cpu.append(err)
        log(f"quantizer: query {b} asymmetric_dot card vs CPU max_abs_err {err:.3e} "
            f"(tol {ADC_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"asymmetric_dot on the card disagrees with the CPU for query {b}: {err}")
    run_results = run.results
    del run
    torch.cuda.empty_cache()

    # the large-scale deployment end to end, served through the engine's
    # text tower
    dk = disk(engine, dev, timed, launch_counts, reset_counts, check_counts, n=disk_n)
    del engine
    torch.cuda.empty_cache()

    # -- 5. result lines ----------------------------------------------------
    src = "meme_search_engine_tpu_torch/ops/csrc/"
    meta = {
        "ln_matmul": ("gemm.cu", "meme_search_engine_tpu/ops/fused.py:108", "ln_matmul", counts),
        "matmul_residual": ("gemm.cu", "meme_search_engine_tpu/ops/fused.py:163", "matmul_residual", counts),
        "ln_mlp_residual": ("gemm.cu", "meme_search_engine_tpu/ops/fused.py:302", "ln_mlp_residual", counts),
        "fat_vit_mha_packed": ("fat_attention.cu", "meme_search_engine_tpu/ops/attention.py:364",
                               "fat_vit_mha", counts),
        "fused_mha": ("mha.cu", "meme_search_engine_tpu/ops/attention.py:154", "fused_mha",
                      text_counts),
    }
    keys = ("max_abs_err", "max_abs_err_b128", "tolerance", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "tflops", "peak_share")
    # each kernel at the text routes' shapes, and its launches a bucket on
    # each text route and on the model-parallel engine's requests
    text_rows = {"ln_matmul": ("text_qkv", "text_fat_qkv"), "matmul_residual": ("text_o",),
                 "ln_mlp_residual": ("text",), "fat_vit_mha_packed": ("text",)}
    kernels = []
    for name, (source, replaces, counter, run_counts) in meta.items():
        e = {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
             "launches": run_counts[counter]}
        e.update({k: results[name][k] for k in keys})
        for part in text_rows.get(name, ()):
            e[part] = routes["kernels"][f"{name}[{part}]"]
        e["launches_text_routes_per_bucket"] = {
            r: v["launches_per_bucket"].get(counter, 0) for r, v in routes["routes"].items()}
        e["launches_model_parallel"] = {k: mp[k]["launches"].get(counter, 0) for k in ("image", "text")}
        if name == "ln_matmul":
            e["map_kv"] = {k: results["ln_matmul[map_kv]"][k] for k in keys}
            e["normalised_copy_route_ms"] = results[name]["normalised_copy_route_ms"]
            e["ptxas"] = gemm_report and {k: v for k, v in gemm_report.items() if k.endswith("true>")}
        if name == "ln_mlp_residual":
            for part in ("fc1", "fc2"):
                e[part] = {k: results[f"ln_mlp_residual[{part}]"][k] for k in keys}
            e["fc1"]["normalised_copy_route_ms"] = results["ln_mlp_residual[fc1]"]["normalised_copy_route_ms"]
        if name == "fat_vit_mha_packed":
            # fat_vit_mha (attention.py:321): the same kernel, other strides
            e["exp_bound_ms"] = results[name]["exp_bound_ms"]
            e["unpacked"] = {"replaces": "meme_search_engine_tpu/ops/attention.py:321",
                             **{k: results["fat_vit_mha"][k] for k in keys + ("exp_bound_ms",)}}
        if name == "fused_mha":  # its other checks, and a single text's shape (the *_b1 keys)
            e.update({k: v for k, v in results[name].items()
                      if k.startswith("max_abs_err_") or k.endswith("_b1")})
        kernels.append(e)
    # ms, plain_ms, library_ms and bound_ms at B = 1 (the tool's call); the
    # *_b64 keys at B = 64, both at N = 1e6, M = 64, C = 256
    # launches on the image path, the one the kernel would join; every main
    # path was checked to launch it 0 times
    kernels.append({"name": "fat_vit_mha_packed_proj", "route": "cuda",
                    "source": src + "fat_attention_proj.cu",
                    "replaces": "meme_search_engine_tpu/ops/attention.py:453",
                    "launches": counts["fat_vit_mha_packed_proj"], **results["fat_vit_mha_packed_proj"]})
    kernels.append({"name": "adc_scores", "route": "cuda", "source": src + "adc.cu",
                    "replaces": "meme_search_engine_tpu/ops/adc.py:91",
                    "launches": q_counts["adc_scores"], **results["adc_scores"]})
    # ms, plain_ms, library_ms and bound_ms at the hop shape; the *_prune
    # keys at the prune shape; launches in the disk deployment's run (every
    # shard's build)
    kernels.append({"name": "gather_rows", "route": "cuda", "source": src + "gather.cu",
                    "replaces": "meme_search_engine_tpu/ops/gather.py:89",
                    "launches": dk["launches"]["gather_rows"], **results["gather_rows"]})
    # the gather fused into the dots the JAX package runs on its rows; the
    # times at the hop shape (gather_dot) and the prune shape (gather_gram)
    kernels.append({"name": "gather_dot", "route": "cuda", "source": src + "gather_dot.cu",
                    "replaces": "meme_search_engine_tpu/ops/gather.py:89 with the dots at "
                                "meme_search_engine_tpu/index/vamana.py:237, :609, :828, :905",
                    "launches": dk["launches"]["gather_dot"], **results["gather_dot"]})
    kernels.append({"name": "gather_gram", "route": "cuda", "source": src + "gather_gram.cu",
                    "replaces": "meme_search_engine_tpu/ops/gather.py:89 with the Gram at "
                                "meme_search_engine_tpu/index/vamana.py:377",
                    "launches": dk["launches"]["gather_gram"], **results["gather_gram"]})
    print(json.dumps({
        "kernels": kernels,
        "engine": {"batch": B_TIME, "ms": batch_ms, "images_per_s": B_TIME / batch_ms * 1e3,
                   "kernel_ms": kernel_ms, "cpu_cos": coss},
        "text": {"texts": n_text, "ms": text_ms, "texts_per_s": n_text / text_ms * 1e3,
                 "fused_mha_ms": text_kernel_ms, "layer_split_ms_per_bucket": split,
                 "cpu_cos": text_coss},
    }), flush=True)
    print(json.dumps({"quantizer": {
        "n": n_corpus, "d": cfg.d_emb, "wall_s": q_wall, "stages_s": stages,
        "peak_gib": q_peak, "tool": run_results, "transform_max_ortho_err": ortho,
        "codes_equal_to_cpu": code_share, "codes_compared": int(card_codes.size),
        "adc_vs_cpu_max_abs_err": adc_vs_cpu,
    }}), flush=True)
    print(json.dumps({"service": svc}), flush=True)
    print(json.dumps({"disk": dk}), flush=True)
    print(json.dumps(train_paths), flush=True)
    print(json.dumps({"quality": qual}), flush=True)
    print(json.dumps({"naflex": naflex}), flush=True)
    print(json.dumps({"text_routes": routes, "model_parallel": mp, "flash_mha": flash}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fat-bench"]:
        sys.exit(fat_bench(sys.argv[2] if len(sys.argv) > 2 else ROOT))
    if sys.argv[1:2] == ["--mha-bench"]:
        sys.exit(mha_bench(sys.argv[2] if len(sys.argv) > 2 else ROOT))
    if sys.argv[1:2] == ["--adc-bench"]:
        sys.exit(adc_bench(sys.argv[2] if len(sys.argv) > 2 else ROOT))
    if sys.argv[1:2] == ["--proj-bench"]:
        sys.exit(proj_bench(sys.argv[2] if len(sys.argv) > 2 else ROOT))
    if sys.argv[1:2] == ["--gemm-bench"]:
        sys.exit(gemm_bench(sys.argv[2] if len(sys.argv) > 2 else ROOT))
    if sys.argv[1:2] == ["--gather-bench"]:
        sys.exit(gather_bench())
    if sys.argv[1:2] == ["--train-scrape"]:
        sys.exit(train_scrape())
    if sys.argv[1:2] == ["--quality"]:
        sys.exit(quality_only())
    if sys.argv[1:2] == ["--routes"]:
        sys.exit(routes_only())
    if sys.argv[1:2] == ["--naflex"]:
        sys.exit(naflex_only())
    if sys.argv[1:2] == ["--disk-n"]:
        sys.exit(main(disk_n=int(sys.argv[2])))
    sys.exit(main())
