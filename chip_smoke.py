#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``meme_search_engine_tpu_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero with no result line:

1. Device: the card's name and power limit (nvidia-smi), TF32 off.
2. Build: every CUDA kernel of the port, from ``ops/csrc``.
3. Kernel checks: each kernel against its plain PyTorch version on the
   card at SigLIP SO400M/14@384 shapes with B=2 and again with B=128
   (stated tolerances), then timed at B=128 (CUDA events, median) beside
   its plain version, one PyTorch library call for the same function,
   and its bound. The image kernels run at the image tower's shapes; the
   fused attention kernel at the text tower's (B, 64, 16, 72), in all
   three stable modes at B=2, and once more at S=729, B=2. The ADC kernel
   at N = 1,000,003 codes of M = 64 bytes with B = 1 and B = 64 LUTs of
   C = 256, at the JAX test's (300, 16) x (3, 16, 256), and at C = 16 with
   codes up to 255 (rtol = atol = 1e-4); then timed at N = 1e6, B = 1 and
   B = 64, beside its plain version, its bound and one library call for
   the same function (``F.embedding_bag(mode="sum")`` over the LUTs
   zero-padded to 256 entries as a (M * 256, B) table, bag n holding the
   indices codes[n, m] + 256 m; it answers (N, B), held against the plain
   version at 1e-4 too).
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
   - Quantizers, at the deployment size of docs/scale1m_report.json
     (N = 1e6, d = 1152): the port's ``tools/quantizer_bench`` trains OPQ
     64x256 on a 50k sample with 64 queries, encodes the corpus and
     scores the 64 queries one at a time (exactly 64 ADC launches and no
     other kernel), then RaBitQ 512 and scalar u8. The transform must be
     orthonormal (1e-3); 4,096 of the card's codes are held against the
     CPU's (any that differ must be near ties: the CPU's best sim within
     1e-4 of the sim of the card's code), and 2 queries' ADC scores
     against the CPU's at 1e-4.
5. One JSON line with every kernel's numbers, one with the quantizer
   path's, then the card's name and power limit, then
   ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import json
import os
import queue
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

B_CHECK, B_TIME = 2, 128
CHECK_TOL = 0.05  # rtol = atol for the GEMM kernels (tests/test_fused.py)
ATTN_TOL = 2e-2  # atol on valid rows for attention (tests/test_attention.py:98)
ADC_TOL = 1e-4  # rtol = atol for ADC (tests/test_quantizers.py:175)
ADC_N, ADC_M = 1_000_003, 64  # a corpus of 1e6 codes and a ragged tail
NEAR_TIE = 1e-4  # a code may differ from the CPU's only within this of its best sim


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from meme_search_engine_tpu_torch.models import siglip
    from meme_search_engine_tpu_torch.ops import _build, adc, attention, fused
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
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # -- 3. kernel checks and timings ---------------------------------------
    cfg = siglip.SO400M_14_384
    D, H, DH = cfg.width, cfg.num_heads, cfg.head_dim
    C = attention.fat_width(DH)
    HC = H * C
    S = cfg.num_patches
    SP = ((S + 15) // 16) * 16
    M_REAL = cfg.mlp_dim
    TS, TH = cfg.text_len, cfg.text_num_heads
    TDH = cfg.text_width // TH
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    def dense(d_in, d_out):
        return {"w": rn(d_in, d_out, std=d_in**-0.5), "b": rn(d_out, std=0.02)}

    attn_p = {n: dense(D, D) for n in "qkvo"}
    (wq, bq), (wk, bk), (wv, bv) = siglip._fat_qkv_weights(attn_p, H, DH)
    wqkv = torch.cat([wq, wk, wv], 1).contiguous()
    bqkv = torch.cat([bq, bk, bv]).contiguous()
    g1, be1 = (1 + rn(D, std=0.1)).contiguous(), rn(D, std=0.1)
    fc1, fc2 = dense(D, M_REAL), dense(M_REAL, D)
    w1, b1, w2 = (t.contiguous() for t in fused.pad_hidden(fc1["w"], fc1["b"], fc2["w"]))
    wkv = torch.cat([attn_p["k"]["w"], attn_p["v"]["w"]], 1).contiguous()
    bkv = torch.cat([attn_p["k"]["b"], attn_p["v"]["b"]]).contiguous()
    kmask = (S, H, C, DH)

    def inputs(b):
        x = rn(b, SP, D)
        qkvf = fused.ln_matmul_plain(x, g1, be1, wqkv, bqkv, k_mask=kmask)
        attn_out = attention.fat_vit_mha_packed_plain(qkvf, H, DH)
        return x, qkvf, attn_out

    # name -> (kernel call, plain call, library call, flops, bytes,
    #          tolerance, rows compared: None for all rows with rtol = atol
    #          = tolerance; an int for attention, the first rows (the
    #          valid ones), atol only)
    def cases(b):
        x, qkvf, attn_out = inputs(b)
        m = b * SP
        x2 = x.reshape(m, D)
        qh = qkvf[..., :HC].reshape(b, SP, H, C)[..., :DH].permute(0, 2, 1, 3).contiguous()
        kh = qkvf[..., HC : 2 * HC].reshape(b, SP, H, C)[..., :DH].permute(0, 2, 1, 3).contiguous()
        vh = qkvf[..., 2 * HC :].reshape(b, SP, H, C)[..., :DH].permute(0, 2, 1, 3).contiguous()
        qf, kf, vf = (qkvf[..., i * HC : (i + 1) * HC].contiguous() for i in range(3))
        key_ok = (torch.arange(SP, device=dev) < S)[None, None, None, :]
        el = 2  # bytes per bf16
        return {
            "ln_matmul": (
                lambda: fused.ln_matmul(x, g1, be1, wqkv, bqkv, k_mask=kmask),
                lambda: fused.ln_matmul_plain(x, g1, be1, wqkv, bqkv, k_mask=kmask),
                lambda: torch.addmm(bqkv, F.layer_norm(x2, (D,), g1, be1, 1e-6), wqkv),
                2.0 * m * D * 3 * HC,
                el * (m * D + D * 3 * HC + m * 3 * HC + 2 * D + 3 * HC),
                CHECK_TOL, None,
            ),
            "ln_matmul[map_kv]": (
                lambda: fused.ln_matmul(x, g1, be1, wkv, bkv),
                lambda: fused.ln_matmul_plain(x, g1, be1, wkv, bkv),
                lambda: torch.addmm(bkv, F.layer_norm(x2, (D,), g1, be1, 1e-6), wkv),
                2.0 * m * D * 2 * D,
                el * (m * D + D * 2 * D + m * 2 * D + 2 * D + 2 * D),
                CHECK_TOL, None,
            ),
            "fat_vit_mha_packed": (
                lambda: attention.fat_vit_mha_packed(qkvf, H, DH),
                lambda: attention.fat_vit_mha_packed_plain(qkvf, H, DH),
                lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=key_ok),
                4.0 * b * H * SP * SP * C,
                el * (m * 3 * HC + m * H * DH),
                ATTN_TOL, S,
            ),
            # the unpacked wrapper: the same kernel over three separate arrays
            "fat_vit_mha": (
                lambda: attention.fat_vit_mha(qf, kf, vf, H, DH),
                lambda: attention.fat_vit_mha_plain(qf, kf, vf, H, DH),
                lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=key_ok),
                4.0 * b * H * SP * SP * C,
                el * (m * 3 * HC + m * H * DH),
                ATTN_TOL, S,
            ),
            "matmul_residual": (
                lambda: fused.matmul_residual(attn_out, attn_p["o"]["w"], attn_p["o"]["b"], x),
                lambda: fused.matmul_residual_plain(attn_out, attn_p["o"]["w"], attn_p["o"]["b"], x),
                lambda: torch.addmm(x2, attn_out.reshape(m, D), attn_p["o"]["w"]),
                2.0 * m * D * D,
                el * (3 * m * D + D * D + D),
                CHECK_TOL, None,
            ),
            "ln_mlp_residual": (
                lambda: fused.ln_mlp_residual(x, g1, be1, w1, b1, w2, fc2["b"]),
                lambda: fused.ln_mlp_residual_plain(x, g1, be1, fc1["w"], fc1["b"], fc2["w"], fc2["b"]),
                lambda: torch.addmm(
                    fc2["b"],
                    F.gelu(torch.addmm(fc1["b"], F.layer_norm(x2, (D,), g1, be1, 1e-6), fc1["w"]),
                           approximate="tanh"),
                    fc2["w"],
                ),
                2.0 * 2 * m * D * M_REAL,
                el * (2 * m * D + 2 * D * M_REAL + M_REAL + 3 * D),
                CHECK_TOL, None,
            ),
        }

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

    def check(name, b, kern, plain, tol, rows) -> float:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err, ok = compare(got, want, tol, rows)
        if rows is not None:  # attention: atol only, as tests/test_attention.py
            ok = err <= tol
        log(f"check {name} B={b}: max_abs_err {err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} disagrees with its plain version at B={b}: max_abs_err {err}")
        return err

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
        results[name].update(
            ms=t_k, plain_ms=t_p, library_ms=t_l,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            tflops=flops / t_k / 1e9,
        )
        log(f"time {name} B={B_TIME}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
            f"library {t_l:.3f} ms, bound {max(t_ops, t_bytes):.3f} ms "
            f"({results[name]['bound_by']}), {flops / t_k / 1e9:.1f} TFLOP/s")
    del big, kern, plain, lib  # the closures hold the B=128 inputs
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
    del codes, luts, small_codes, small_luts, narrow_luts, timed_codes, bag_idx, table
    torch.cuda.empty_cache()

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
        return {**fused.launches, **attention.launches, **adc.launches}

    def reset_counts():
        fused.reset_launches()
        attention.reset_launches()
        adc.reset_launches()

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

    def check_counts(kind, counts, per_bucket, n_buckets):
        for k, n in per_bucket.items():
            if counts[k] != n * n_buckets:
                fail(f"{k} launched {counts[k]} times on the {kind} path, "
                     f"expected {n * n_buckets}")

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
        "adc_scores": 0,
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
        "adc_scores": 0,
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
    blk = siglip._layer(engine.params["txt"]["blocks"], 0)
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
    del engine, worker, batch_out, text_out
    torch.cuda.empty_cache()

    # quantizers at the deployment size of docs/scale1m_report.json, through
    # the port's tool as a user runs it; the training and encoding stages
    # are timed by wrapping the functions the tool calls
    from meme_search_engine_tpu_torch.index import opq, rabitq, scalar
    from meme_search_engine_tpu_torch.tools import quantizer_bench

    stages: dict = {}

    def timed(owner, name):
        fn = getattr(owner, name)

        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
            return out

        setattr(owner, name, wrapper)
        return fn

    wrapped = [(o, n, timed(o, n)) for o, n in (
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
        "ln_mlp_residual": 0, "fat_vit_mha": 0, "fused_mha": 0,
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
    keys = ("max_abs_err", "max_abs_err_b128", "tolerance", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, (source, replaces, counter, run_counts) in meta.items():
        e = {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
             "launches": run_counts[counter]}
        e.update({k: results[name][k] for k in keys})
        if name == "ln_matmul":
            e["map_kv"] = {k: results["ln_matmul[map_kv]"][k] for k in keys}
        if name == "fat_vit_mha_packed":
            # fat_vit_mha (attention.py:321): the same kernel, other strides
            e["unpacked"] = {"replaces": "meme_search_engine_tpu/ops/attention.py:321",
                             **{k: results["fat_vit_mha"][k] for k in keys}}
        if name == "fused_mha":
            e.update({k: v for k, v in results[name].items() if k.startswith("max_abs_err_")})
        kernels.append(e)
    # ms, plain_ms, library_ms and bound_ms at B = 1 (the tool's call); the
    # *_b64 keys at B = 64, both at N = 1e6, M = 64, C = 256
    kernels.append({"name": "adc_scores", "route": "cuda", "source": src + "adc.cu",
                    "replaces": "meme_search_engine_tpu/ops/adc.py:91",
                    "launches": q_counts["adc_scores"], **results["adc_scores"]})
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
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
