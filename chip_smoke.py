#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``meme_search_engine_tpu_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero with no result line:

1. Device: the card's name and power limit (nvidia-smi), TF32 off.
2. Build: every CUDA kernel of the image path, from ``ops/csrc``.
3. Kernel checks: each kernel against its plain PyTorch version on the
   card at SigLIP SO400M/14@384 shapes with B=2 and again with B=128
   (stated tolerances), then timed at B=128 (CUDA events, median) beside
   its plain version, one PyTorch library call for the same function,
   and its bound.
4. Main path at full SO400M width (27 layers, random weights from a
   seed): an EmbeddingEngine behind the service's InferenceWorker answers
   requests of 1, 7 and 16 images at 384x384 and one at 500x400 (the
   on-device resize), and every kernel's launch count must match the
   buckets run. Then one B=128 batch is timed through the engine. All
   outputs must be finite and unit-norm, and three embeddings (two from
   the requests, one from the timed batch) must agree (cos >= 0.999)
   with the same weights run on the CPU through the plain versions.
5. One JSON line with every kernel's numbers, then the card's name and
   power limit, then ``{"ok": true, "device": {...}}`` as the last line.
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

B_CHECK, B_TIME = 2, 128
CHECK_TOL = 0.05  # rtol = atol for the GEMM kernels (tests/test_fused.py)
ATTN_TOL = 2e-2  # atol on valid rows for attention (tests/test_attention.py:98)


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


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
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
    from meme_search_engine_tpu_torch.ops import _build, attention, fused
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
    #          tolerance, rows compared: None for all, S for valid rows)
    def cases(b):
        x, qkvf, attn_out = inputs(b)
        m = b * SP
        x2 = x.reshape(m, D)
        qh = qkvf[..., :HC].reshape(b, SP, H, C)[..., :DH].permute(0, 2, 1, 3).contiguous()
        kh = qkvf[..., HC : 2 * HC].reshape(b, SP, H, C)[..., :DH].permute(0, 2, 1, 3).contiguous()
        vh = qkvf[..., 2 * HC :].reshape(b, SP, H, C)[..., :DH].permute(0, 2, 1, 3).contiguous()
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
        }, (qkvf,)

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

    results = {}
    small, (qkvf_small,) = cases(B_CHECK)
    for name, (kern, plain, _lib, _f, _b, tol, rows) in small.items():
        err = check(name, B_CHECK, kern, plain, tol, rows)
        results[name] = {"max_abs_err": err, "tolerance": tol}
    # the unpacked wrapper: the same kernel over three separate arrays
    qf, kf, vf = (qkvf_small[..., i * HC : (i + 1) * HC].contiguous() for i in range(3))
    got = attention.fat_vit_mha(qf, kf, vf, H, DH)
    want = attention.fat_vit_mha_plain(qf, kf, vf, H, DH)
    torch.cuda.synchronize()
    err, _ = compare(got, want, ATTN_TOL, S)
    log(f"check fat_vit_mha (unpacked) B={B_CHECK}: max_abs_err {err:.3e} (tol {ATTN_TOL})")
    if not err <= ATTN_TOL:
        fail(f"fat_vit_mha disagrees with its plain version: {err}")
    results["fat_vit_mha_packed"]["unpacked_max_abs_err"] = err
    del small, qkvf_small, qf, kf, vf, got, want
    torch.cuda.empty_cache()

    big = cases(B_TIME)[0]
    for name, (kern, plain, lib, flops, nbytes, tol, rows) in big.items():
        # the timed launch geometry is held against the plain version too
        results[name]["max_abs_err_b128"] = check(name, B_TIME, kern, plain, tol, rows)
        t_k = time_ms(kern, reps=10)
        t_p = time_ms(plain, reps=3)
        t_l = time_ms(lib, reps=10)
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

    # -- 4. main path at full width -----------------------------------------
    t0 = time.perf_counter()
    mem0 = torch.cuda.memory_allocated()
    params = siglip.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_img_params = siglip.param_count(params["img"])
    engine = EmbeddingEngine(params, cfg, max_batch=128, device="cuda")
    del params
    log(f"main path: SO400M params {n_img_params / 1e6:.1f} M "
        f"(image tower) built in {time.perf_counter() - t0:.1f} s; the engine's "
        f"weights take {(torch.cuda.memory_allocated() - mem0) / 2**30:.3f} GiB "
        f"on the card ({mem0 / 2**30:.3f} GiB allocated before)")
    worker = InferenceWorker(engine, "siglip-so400m/14@384")
    rng = np.random.default_rng(0)
    r = cfg.image_size
    requests = [
        rng.integers(0, 256, (1, r, r, 3), dtype=np.uint8),
        rng.integers(0, 256, (7, r, r, 3), dtype=np.uint8),
        rng.integers(0, 256, (16, r, r, 3), dtype=np.uint8),
        rng.integers(0, 256, (1, 500, 400, 3), dtype=np.uint8),
    ]
    from meme_search_engine_tpu_torch.serving.engine import pow2_buckets

    n_buckets = sum(len(pow2_buckets(len(x), 128)) for x in requests)
    done: "queue.Queue" = queue.Queue()
    fused.reset_launches()
    attention.reset_launches()
    t0 = time.perf_counter()
    for i, imgs in enumerate(requests):
        worker.submit("image", imgs, lambda ok, v, i=i: done.put((i, ok, v)))
    outs = {}
    for _ in requests:
        i, ok, v = done.get(timeout=600)
        if not ok:
            fail(f"request {i} failed: {v}")
        outs[i] = v
    counts = {**fused.launches, **attention.launches}
    log(f"main path: {len(requests)} requests, {n_buckets} buckets, "
        f"{time.perf_counter() - t0:.1f} s, launches {counts}")
    worker.stop(timeout=60)
    per_bucket = {
        "ln_matmul": cfg.depth + 1,
        "matmul_residual": cfg.depth,
        "ln_mlp_residual": cfg.depth,
        "fat_vit_mha": cfg.depth,
    }
    for k, n in per_bucket.items():
        if counts[k] != n * n_buckets:
            fail(f"{k} launched {counts[k]} times on the main path, expected {n * n_buckets}")
    def check_embeddings(what, e, n):
        if e.shape != (n, cfg.d_emb) or not np.isfinite(e).all():
            fail(f"{what}: bad output shape {e.shape} or non-finite values")
        nrm = np.linalg.norm(e, axis=-1)
        if np.abs(nrm - 1).max() > 1e-3:
            fail(f"{what}: norms {nrm}")

    for i, imgs in enumerate(requests):
        check_embeddings(f"request {i}", outs[i], len(imgs))

    # one full batch through the engine
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
    per_batch = {k: v // 3 for k, v in {**fused.launches, **attention.launches}.items()}
    check_embeddings(f"batch of {B_TIME}", batch_out, B_TIME)

    # the same weights on the CPU, through the plain versions: one image of
    # a small request, the resized one, and one of the timed batch of 128
    cpu_engine = EmbeddingEngine(engine.params, cfg, max_batch=1, device="cpu")
    coss = []
    for what, img, card in (
        ("request 1 image 3", requests[1][3:4], outs[1][3]),
        ("request 3 image 0", requests[3][0:1], outs[3][0]),
        (f"batch of {B_TIME} image 77", batch[77:78], batch_out[77]),
    ):
        t0 = time.perf_counter()
        cos = float(cpu_engine.embed_image_arrays(img)[0] @ card)
        coss.append(cos)
        log(f"cpu reference: {what} {img.shape}: cos {cos:.6f} "
            f"({time.perf_counter() - t0:.1f} s on the CPU)")
        if not cos >= 0.999:
            fail(f"card and CPU embeddings disagree on {what}: cos {cos}")
    del cpu_engine
    kernel_ms = sum(
        results[k]["ms"] * per_batch[k]
        for k in ("matmul_residual", "ln_mlp_residual")
    ) + results["ln_matmul"]["ms"] * cfg.depth + results["ln_matmul[map_kv]"]["ms"] \
        + results["fat_vit_mha_packed"]["ms"] * per_batch["fat_vit_mha"]
    log(f"engine B={B_TIME}: {batch_ms:.1f} ms/batch (median of 3), "
        f"{B_TIME / batch_ms * 1e3:.1f} images/s; kernels' share (from their timed "
        f"ms x launches) {kernel_ms:.1f} ms = {kernel_ms / batch_ms:.1%}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # -- 5. result lines ----------------------------------------------------
    src = "meme_search_engine_tpu_torch/ops/csrc/"
    meta = {
        "ln_matmul": ("gemm.cu", "meme_search_engine_tpu/ops/fused.py:108", "ln_matmul"),
        "matmul_residual": ("gemm.cu", "meme_search_engine_tpu/ops/fused.py:163", "matmul_residual"),
        "ln_mlp_residual": ("gemm.cu", "meme_search_engine_tpu/ops/fused.py:302", "ln_mlp_residual"),
        "fat_vit_mha_packed": ("fat_attention.cu", "meme_search_engine_tpu/ops/attention.py:364", "fat_vit_mha"),
    }
    keys = ("max_abs_err", "max_abs_err_b128", "tolerance", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, (source, replaces, counter) in meta.items():
        e = {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
             "launches": counts[counter]}
        e.update({k: results[name][k] for k in keys})
        if name == "ln_matmul":
            e["map_kv"] = {k: results["ln_matmul[map_kv]"][k] for k in keys}
        if name == "fat_vit_mha_packed":
            e["unpacked_max_abs_err"] = results[name]["unpacked_max_abs_err"]
        kernels.append(e)
    print(json.dumps({
        "kernels": kernels,
        "engine": {"batch": B_TIME, "ms": batch_ms, "images_per_s": B_TIME / batch_ms * 1e3,
                   "kernel_ms": kernel_ms, "cpu_cos": coss},
    }), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
