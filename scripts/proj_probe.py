#!/usr/bin/env python3
"""Time variants of the fused attention + o-projection kernel (kernel 8,
``meme_search_engine_tpu_torch/ops/csrc/fat_attention_proj.cu``) on the
card, to see where its time goes.

The script writes a copy of the kernel source with compile-time switches
into ``build/proj_probe/`` (listed in ``.gitignore``), builds each variant
asked for with nvcc into its own library (all in parallel), and times each
at SigLIP SO400M's layer shape with B = 128 (CUDA-event medians), beside
the repository's own kernel (``kernel``) and kernels 7 + 2 (``composed``),
each in a process of its own. A variant is a name and a list of switches:

    -DPROBE_NO_ATTN   no attention phase: the projection, epilogue and
                      cluster barriers alone (its output is wrong)
    -DPROBE_NO_PUSH   no pushes between the CTAs: every chunk's A from the
                      CTA's own slice (wrong output)
    -DPROBE_NO_B      no Wo loads: the ring's Wo stays as it is (wrong output)
    -DPROBE_OVERLAP   the attention's softmax under the P.V products, as
                      kernel 7 runs it

Usage, on the machine with the card, from the repository root:

    python3 scripts/proj_probe.py '{"full": [], "proj": ["-DPROBE_NO_ATTN"]}' composed kernel full proj

The last line printed is the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "meme_search_engine_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "build" / "proj_probe"

# (text in the kernel source, its replacement) for each switch; each
# replaces the first occurrence of its text
SWITCHES = [
    ('#include "fat_attention.cuh"', f'#include "{CSRC}/fat_attention.cuh"'),
    ("fat::load_tile<CP>(", "if (!PROBE_NO_ATTN) fat::load_tile<CP>("),
    ("if (wg == 1) bar_arrive<256>(1);", "if (wg == 1 && !PROBE_NO_ATTN) bar_arrive<256>(1);"),
    ("fat::attend_tile<CP, false>(", "if (!PROBE_NO_ATTN) fat::attend_tile<CP, !!PROBE_OVERLAP>("),
    ("if (wg == 0) bar_sync<256>(1);", "if (wg == 0 && !PROBE_NO_ATTN) bar_sync<256>(1);"),
    ("} else if (threadIdx.x == 288) {", "} else if (threadIdx.x == 288 && !PROBE_NO_PUSH) {"),
    ("mbar_expect_tx(b_full + 8 * st, P::B_CHUNK);",
     "if (PROBE_NO_B) continue;\n          mbar_expect_tx(b_full + 8 * st, P::B_CHUNK);"),
    ("mbar_wait(b_full + 8 * st,", "if (!PROBE_NO_B) mbar_wait(b_full + 8 * st,"),
    ("uint32_t a = slice + t * P::A_CHUNK;", "uint32_t a = slice + (PROBE_NO_PUSH ? t % P::NSUB : t) * P::A_CHUNK;"),
    ("if (t >= P::NSUB) {", "if (t >= P::NSUB && !PROBE_NO_PUSH) {"),
]
DEFAULTS = "".join(
    f"#ifndef {name}\n#define {name} {value}\n#endif\n"
    for name, value in (("PROBE_NO_ATTN", 0), ("PROBE_NO_PUSH", 0), ("PROBE_NO_B", 0),
                        ("PROBE_OVERLAP", 0))
)


def write_source() -> Path:
    src = (CSRC / "fat_attention_proj.cu").read_text()
    for old, new in SWITCHES:
        if old not in src:
            raise SystemExit(f"the kernel source has changed: no {old!r}")
        src = src.replace(old, new, 1)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "fat_attention_proj_probe.cu"
    path.write_text(DEFAULTS + src)
    return path


def build(variants: dict) -> None:
    from meme_search_engine_tpu_torch.ops import _build

    src = write_source()
    procs = {
        name: subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(OUT / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in variants.items()
    }
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{out[-3000:]}", flush=True)
            continue
        lines = out.splitlines()
        print(f"{name} {variants[name]}: built; C7513 warnings {sum('C7513' in x for x in lines)}; "
              + [x.strip() for x in lines if "spill" in x][-1], flush=True)


def time_one(name: str) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from meme_search_engine_tpu_torch.models import siglip
    from meme_search_engine_tpu_torch.ops import _build, attention, fused

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cfg = siglip.SO400M_14_384
    h, dh, s, d = cfg.num_heads, cfg.head_dim, cfg.num_patches, cfg.width
    sp, b = (s + 15) // 16 * 16, cs.B_TIME
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkvf = cs.fat_qkvf(gen, b, sp, s, h, dh)
    wo = (torch.randn((h * dh, d), generator=gen, device="cuda") * (h * dh) ** -0.5).to(torch.bfloat16)
    bo = (torch.randn((d,), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    x = torch.randn((b, sp, d), generator=gen, device="cuda").to(torch.bfloat16)

    def composed():
        return fused.matmul_residual(attention.fat_vit_mha_packed(qkvf, h, dh), wo, bo, x)

    want = composed()
    if name == "composed":
        fn = composed
    elif name == "kernel":
        def fn():
            return attention.fat_vit_mha_packed_proj(qkvf, wo, bo, x, h, dh)
    else:
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        entry = lib.mse_fat_attention_proj
        entry.argtypes = _build._SIGNATURES[("fat_attention_proj", "mse_fat_attention_proj")]
        out = torch.empty_like(x)

        def fn():
            _build.check(entry(qkvf.data_ptr(), wo.data_ptr(), bo.data_ptr(), x.data_ptr(),
                               out.data_ptr(), b, sp, h, attention.kernel_width(dh), dh, d,
                               _build.stream_ptr(qkvf.device)), name)
            return out
    got = fn()
    torch.cuda.synchronize()
    err = float((got.float() - want.float())[:, :s].abs().max())
    print(f"{name}: {cs.time_ms(fn, reps=10):.4f} ms at B={b} (max abs err against 7 + 2: {err:.3g})",
          flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--time":
        time_one(sys.argv[2])
        return 0
    sys.path.insert(0, str(ROOT))
    variants = json.loads(sys.argv[1])
    build(variants)
    for name in sys.argv[2:]:
        r = subprocess.run([sys.executable, __file__, "--time", name], capture_output=True, text=True,
                           timeout=300, env={**os.environ})
        print(r.stdout.strip() or f"{name}: failed\n{r.stderr[-2000:]}", flush=True)
    import chip_smoke as cs

    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
