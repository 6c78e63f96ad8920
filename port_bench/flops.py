"""Operations and bytes of the work a cell asks for, and the card's peaks.

Counted from a configuration's shapes, not from what a kernel does: the
image tower at its 729 real tokens (not the 736 rows the port pads to)
and its unpadded widths (3 x 1152 columns of q, k and v, not the fat
layout's 3 x 1280; an MLP of 4304, not 4352), so a reading is the same
whatever implements the work. A dense layer is 2 x rows x d_in x d_out
operations; attention 2 x 2 x Sq x Sk x width (Q.K^T and P.V). Bytes count
each input once and each output once (bf16 activations and weights), not
what a kernel reads again.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
power limit): 989 TFLOP/s in bf16 and fp16 on the tensor cores, 3.35 TB/s
of HBM3.
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = ["PEAK_BF16", "PEAK_BW", "bound_s", "image_ops", "image_flops"]

PEAK_BF16 = 989e12
PEAK_BW = 3.35e12

BF16 = 2

Op = Tuple[str, float, float]  # (name, operations, bytes)


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least time the card could take: operations at the peak or bytes
    at the memory rate, whichever is longer."""
    return max(flops / peak, nbytes / PEAK_BW)


def _layer_ops(b: int, s: int, d: int, m: int) -> List[Op]:
    """One pre-LN encoder layer over b sequences of s tokens, width d, MLP m."""
    rows = b * s
    act = rows * d * BF16
    return [
        ("ln_qkv", 2.0 * rows * d * 3 * d, act + 3 * d * d * BF16 + 3 * act),
        ("attention", 2.0 * 2 * b * s * s * d, 3 * act + act),
        ("o_residual", 2.0 * rows * d * d, act + d * d * BF16 + act + act),
        ("ln_mlp_residual", 2.0 * 2 * rows * d * m, act + 2 * d * m * BF16 + act),
    ]


def image_ops(m: dict, b: int) -> List[Op]:
    """The image tower's operations for b images at the model resolution:
    the patch embedding (uint8 pixels in), each layer's four, the MAP
    head (LN + k|v projection; the probe's q and o projections and its
    attention, counted for each image; its MLP)."""
    d, mlp = m["width"], m["mlp_dim"]
    s = (m["image_size"] // m["patch_size"]) ** 2
    patch = m["patch_size"] ** 2 * 3
    ops = [("patch_embed", 2.0 * b * s * patch * d,
            b * m["image_size"] ** 2 * 3 + patch * d * BF16 + b * s * d * BF16)]
    for _ in range(m["depth"]):
        ops += _layer_ops(b, s, d, mlp)
    act = b * s * d * BF16
    ops += [
        ("map_kv", 2.0 * b * s * d * 2 * d, act + 2 * d * d * BF16 + 2 * act),
        ("map_attention", b * (2.0 * 2 * s * d + 2.0 * 2 * d * d), 2 * act + 2 * d * d * BF16),
        ("map_mlp", 2.0 * 2 * b * d * mlp, 2 * d * mlp * BF16 + 2 * b * d * BF16),
    ]
    return ops


def image_flops(m: dict) -> float:
    """Operations of one image through the image tower (about 670 GFLOP
    at SO400M/14@384)."""
    return sum(f for _, f, _ in image_ops(m, 1))
