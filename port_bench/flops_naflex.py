"""Operations and bytes of the SigLIP 2 NaFlex image tower, each picture
at its own valid length.

A call of ``images`` pictures with ``patches`` valid patches in all
(s_i summed) and ``patches_sq`` the sum of their squares (s_i^2 summed)
is counted from the configuration's shapes, not from what a kernel does
(``flops.py``'s rules, its ``_layer_ops`` and ``bound_s``): the patch
embedding at P*P*3 = 768 features (uint8 pixels in), each of the
``depth`` layers' LN + QKV, o + residual and LN + MLP + residual over the
call's valid rows (weights read once a call) and its attention at
s_i^2 a picture, and the MAP head (LN + k|v over the valid keys; the
probe's q and o projections and its attention over s_i keys, each
picture; its MLP). Pad rows, the fat layout's widths and the position
tables' resize are the implementation's, not the model's work, and are
not counted.
"""

from __future__ import annotations

from typing import List

from port_bench import flops

__all__ = ["call_ops", "call_flops", "call_bound_s"]

BF16 = flops.BF16


def call_ops(m: dict, images: int, patches: int, patches_sq: int) -> List[flops.Op]:
    d, mlp = m["width"], m["mlp_dim"]
    feat = m["patch_size"] ** 2 * 3
    ops = [("patch_embed", 2.0 * patches * feat * d,
            patches * feat + feat * d * BF16 + patches * d * BF16)]
    linear = [o for o in flops._layer_ops(1, patches, d, mlp) if o[0] != "attention"]
    # attention: 2 x 2 x s^2 x d operations and 4 s d bf16 values a picture
    (_, f1, b1), = [o for o in flops._layer_ops(1, 1, d, mlp) if o[0] == "attention"]
    attention = ("attention", f1 * patches_sq, b1 * patches)
    for _ in range(m["depth"]):
        ops += linear + [attention]
    act = patches * d * BF16
    ops += [
        ("map_kv", 2.0 * patches * d * 2 * d, act + 2 * d * d * BF16 + 2 * act),
        ("map_attention", 2.0 * 2 * patches * d + images * 2.0 * 2 * d * d,
         2 * act + 2 * d * d * BF16),
        ("map_mlp", 2.0 * 2 * images * d * mlp, 2 * d * mlp * BF16 + 2 * images * d * BF16),
    ]
    return ops


def _args(call: dict):
    return call["img"], call["patches"], call["patches_sq"]


def call_flops(m: dict, call: dict) -> float:
    """Operations of one recorded call (its ``img``, ``patches`` and
    ``patches_sq``)."""
    return sum(f for _, f, _ in call_ops(m, *_args(call)))


def call_bound_s(m: dict, call: dict) -> float:
    """The least time the card could take for one recorded call: each
    operation bound by operations at the bf16 peak or bytes at the HBM
    rate, summed."""
    return sum(flops.bound_s(f, b) for _, f, b in call_ops(m, *_args(call)))
