"""SigLIP 2 SO400M/16 NaFlex's image tower, plainly (the configuration's
reference).

Plain PyTorch in fp32 with TF32 off, from the source-layout tree of
``port_bench.data.siglip_params`` (upcast here: the bf16 numbers the
program serves, computed in fp32). It follows the published model
(google/siglip2-so400m-patch16-naflex; ``transformers``'
``Siglip2ImageProcessor``, ``Siglip2VisionTransformer`` and
``Siglip2MultiheadAttentionPoolingHead``; arXiv:2502.14786):

- :func:`grid_for`: the processor's grid, the largest scale (a binary
  search to 1e-5) at which ceil(h s / 16) * ceil(w s / 16) <=
  max_num_patches;
- each picture, given at its grid's size (16 h, 16 w) as uint8, mapped to
  [-1, 1] and cut into 16 x 16 patches in row-major grid order, each
  flattened as (row, col, channel), padded with zeros to max_num_patches
  rows with a mask over the valid ones;
- a Linear patch embedding, plus the learned 16 x 16 position table
  resized to the picture's grid by ``F.interpolate(mode="bilinear",
  align_corners=False, antialias=True)`` (pad rows: the resized table's
  first row);
- 27 pre-LN layers (LayerNorm eps 1e-6, 16 heads of 72,
  softmax(QK^T / sqrt(72)) V over the picture's valid keys, MLP with
  tanh-GELU); final LayerNorm; the MAP head (a learned probe attends over
  the valid keys, then y + MLP(LN(y))); L2 norm (the published tower
  returns the pooled row unnormalised).

``precision="fp8"`` is the control: every dense layer's input and
weights rounded to float8 e4m3 (one scale a tensor, its largest
magnitude at 448), the products in fp32. Nothing here imports the port.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .siglip import _dense, _layer, _ln, _mlp, _unit

__all__ = ["grid_for", "encode_pictures"]


def grid_for(height: int, width: int, patch: int, max_num_patches: int,
             eps: float = 1e-5) -> Tuple[int, int]:
    """A picture's grid (h, w) in patches by the processor's rule."""

    def scaled(scale: float, size: int) -> int:
        return int(max(patch, math.ceil(size * scale / patch) * patch))

    lo, hi = eps / 10, 100.0
    while hi - lo >= eps:
        mid = (lo + hi) / 2
        if (scaled(mid, height) / patch) * (scaled(mid, width) / patch) <= max_num_patches:
            lo = mid
        else:
            hi = mid
    return scaled(lo, height) // patch, scaled(lo, width) // patch


def _attention(xq, xkv, p, heads, mask, precision):
    b, sq, d = xq.shape
    sk = xkv.shape[1]
    dh = d // heads
    q = _dense(xq, p["q"], precision).view(b, sq, heads, dh).transpose(1, 2)
    k = _dense(xkv, p["k"], precision).view(b, sk, heads, dh).transpose(1, 2)
    v = _dense(xkv, p["v"], precision).view(b, sk, heads, dh).transpose(1, 2)
    s = (q @ k.transpose(-1, -2) / dh**0.5).masked_fill(~mask[:, None, None, :], float("-inf"))
    o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b, sq, d)
    return _dense(o, p["o"], precision)


def _positions(table: torch.Tensor, grids, length: int) -> torch.Tensor:
    side = math.isqrt(table.shape[0])
    c = table.shape[1]
    src = table.reshape(side, side, c).permute(2, 0, 1)[None]
    out = torch.empty(len(grids), length, c, device=table.device)
    for i, (h, w) in enumerate(grids):
        r = F.interpolate(src, size=(h, w), mode="bilinear", align_corners=False, antialias=True)
        r = r.reshape(c, h * w).T
        out[i, : h * w] = r
        out[i, h * w:] = r[0]
    return out


def _pack(pictures: Sequence, patch: int, length: int, device):
    b = len(pictures)
    values = torch.zeros(b, length, patch * patch * 3, device=device)
    mask = torch.zeros(b, length, dtype=torch.bool, device=device)
    grids = []
    for i, pic in enumerate(pictures):
        x = torch.as_tensor(np.asarray(pic), device=device).float() / 127.5 - 1.0
        h, w = x.shape[0] // patch, x.shape[1] // patch
        rows = x.reshape(h, patch, w, patch, 3).permute(0, 2, 1, 3, 4).reshape(h * w, -1)
        values[i, : h * w] = rows
        mask[i, : h * w] = True
        grids.append((h, w))
    return values, mask, grids


def encode_pictures(params: dict, pictures: Sequence, m: dict, precision: str = "fp32",
                    chunk: int = 8) -> torch.Tensor:
    """uint8 pictures at their grids' sizes -> (B, d_emb) fp32 unit rows,
    ``chunk`` at a time at ``m["max_num_patches"]`` rows each. ``params``:
    ``to_fp32`` of the tree (``params["img"]`` read)."""
    p = params["img"]
    heads, patch, length = m["num_heads"], m["patch_size"], m["max_num_patches"]
    out = []
    for s in range(0, len(pictures), chunk):
        values, mask, grids = _pack(pictures[s:s + chunk], patch, length, p["pos_emb"].device)
        x = _dense(values, p["patch_embed"], precision) + _positions(p["pos_emb"], grids, length)
        for i in range(p["blocks"]["ln1"]["g"].shape[0]):
            blk = _layer(p["blocks"], i)
            h = _ln(x, blk["ln1"])
            x = x + _attention(h, h, blk["attn"], heads, mask, precision)
            x = x + _mlp(_ln(x, blk["ln2"]), blk["mlp"], precision)
        x = _ln(x, p["ln_final"])
        mh = p["map_head"]
        probe = mh["probe"][None].expand(x.shape[0], 1, x.shape[-1])
        y = _attention(probe, x, mh, heads, mask, precision)
        y = y + _mlp(_ln(y, mh["ln"]), mh["mlp"], precision)
        out.append(_unit(y[:, 0]))
    return torch.cat(out)
