"""SigLIP 2 NaFlex, plainly: the yardstick of the port's NaFlex tower.

Plain PyTorch in fp32 (call :func:`no_tf32` on a card), written from the
published model's definition (``transformers``' ``Siglip2ImageProcessor``,
``Siglip2VisionEmbeddings``, ``Siglip2VisionTransformer``,
``Siglip2MultiheadAttentionPoolingHead`` and ``Siglip2TextTransformer``;
arXiv:2502.14786). It imports nothing of either package: it reads a
parameter tree in the source layout (nested dicts, per-layer weights
stacked on a leading depth axis; ``img`` and ``txt``), upcast to fp32.

- The processor: :func:`image_size_for_max_num_patches` (the binary
  search over scales), :func:`patchify` (row-major grid order, each
  patch flattened as (row, col, channel)), :func:`pack` (padded to
  ``max_num_patches`` with zeros, a mask over the valid patches, the
  grids).
- The image tower: a Linear patch embedding; the position table resized
  to each picture's grid by ``F.interpolate(mode="bilinear",
  align_corners=False, antialias=True)`` one picture at a time, pad rows
  given the resized table's first row (:func:`resize_positions`); pre-LN
  layers (LayerNorm eps 1e-6, softmax(QK^T / sqrt(dh)) V with each
  picture's pad keys masked, tanh-GELU MLP); final LayerNorm; the MAP head
  (a learned probe attends over the valid keys, then y + MLP(LN(y)));
  L2 norm.
- The text tower: token and position embeddings, the same layers with
  no mask, final LayerNorm, the last token, the head; L2 norm.

Departures from the published model, each deliberate:

- The pictures come in at their grid's size (16 h, 16 w) as uint8: the
  processor's resize of the original (PIL bilinear) happens before.
- Pixels map to [-1, 1] as x / 127.5 - 1, the processor's rescale by
  1/255 and normalisation by mean 0.5, std 0.5 in one step.
- The outputs are L2-normalised; the published towers return the
  pooled rows unnormalised and the model normalises them for its logits.
- The text tower takes token ids with no attention mask, as the
  published model is run (padded to 64 with the pad id, no mask).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["no_tf32", "to_fp32", "image_size_for_max_num_patches", "grid_for",
           "patchify", "pack", "resize_positions", "encode_image", "encode_pictures",
           "encode_text"]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_fp32(tree):
    if isinstance(tree, dict):
        return {k: to_fp32(v) for k, v in tree.items()}
    return tree.float()


def image_size_for_max_num_patches(height: int, width: int, patch: int, max_num_patches: int,
                                   eps: float = 1e-5) -> Tuple[int, int]:
    """The processor's target size in pixels: the largest scale (to
    ``eps``) at which ceil(h s / P) * ceil(w s / P) <= max_num_patches,
    each side at least one patch."""

    def scaled(scale: float, size: int) -> int:
        return int(max(patch, math.ceil(size * scale / patch) * patch))

    lo, hi = eps / 10, 100.0
    while hi - lo >= eps:
        mid = (lo + hi) / 2
        if (scaled(mid, height) / patch) * (scaled(mid, width) / patch) <= max_num_patches:
            lo = mid
        else:
            hi = mid
    return scaled(lo, height), scaled(lo, width)


def grid_for(height: int, width: int, patch: int, max_num_patches: int) -> Tuple[int, int]:
    """The picture's grid (h, w) in patches."""
    th, tw = image_size_for_max_num_patches(height, width, patch, max_num_patches)
    return th // patch, tw // patch


def patchify(image: torch.Tensor, patch: int) -> torch.Tensor:
    """(P h, P w, C) -> (h w, P P C): row-major patches, each (row, col,
    channel)."""
    hh, ww, c = image.shape
    h, w = hh // patch, ww // patch
    x = image.reshape(h, patch, w, patch, c).permute(0, 2, 1, 3, 4)
    return x.reshape(h * w, patch * patch * c)


def pack(pictures: Sequence, patch: int, max_num_patches: int, device="cpu"):
    """uint8 pictures at their grid's size -> (pixel values (B, N, P P 3)
    fp32 in [-1, 1], zero past each picture's patches; mask (B, N) bool;
    grids (B, 2) long)."""
    b = len(pictures)
    values = torch.zeros(b, max_num_patches, patch * patch * 3, device=device)
    mask = torch.zeros(b, max_num_patches, dtype=torch.bool, device=device)
    grids = torch.zeros(b, 2, dtype=torch.long)
    for i, pic in enumerate(pictures):
        x = torch.as_tensor(np.asarray(pic), device=device).float() / 127.5 - 1.0
        rows = patchify(x, patch)
        if rows.shape[0] > max_num_patches:
            raise ValueError(f"picture {i}: {rows.shape[0]} patches > {max_num_patches}")
        values[i, : rows.shape[0]] = rows
        mask[i, : rows.shape[0]] = True
        grids[i] = torch.tensor([pic.shape[0] // patch, pic.shape[1] // patch])
    return values, mask, grids


def resize_positions(table: torch.Tensor, grids: torch.Tensor, length: int) -> torch.Tensor:
    """(n, C) table of a sqrt(n) x sqrt(n) grid -> (B, length, C): each
    picture's table resized to its grid, row-major, pad rows the resized
    table's first row."""
    side = math.isqrt(table.shape[0])
    c = table.shape[1]
    src = table.reshape(side, side, c).permute(2, 0, 1)[None]
    out = torch.empty(grids.shape[0], length, c, device=table.device)
    for i, (h, w) in enumerate(grids.tolist()):
        r = F.interpolate(src, size=(h, w), mode="bilinear", align_corners=False, antialias=True)
        r = r.reshape(c, h * w).T
        out[i, : h * w] = r
        out[i, h * w:] = r[0]
    return out


def _dense(x, p):
    return x @ p["w"] + p["b"]


def _ln(x, p):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * p["g"] + p["b"]


def _attention(xq, xkv, p, heads, mask=None):
    """Multi-head attention; ``mask`` (B, Sk) bool, True at the keys
    each query may read."""
    b, sq, d = xq.shape
    sk = xkv.shape[1]
    dh = d // heads
    q = _dense(xq, p["q"]).view(b, sq, heads, dh).transpose(1, 2)
    k = _dense(xkv, p["k"]).view(b, sk, heads, dh).transpose(1, 2)
    v = _dense(xkv, p["v"]).view(b, sk, heads, dh).transpose(1, 2)
    s = q @ k.transpose(-1, -2) / dh**0.5
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b, sq, d)
    return _dense(o, p["o"])


def _mlp(x, p):
    return _dense(F.gelu(_dense(x, p["fc1"]), approximate="tanh"), p["fc2"])


def _encoder(x, blocks, heads, mask=None):
    for i in range(blocks["ln1"]["g"].shape[0]):
        p = _layer(blocks, i)
        h = _ln(x, p["ln1"])
        x = x + _attention(h, h, p["attn"], heads, mask)
        x = x + _mlp(_ln(x, p["ln2"]), p["mlp"])
    return x


def _layer(blocks, i):
    if isinstance(blocks, dict):
        return {k: _layer(v, i) for k, v in blocks.items()}
    return blocks[i]


def _unit(e):
    return e / e.norm(dim=-1, keepdim=True)


def encode_image(img: dict, values: torch.Tensor, mask: torch.Tensor, grids: torch.Tensor,
                 heads: int) -> torch.Tensor:
    """The image tower over a packed batch (:func:`pack`) -> (B, d) unit
    rows. ``img``: the fp32 image tower."""
    x = _dense(values, img["patch_embed"]) + resize_positions(img["pos_emb"], grids, values.shape[1])
    x = _ln(_encoder(x, img["blocks"], heads, mask), img["ln_final"])
    mh = img["map_head"]
    probe = mh["probe"].reshape(1, 1, -1).expand(x.shape[0], 1, x.shape[-1])
    y = _attention(probe, x, mh, heads, mask)
    y = y + _mlp(_ln(y, mh["ln"]), mh["mlp"])
    return _unit(y[:, 0])


def encode_pictures(img: dict, pictures: Sequence, patch: int, max_num_patches: int, heads: int,
                    chunk: int = 8) -> torch.Tensor:
    """uint8 pictures at their grid's size -> (B, d) unit rows, ``chunk``
    at a time, on the tower's device."""
    dev = img["pos_emb"].device
    out: List[torch.Tensor] = []
    for s in range(0, len(pictures), chunk):
        values, mask, grids = pack(pictures[s:s + chunk], patch, max_num_patches, dev)
        out.append(encode_image(img, values, mask, grids, heads))
    return torch.cat(out)


def encode_text(txt: dict, tokens: torch.Tensor, heads: int) -> torch.Tensor:
    """Token ids (B, L) -> (B, d) unit rows. ``txt``: the fp32 text tower."""
    x = txt["token_emb"][tokens.long()] + txt["pos_emb"][None, : tokens.shape[1]]
    x = _ln(_encoder(x, txt["blocks"], heads), txt["ln_final"])
    return _unit(_dense(x[:, -1], txt["head"]))
