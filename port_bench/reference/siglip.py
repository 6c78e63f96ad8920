"""SigLIP SO400M's image tower, plainly (the configuration's reference).

Plain PyTorch in fp32 with TF32 off, from the source-layout tree of
``port_bench.data.siglip_params`` (upcast here: the bf16 numbers the
program serves, computed in fp32). It follows big_vision's ViT as
google/siglip-so400m-patch14-384 publishes it: pixels to [-1, 1]; a
14 x 14 patch embedding and learned positions; 27 pre-LN layers
(LayerNorm eps 1e-6, 16 heads of 72, softmax(QK^T / sqrt(72)) V, MLP with
tanh-GELU); final LayerNorm; the MAP head (a learned probe attends over
every token, then y + MLP(LN(y))); L2 norm.

``precision="fp8"`` is the control: every dense layer's input and
weights rounded to float8 e4m3 (one scale a tensor, its largest
magnitude at 448), the products in fp32. Nothing here imports the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["to_fp32", "encode_image", "no_tf32"]


def no_tf32() -> None:
    """fp32 matrix products in fp32 (PyTorch may run them in TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_fp32(tree):
    if isinstance(tree, dict):
        return {k: to_fp32(v) for k, v in tree.items()}
    return tree.float()


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _dense(x, p, precision):
    w = p["w"]
    if precision == "fp8":
        x, w = _fp8(x), _fp8(w)
    return x @ w + p["b"]


def _ln(x, p):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * p["g"] + p["b"]


def _attention(xq, xkv, p, heads, precision):
    b, sq, d = xq.shape
    sk = xkv.shape[1]
    dh = d // heads
    q = _dense(xq, p["q"], precision).view(b, sq, heads, dh).transpose(1, 2)
    k = _dense(xkv, p["k"], precision).view(b, sk, heads, dh).transpose(1, 2)
    v = _dense(xkv, p["v"], precision).view(b, sk, heads, dh).transpose(1, 2)
    a = torch.softmax(q @ k.transpose(-1, -2) / dh**0.5, dim=-1)
    o = (a @ v).transpose(1, 2).reshape(b, sq, d)
    return _dense(o, p["o"], precision)


def _mlp(x, p, precision):
    return _dense(F.gelu(_dense(x, p["fc1"], precision), approximate="tanh"), p["fc2"], precision)


def _layer(blocks, i):
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) else t[i]
    return take(blocks)


def _encoder(x, blocks, heads, precision):
    for i in range(blocks["ln1"]["g"].shape[0]):
        p = _layer(blocks, i)
        h = _ln(x, p["ln1"])
        x = x + _attention(h, h, p["attn"], heads, precision)
        x = x + _mlp(_ln(x, p["ln2"]), p["mlp"], precision)
    return x


def _unit(e):
    return e / e.norm(dim=-1, keepdim=True)


def encode_image(params: dict, images: torch.Tensor, m: dict, precision: str = "fp32",
                 chunk: int = 16) -> torch.Tensor:
    """uint8 (B, R, R, 3) at the model resolution -> (B, d_emb) fp32 unit
    rows, ``chunk`` images at a time. ``params``: ``to_fp32`` of the tree."""
    p = params["img"]
    ps, r = m["patch_size"], m["image_size"]
    n = r // ps
    out = []
    for s in range(0, images.shape[0], chunk):
        x = images[s:s + chunk].float() / 127.5 - 1.0
        b = x.shape[0]
        x = x[:, :n * ps, :n * ps].reshape(b, n, ps, n, ps, 3).permute(0, 1, 3, 2, 4, 5)
        x = _dense(x.reshape(b, n * n, ps * ps * 3), p["patch_embed"], precision) + p["pos_emb"]
        x = _encoder(x, p["blocks"], m["num_heads"], precision)
        x = _ln(x, p["ln_final"])
        mh = p["map_head"]
        probe = mh["probe"][None].expand(b, 1, x.shape[-1])
        y = _attention(probe, x, mh, m["num_heads"], precision)
        y = y + _mlp(_ln(y, mh["ln"]), mh["mlp"], precision)
        out.append(_unit(y[:, 0]))
    return torch.cat(out)
