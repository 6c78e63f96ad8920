"""SigLIP image tower in PyTorch, served through the port's CUDA kernels.

Counterpart of ``meme_search_engine_tpu/models/siglip.py``: the same
configs, the same parameter tree (nested dicts of tensors, per-layer
weights stacked on a leading depth axis) and the same math with the same
bf16 cast points. ``encode_image`` always takes the fat-layout path
(packed QKV projection with a constant column per head, see
``ops/attention.py``): on the card that layout is plain arithmetic, not a
TPU lane rule. Each encoder layer runs four kernels: ``ln_matmul``
(LN1 + packed QKV + key mask), ``fat_vit_mha_packed``,
``matmul_residual`` (o-projection + residual) and ``ln_mlp_residual``;
the MAP head runs ``ln_matmul`` once more. Everything else (resize,
patch embedding, probe attention, MAP MLP, L2 norm) is plain torch, as
it is XLA in the reference.

Parameters are random-init (``init_params``) or converted from the JAX
package's tree (``models/convert.py``). ``prepare_params`` replaces the
image tower's leaves with the kernel layouts once at load time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import fat_vit_mha_packed, fat_width
from ..ops.fused import ln_matmul, ln_mlp_residual, matmul_residual, pad_hidden

Params = Dict[str, Any]

__all__ = [
    "SigLIPConfig",
    "SO400M_14_384",
    "tiny_test_config",
    "tiny_fat_test_config",
    "init_params",
    "prepare_params",
    "preprocess_image",
    "encode_image",
    "param_count",
]


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    image_size: int = 384
    patch_size: int = 14
    width: int = 1152
    depth: int = 27
    mlp_dim: int = 4304
    num_heads: int = 16
    text_width: int = 1152
    text_depth: int = 27
    text_mlp_dim: int = 4304
    text_num_heads: int = 16
    vocab_size: int = 32_000
    text_len: int = 64
    d_emb: int = 1152
    param_dtype: Any = torch.bfloat16
    # kept for config parity with the JAX package; the port's image tower
    # always runs the fat-layout path
    attn_impl: str = "auto"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2  # 729

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads  # 72


SO400M_14_384 = SigLIPConfig()


def tiny_test_config() -> SigLIPConfig:
    """A miniature config for unit tests."""
    return SigLIPConfig(
        image_size=28, patch_size=14, width=64, depth=2, mlp_dim=128,
        num_heads=4, text_width=64, text_depth=2, text_mlp_dim=128,
        text_num_heads=4, vocab_size=128, text_len=16, d_emb=64,
    )


def tiny_fat_test_config(attn_impl: str = "fat_interpret") -> SigLIPConfig:
    """Miniature config with 16 heads x fat_width(7) = 8 (the JAX package's
    fat-kernel test geometry)."""
    return SigLIPConfig(
        image_size=28, patch_size=14, width=112, depth=2, mlp_dim=128,
        num_heads=16, text_width=64, text_depth=2, text_mlp_dim=128,
        text_num_heads=4, vocab_size=128, text_len=16, d_emb=64,
        attn_impl=attn_impl,
    )


# ---------------------------------------------------------------------------
# Parameter initialisation
# ---------------------------------------------------------------------------


def _normal(gen, shape, std, dtype, device):
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def _dense_init(gen, lead, d_in, d_out, dtype, device):
    return {
        "w": _normal(gen, (*lead, d_in, d_out), (1.0 / d_in) ** 0.5, dtype, device),
        "b": torch.zeros((*lead, d_out), dtype=dtype, device=device),
    }


def _ln_init(lead, dim, dtype, device):
    return {
        "g": torch.ones((*lead, dim), dtype=dtype, device=device),
        "b": torch.zeros((*lead, dim), dtype=dtype, device=device),
    }


def _blocks_init(gen, depth, width, mlp_dim, dtype, device):
    lead = (depth,)
    return {
        "ln1": _ln_init(lead, width, dtype, device),
        "attn": {
            n: _dense_init(gen, lead, width, width, dtype, device)
            for n in ("q", "k", "v", "o")
        },
        "ln2": _ln_init(lead, width, dtype, device),
        "mlp": {
            "fc1": _dense_init(gen, lead, width, mlp_dim, dtype, device),
            "fc2": _dense_init(gen, lead, mlp_dim, width, dtype, device),
        },
    }


def init_params(
    cfg: SigLIPConfig = SO400M_14_384,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> Params:
    """Random-init the two-tower tree, same layout and shapes as the JAX
    ``init_params`` (different numbers: a torch generator is not a JAX key)."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt, g = cfg.param_dtype, generator
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    w = cfg.width
    img = {
        "patch_embed": _dense_init(g, (), patch_dim, w, dt, device),
        "pos_emb": _normal(g, (cfg.num_patches, w), 0.02, dt, device),
        "blocks": _blocks_init(g, cfg.depth, w, cfg.mlp_dim, dt, device),
        "ln_final": _ln_init((), w, dt, device),
        "map_head": {
            "probe": _normal(g, (1, w), 0.02, dt, device),
            **{n: _dense_init(g, (), w, w, dt, device) for n in ("q", "k", "v", "o")},
            "ln": _ln_init((), w, dt, device),
            "mlp": {
                "fc1": _dense_init(g, (), w, cfg.mlp_dim, dt, device),
                "fc2": _dense_init(g, (), cfg.mlp_dim, w, dt, device),
            },
        },
    }
    tw = cfg.text_width
    txt = {
        "token_emb": _normal(g, (cfg.vocab_size, tw), 0.02, dt, device),
        "pos_emb": _normal(g, (cfg.text_len, tw), 0.02, dt, device),
        "blocks": _blocks_init(g, cfg.text_depth, tw, cfg.text_mlp_dim, dt, device),
        "ln_final": _ln_init((), tw, dt, device),
        "head": _dense_init(g, (), tw, cfg.d_emb, dt, device),
    }
    return {
        "img": img,
        "txt": txt,
        "t": torch.tensor(float(np.log(10.0)), dtype=torch.float32, device=device),
        "b": torch.tensor(-10.0, dtype=torch.float32, device=device),
    }


def _fat_qkv_weights(attn: Params, num_heads: int, head_dim: int):
    """Fat-layout QKV projection weights (see ops/attention.py).

    Per head: [head_dim features, const column, zero pad]. The softmax
    scale multiplies the q weights and bias in bf16, as the reference does
    (``w * s`` on bf16 arrays, siglip.py:379). The const column rides the
    bias: q 1, k 0, v 1. Works on stacked (depth, D, D) weights too.
    """
    c = fat_width(head_dim)
    scale = float(torch.tensor(1.0 / head_dim**0.5, dtype=torch.bfloat16))

    def fat_w(w, s):
        lead, d_in = w.shape[:-2], w.shape[-2]
        if s != 1.0:
            w = (w.float() * s).to(w.dtype)
        w = w.reshape(*lead, d_in, num_heads, head_dim)
        return F.pad(w, (0, c - head_dim)).reshape(*lead, d_in, num_heads * c)

    def fat_b(b, s, const):
        lead = b.shape[:-1]
        if s != 1.0:
            b = (b.float() * s).to(b.dtype)
        b = F.pad(b.reshape(*lead, num_heads, head_dim), (0, c - head_dim)).clone()
        b[..., head_dim] = const
        return b.reshape(*lead, num_heads * c)

    return (
        (fat_w(attn["q"]["w"], scale), fat_b(attn["q"]["b"], scale, 1.0)),
        (fat_w(attn["k"]["w"], 1.0), fat_b(attn["k"]["b"], 1.0, 0.0)),
        (fat_w(attn["v"]["w"], 1.0), fat_b(attn["v"]["b"], 1.0, 1.0)),
    )


def _is_prepared(img: Params) -> bool:
    return "qkv" in img["blocks"]


def prepare_params(params: Params, cfg: SigLIPConfig) -> Params:
    """Replace the image tower's leaves with the kernels' layouts.

    Done once at load time. Per layer, q/k/v become one packed fat QKV
    projection (``blocks["qkv"]``), ``attn.o`` becomes ``blocks["o"]`` and
    the MLP weights become ``blocks["fc1"]``/``blocks["fc2"]`` with the
    hidden width zero-padded to the kernels' tile. The MAP head's k and v
    become one packed projection (``map_head["kv"]``). The tree keeps only
    what ``encode_image`` reads, so no weight is held twice. Returns a new
    top-level dict; the other towers are passed through.
    """
    img = params["img"]
    if _is_prepared(img):
        return params
    blocks, mh = img["blocks"], img["map_head"]
    (wq, bq), (wk, bk), (wv, bv) = _fat_qkv_weights(
        blocks["attn"], cfg.num_heads, cfg.head_dim
    )
    fc1, fc2 = blocks["mlp"]["fc1"], blocks["mlp"]["fc2"]
    w1, b1, w2 = pad_hidden(fc1["w"], fc1["b"], fc2["w"])
    prepared_blocks = {
        "ln1": blocks["ln1"],
        "qkv": {
            "w": torch.cat([wq, wk, wv], dim=-1).contiguous(),
            "b": torch.cat([bq, bk, bv], dim=-1).contiguous(),
        },
        "o": blocks["attn"]["o"],
        "ln2": blocks["ln2"],
        "fc1": {"w": w1.contiguous(), "b": b1.contiguous()},
        "fc2": {"w": w2.contiguous(), "b": fc2["b"]},
    }
    map_head = {
        "probe": mh["probe"],
        "q": mh["q"],
        "kv": {
            "w": torch.cat([mh["k"]["w"], mh["v"]["w"]], dim=1).contiguous(),
            "b": torch.cat([mh["k"]["b"], mh["v"]["b"]]).contiguous(),
        },
        "o": mh["o"],
        "ln": mh["ln"],
        "mlp": mh["mlp"],
    }
    prepared = {
        "patch_embed": img["patch_embed"],
        "pos_emb": img["pos_emb"],
        "blocks": prepared_blocks,
        "ln_final": img["ln_final"],
        "map_head": map_head,
    }
    return {**params, "img": prepared}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer_norm(x: torch.Tensor, p: Params) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-6)
    return (y * p["g"].float() + p["b"].float()).to(x.dtype)


def _dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    """fp32 accumulation, bias in fp32, one rounding (XLA's cast points)."""
    return (x.float() @ p["w"].float() + p["b"].float()).to(x.dtype)


def _mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    h = _dense(x, p["fc1"])
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return _dense(h, p["fc2"])


def _encoder_fat(
    x: torch.Tensor, blocks: Params, num_heads: int, n_valid: int
) -> torch.Tensor:
    """Padded-sequence encoder over (B, SP, D), rows >= n_valid padding;
    ``blocks`` in the layout of :func:`prepare_params`.

    The key mask rides the k constant column, written by ln_matmul's
    epilogue into every pad row; pad rows of the residual stream are
    computed like valid ones and never reach a valid output.
    """
    d = x.shape[-1]
    dh = d // num_heads
    c = fat_width(dh)
    ln1, qkv, o, ln2, fc1, fc2 = (
        blocks[k] for k in ("ln1", "qkv", "o", "ln2", "fc1", "fc2")
    )
    for i in range(ln1["g"].shape[0]):
        qkvf = ln_matmul(
            x, ln1["g"][i], ln1["b"][i], qkv["w"][i], qkv["b"][i],
            k_mask=(n_valid, num_heads, c, dh),
        )
        attn = fat_vit_mha_packed(qkvf, num_heads, dh)
        del qkvf
        x = matmul_residual(attn, o["w"][i], o["b"][i], x)
        x = ln_mlp_residual(
            x, ln2["g"][i], ln2["b"][i],
            fc1["w"][i], fc1["b"][i], fc2["w"][i], fc2["b"][i],
        )
    return x


def _map_head_fat(
    x: torch.Tensor, lnf: Params, p: Params, num_heads: int, n_valid: int
) -> torch.Tensor:
    """Final LN + MAP pooling head; the LN and the packed k|v projection
    run as one ln_matmul, the probe attention over n_valid keys is plain
    torch."""
    b, sp, d = x.shape
    dh = d // num_heads
    kv = ln_matmul(x, lnf["g"], lnf["b"], p["kv"]["w"], p["kv"]["b"])  # (B, SP, 2D)
    q = _dense(p["probe"].to(x.dtype), p["q"]).reshape(num_heads, dh)
    k = kv[:, :, :d].reshape(b, sp, num_heads, dh)
    v = kv[:, :, d:].reshape(b, sp, num_heads, dh)
    scores = torch.einsum("hd,bkhd->bhk", q.float(), k.float()) * (1.0 / dh**0.5)
    mask = torch.arange(sp, device=x.device) < n_valid
    scores = scores.masked_fill(~mask[None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum(
        "bhk,bkhd->bhd", probs.to(v.dtype).float(), v.float()
    ).to(x.dtype)
    y = _dense(o.reshape(b, 1, d), p["o"])
    y = y + _mlp(_layer_norm(y, p["ln"]), p["mlp"])
    return y[:, 0]


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of a triangle-kernel antialiased resize,
    built as ``jax.image.scale.compute_weight_mat`` builds them."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def preprocess_image(images: torch.Tensor, cfg: SigLIPConfig = SO400M_14_384) -> torch.Tensor:
    """uint8 (B,H,W,3) -> model input (B,R,R,3) in [-1,1], param dtype.

    Bilinear antialiased resize (two fp32 matmuls with per-axis weights)
    when H or W differs from the model resolution, then value range
    (-1, 1), as the reference's in-graph preprocessing (siglip.py:643-658).
    """
    x = images.float()
    r = cfg.image_size
    h, w = images.shape[1], images.shape[2]
    if h != r:
        wh = torch.from_numpy(_resize_weights(h, r)).to(x.device)
        x = torch.einsum("bhwc,hH->bHwc", x, wh)
    if w != r:
        ww = torch.from_numpy(_resize_weights(w, r)).to(x.device)
        x = torch.einsum("bhwc,wW->bhWc", x, ww)
    return (x / 127.5 - 1.0).to(cfg.param_dtype)


@torch.inference_mode()
def encode_image(
    params: Params,
    images: torch.Tensor,
    cfg: SigLIPConfig = SO400M_14_384,
    *,
    normalize: bool = True,
    preprocessed: bool = False,
) -> torch.Tensor:
    """Images -> fp32 embeddings (B, d_emb), L2-normalised by default.

    ``images``: uint8 (B,H,W,3), or float (B,R,R,3) in [-1,1] when
    ``preprocessed``. ``params`` must have been through
    :func:`prepare_params`.
    """
    p = params["img"]
    if not _is_prepared(p):
        raise ValueError("encode_image needs prepare_params(params, cfg) first")
    x = images.to(cfg.param_dtype) if preprocessed else preprocess_image(images, cfg)
    b = x.shape[0]
    n_side = cfg.image_size // cfg.patch_size
    span = n_side * cfg.patch_size
    ps = cfg.patch_size
    # stride == kernel conv == crop + blocked reshape + one matmul
    x = x[:, :span, :span, :].reshape(b, n_side, ps, n_side, ps, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, n_side * n_side, ps * ps * 3)
    x = _dense(x, p["patch_embed"])
    x = x + p["pos_emb"][None].to(x.dtype)
    s = cfg.num_patches
    sp = ((s + 15) // 16) * 16  # row padding, as the reference (729 -> 736)
    x = F.pad(x, (0, 0, 0, sp - s)).contiguous()
    x = _encoder_fat(x, p["blocks"], cfg.num_heads, n_valid=s)
    emb = _map_head_fat(x, p["ln_final"], p["map_head"], cfg.num_heads, n_valid=s).float()
    if normalize:
        emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True)
    return emb


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(params: Params) -> int:
    """Parameters of a source tree (``init_params`` layout); a prepared
    tree holds padded kernel layouts and is refused."""
    if "img" in params and _is_prepared(params["img"]):
        raise ValueError("param_count takes the tree from before prepare_params")
    return sum(int(t.numel()) for t in _leaves(params))
