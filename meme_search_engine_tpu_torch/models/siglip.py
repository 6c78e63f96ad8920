"""SigLIP two-tower encoder in PyTorch, served through the port's CUDA kernels.

Counterpart of ``meme_search_engine_tpu/models/siglip.py``: the same
configs, the same parameter tree (nested dicts of tensors, per-layer
weights stacked on a leading depth axis) and the same math with the same
bf16 cast points.

- ``encode_image`` takes the fat-layout path unless ``cfg.attn_impl`` is
  "xla" (packed QKV projection with a constant column per head, see
  ``ops/attention.py``): on the card that layout is plain arithmetic, not
  a TPU lane rule. Each encoder layer runs four kernels: ``ln_matmul``
  (LN1 + packed QKV + key mask), ``fat_vit_mha_packed``,
  ``matmul_residual`` (o-projection + residual) and ``ln_mlp_residual``;
  the MAP head runs ``ln_matmul`` once more. With "xla" it runs the plain
  encoder below and the non-fat MAP head, as the JAX package does.
- ``encode_text`` runs the plain pre-LN encoder (``_encoder``) by default,
  whose self-attention goes through ``ops.attention.mha``: the fused
  attention kernel (``csrc/mha.cu``) on the card, as ``fused_mha_pallas``
  on the TPU. Its two other routes are the JAX package's
  (``encode_text``): ``_encoder_text`` under ``MSE_TEXT_FUSED=1`` on the
  card, and the image tower's fat-layout encoder under
  ``attn_impl="fat_interpret"``.
- ``siglip_loss`` (the sigmoid loss, JAX ``siglip.py:792``) builds a graph
  that autograd differentiates. No kernel here has a backward, nor has any
  Pallas kernel of the JAX package, whose train step runs off a TPU. So
  the loss takes the plain route by argument: the image tower's plain
  encoder and MAP head, and ``mha_xla`` for every attention. The kernel
  wrappers raise on an input that requires grad.

``encode_image`` and ``encode_text`` are the inference wrappers (under
``torch.inference_mode``) around the graph-building ``_embed_image`` and
``_embed_text``, which the loss and ``parallel/train.py`` call. Those take
an optional ``par``, the tensor-parallel context of ``parallel/train.py``:
column-parallel q, k, v and fc1, row-parallel o and fc2, and the global
batch's embeddings gathered over the data-parallel ranks.

Everything else (resize, patch embedding, dense layers, LayerNorm, MLP,
probe attention, L2 norm) is plain torch, as it is XLA in the reference.
On the card the dense layers are bf16 GEMMs with fp32 accumulation.

SigLIP 2's NaFlex image towers (``max_num_patches`` > 0; the published
google/siglip2-so400m-patch16-naflex is ``SO400M_16_NAFLEX_1024`` at 1024
patches) run the same fat-layout encoder over pictures at their own
aspect ratios: each picture's patches in row-major grid order, padded to
``max_num_patches`` rows; the patch embedding is a Linear over each
16 x 16 patch flattened as (row, col, channel); the learned 16 x 16
position table is resized to each picture's grid as the published model
does (bilinear, :func:`naflex_position_weights`) and enters the patch
embedding's GEMM as 256 more input features; every attention and the MAP
head mask each picture's pad keys by its own valid length (kernel 1's
per-sequence key mask). The text tower is SigLIP's.

Parameters are random-init (``init_params``), converted from the JAX
package's tree (``models/convert.py``) or loaded from a HuggingFace
checkpoint (``load_hf_siglip``; SigLIP 2's ``load_hf_siglip2``).
``prepare_params`` replaces the image tower's leaves with the kernel
layouts once at load time, and pads the text tower's MLP for the kernels.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import fat_layout_ok, fat_vit_mha_packed, fat_width, fused_mha, mha, mha_xla
from ..ops.fused import ln_matmul, ln_mlp_residual, matmul_residual, pad_hidden
from ..utils import profiling
from .safetensors_io import read_safetensors

Params = Dict[str, Any]

__all__ = [
    "SigLIPConfig",
    "SO400M_14_384",
    "SO400M_16_NAFLEX_1024",
    "tiny_test_config",
    "tiny_naflex_test_config",
    "tiny_fat_test_config",
    "init_params",
    "prepare_params",
    "preprocess_image",
    "encode_image",
    "encode_text",
    "siglip_loss",
    "ZERO_GRAD_LEAVES",
    "load_hf_siglip",
    "load_hf_siglip2",
    "naflex_position_weights",
    "naflex_patchify",
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
    # image-tower route: "xla" runs the plain encoder and MAP head; any
    # other value ("auto", "fat_interpret") the fat-layout kernels
    attn_impl: str = "auto"
    # SigLIP 2 NaFlex: the sequence cap (0: fixed resolution). The
    # position table is then (image_size // patch_size)^2 rows, resized to
    # each picture's grid
    max_num_patches: int = 0

    @property
    def num_patches(self) -> int:
        """Rows of the position table (729 at SO400M/14@384, 256 at NaFlex)."""
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads  # 72


SO400M_14_384 = SigLIPConfig()

# google/siglip2-so400m-patch16-naflex at max_num_patches 1024: the same
# widths, a Linear patch embedding of 16 x 16 x 3, a 16 x 16 position
# table, the Gemma vocabulary
SO400M_16_NAFLEX_1024 = SigLIPConfig(image_size=256, patch_size=16, vocab_size=256_000,
                                     max_num_patches=1024)


def tiny_test_config() -> SigLIPConfig:
    """A miniature config for unit tests."""
    return SigLIPConfig(
        image_size=28, patch_size=14, width=64, depth=2, mlp_dim=128,
        num_heads=4, text_width=64, text_depth=2, text_mlp_dim=128,
        text_num_heads=4, vocab_size=128, text_len=16, d_emb=64,
    )


def tiny_naflex_test_config(max_num_patches: int = 64) -> SigLIPConfig:
    """The tiny geometry as a NaFlex tower: patch 4, a 4 x 4 position
    table, ``max_num_patches`` rows a picture."""
    return dataclasses.replace(tiny_test_config(), image_size=16, patch_size=4,
                               max_num_patches=max_num_patches)


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


def _uses_fat_path(cfg: SigLIPConfig) -> bool:
    return cfg.attn_impl != "xla"


def prepare_params(params: Params, cfg: SigLIPConfig) -> Params:
    """Put both towers into the kernels' layouts; returns a new top-level
    dict, the scalars passed through.

    Done once at load time. Image tower (unless ``attn_impl="xla"``, the
    plain route, which reads it as it is): per layer, q/k/v become one
    packed fat QKV projection (``blocks["qkv"]``), ``attn.o`` becomes
    ``blocks["o"]`` and the MLP weights become ``blocks["fc1"]`` /
    ``blocks["fc2"]`` with the hidden width zero-padded to the kernels'
    tile. The MAP head's k and v become one packed projection
    (``map_head["kv"]``). The tree keeps only what ``encode_image`` reads,
    so no weight is held twice. Text tower: the MLP's hidden width is
    zero-padded the same way (in place of the unpadded weights, which
    leaves the plain route's math as it is: gelu(0) = 0 meets zero rows of
    fc2), and an empty ``layouts`` dict holds the fused and fat routes'
    packed QKV weights, built on each route's first use
    (:func:`_text_layout`).
    """
    out = dict(params)
    img = params.get("img")
    if img is not None and _uses_fat_path(cfg) and not _is_prepared(img):
        out["img"] = _prepare_image(img, cfg)
    txt = params.get("txt")
    if txt is not None and "layouts" not in txt:
        fc1, fc2 = txt["blocks"]["mlp"]["fc1"], txt["blocks"]["mlp"]["fc2"]
        w1, b1, w2 = pad_hidden(fc1["w"], fc1["b"], fc2["w"])
        mlp = {"fc1": {"w": w1.contiguous(), "b": b1.contiguous()},
               "fc2": {"w": w2.contiguous(), "b": fc2["b"]}}
        out["txt"] = {**txt, "blocks": {**txt["blocks"], "mlp": mlp}, "layouts": {}}
    return out


def _fat_qkv(attn: Params, head_dim: int) -> Params:
    """The packed fat q|k|v projection (:func:`_fat_qkv_weights`) over
    every head."""
    fat = _fat_qkv_weights(attn, attn["q"]["w"].shape[-1] // head_dim, head_dim)
    return {"w": torch.cat([w for w, _ in fat], dim=-1).contiguous(),
            "b": torch.cat([b for _, b in fat], dim=-1).contiguous()}


def _prepare_image(img: Params, cfg: SigLIPConfig) -> Params:
    blocks, mh = img["blocks"], img["map_head"]
    fc1, fc2 = blocks["mlp"]["fc1"], blocks["mlp"]["fc2"]
    w1, b1, w2 = pad_hidden(fc1["w"], fc1["b"], fc2["w"])
    prepared_blocks = {
        "ln1": blocks["ln1"],
        "qkv": _fat_qkv(blocks["attn"], cfg.head_dim),
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
    if cfg.max_num_patches:
        # NaFlex: the position table rides the patch embedding's GEMM as
        # num_patches more input rows (naflex_position_weights)
        pe = img["patch_embed"]
        embed = {"patch_pos": {"w": torch.cat([pe["w"], img["pos_emb"].to(pe["w"].dtype)]).contiguous(),
                               "b": pe["b"]}}
    else:
        embed = {"patch_embed": img["patch_embed"], "pos_emb": img["pos_emb"]}
    return {
        **embed,
        "blocks": prepared_blocks,
        "ln_final": img["ln_final"],
        "map_head": map_head,
    }


def _text_layout(txt: Params, name: str, head_dim: int) -> Params:
    """The packed QKV weights of a text route, a dict of stacked (depth,
    ...) tensors: ``"qkv"``, q|k|v (D, 3D) for ``_encoder_text``;
    ``"fat"``, the image tower's block layout (:func:`prepare_params`)
    with the fat q|k|v for ``_encoder_fat``, whose other leaves are the
    tree's own. Built on the route's first use and kept in the prepared
    tree's ``layouts``, so each is built once."""
    if "layouts" not in txt:
        raise ValueError("the text tower's fused and fat routes need prepare_params(params, cfg) first")
    if name not in txt["layouts"]:
        blocks = txt["blocks"]
        txt["layouts"][name] = (_packed_qkv(blocks) if name == "qkv"
                                else _fat_text_blocks(blocks, head_dim))
    return txt["layouts"][name]


def _packed_qkv(blocks: Params) -> Params:
    attn = blocks["attn"]
    return {
        "w": torch.cat([attn[n]["w"] for n in "qkv"], dim=-1).contiguous(),
        "b": torch.cat([attn[n]["b"] for n in "qkv"], dim=-1).contiguous(),
    }


def _fat_text_blocks(blocks: Params, head_dim: int) -> Params:
    return {
        "ln1": blocks["ln1"],
        "qkv": _fat_qkv(blocks["attn"], head_dim),
        "o": blocks["attn"]["o"],
        "ln2": blocks["ln2"],
        "fc1": blocks["mlp"]["fc1"],
        "fc2": blocks["mlp"]["fc2"],
    }


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
    """x @ w + b with XLA's cast points: fp32 accumulation, the bias added
    in fp32, one rounding to x's dtype.

    On the card one ``torch.addmm`` in x's dtype does that (a bf16 GEMM
    accumulates in fp32 and adds the bias before its one rounding). On the
    CPU the operands are upcast to fp32 and the sum rounded once.
    """
    if x.device.type == "cuda":
        lead = x.shape[:-1]
        y = torch.addmm(p["b"], x.reshape(-1, x.shape[-1]), p["w"])
        return y.reshape(*lead, y.shape[-1])
    return (x.float() @ p["w"].float() + p["b"].float()).to(x.dtype)


def _mlp(x: torch.Tensor, p: Params, par=None) -> torch.Tensor:
    """fc1, tanh-gelu, fc2; with ``par``, fc1 column-parallel and fc2
    row-parallel over the model group."""
    if par is not None:
        x = par.enter(x)
    h = _dense(x, p["fc1"])
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return _dense(h, p["fc2"]) if par is None else par.row_dense(h, p["fc2"])


def _attn(
    x: torch.Tensor, p: Params, num_heads: int, kv: torch.Tensor | None = None,
    attention=mha, par=None,
):
    """Multi-head attention block; ``kv`` for cross-attention (MAP head).
    ``attention`` takes (B, S, H, Dh) q, k, v. With ``par`` (self-attention
    only) the q, k, v weights hold this rank's heads and o its rows."""
    b, s, d = x.shape
    dh = d // num_heads
    if par is not None:
        x = par.enter(x)
    src = x if kv is None else kv
    sk = src.shape[1]
    q = _dense(x, p["q"])
    h = q.shape[-1] // dh  # the heads this rank holds
    q = q.reshape(b, s, h, dh)
    k = _dense(src, p["k"]).reshape(b, sk, h, dh)
    v = _dense(src, p["v"]).reshape(b, sk, h, dh)
    o = attention(q, k, v).reshape(b, s, h * dh)
    return _dense(o, p["o"]) if par is None else par.row_dense(o, p["o"])


def _encoder(
    x: torch.Tensor, blocks: Params, num_heads: int, attention=mha, par=None
) -> torch.Tensor:
    """Pre-LN transformer encoder over stacked block params; bf16
    residual adds, as the reference's scan step."""
    for blk in _layers(blocks):
        x = x + _attn(_layer_norm(x, blk["ln1"]), blk["attn"], num_heads,
                      attention=attention, par=par)
        x = x + _mlp(_layer_norm(x, blk["ln2"]), blk["mlp"], par)
    return x


def _layers(tree) -> list:
    """Every layer of a tree of stacked per-layer tensors, unbound at once
    (autograd stacks the layers' gradients in one operation)."""
    if isinstance(tree, dict):
        parts = {k: _layers(v) for k, v in tree.items()}
        depth = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(depth)]
    return list(torch.unbind(tree))


def _map_head(x: torch.Tensor, p: Params, num_heads: int, attention=mha) -> torch.Tensor:
    """MAP (multihead attention pooling) head over every row of x: the
    probe attends through ``_attn``, whose single query takes the plain
    attention route."""
    b, _, d = x.shape
    probe = p["probe"][None].expand(b, 1, d).to(x.dtype)
    y = _attn(probe, p, num_heads, kv=x, attention=attention)
    y = y + _mlp(_layer_norm(y, p["ln"]), p["mlp"])
    return y[:, 0]


def _encoder_fat(
    x: torch.Tensor, blocks: Params, num_heads: int, n_valid
) -> torch.Tensor:
    """Padded-sequence encoder over (B, SP, D), rows >= n_valid padding
    (an int, or an int32 (B,) tensor of each sequence's own on x's device);
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
        del attn  # freed before the MLP's hidden scratch is allocated
        x = ln_mlp_residual(
            x, ln2["g"][i], ln2["b"][i],
            fc1["w"][i], fc1["b"][i], fc2["w"][i], fc2["b"][i],
        )
    return x


def _key_mask(n_valid, sp: int, device) -> torch.Tensor:
    """(1 or B, SP) bool, True at the valid keys: the first ``n_valid``
    (an int, or a (B,) tensor of each sequence's own)."""
    keys = torch.arange(sp, device=device)[None, :]
    if isinstance(n_valid, torch.Tensor):
        return keys < n_valid.to(device)[:, None]
    return keys < n_valid


def _map_head_fat(
    x: torch.Tensor, lnf: Params, p: Params, num_heads: int, n_valid
) -> torch.Tensor:
    """Final LN + MAP pooling head; the LN and the packed k|v projection
    run as one ln_matmul, the probe attention over the n_valid keys (an
    int, or each sequence's own in a (B,) tensor) is plain torch."""
    b, sp, d = x.shape
    dh = d // num_heads
    kv = ln_matmul(x, lnf["g"], lnf["b"], p["kv"]["w"], p["kv"]["b"])  # (B, SP, 2D)
    q = _dense(p["probe"].to(x.dtype), p["q"]).reshape(num_heads, dh)
    k = kv[:, :, :d].reshape(b, sp, num_heads, dh)
    v = kv[:, :, d:].reshape(b, sp, num_heads, dh)
    scores = torch.einsum("hd,bkhd->bhk", q.float(), k.float()) * (1.0 / dh**0.5)
    mask = _key_mask(n_valid, sp, x.device)
    scores = scores.masked_fill(~mask[:, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum(
        "bhk,bkhd->bhd", probs.to(v.dtype).float(), v.float()
    ).to(x.dtype)
    y = _dense(o.reshape(b, 1, d), p["o"])
    y = y + _mlp(_layer_norm(y, p["ln"]), p["mlp"])
    return y[:, 0]


def _encoder_text(
    x: torch.Tensor,
    blocks: Params,
    num_heads: int,
    qkv=None,
    *,
    fused_qkv: bool = False,
    fused_o: bool = False,
    fused_mlp: bool = False,
) -> torch.Tensor:
    """The text tower's short-sequence encoder (JAX ``_encoder_text``),
    over (B, S, D) and the text tower's blocks.

    LayerNorm, the projections and the MLP are per row, so each runs on
    the (B*S, D) rows as they lie. QKV is one packed q|k|v projection
    (``qkv``: its stacked weights, :func:`_text_layout`; built
    here from the blocks when not given); the attention always runs the
    fused attention kernel (``fused_mha``), reading q, k and v in place
    from the packed (B, S, 3, H, Dh) view. Each other sub-block takes its
    kernel when its flag is set (the JAX package's ``MSE_TEXT_QKV``,
    ``MSE_TEXT_O``, ``MSE_TEXT_MLP`` = ``fused``): ``ln_matmul`` for LN1 +
    QKV, ``matmul_residual`` for the o-projection + residual,
    ``ln_mlp_residual`` for LN2 + MLP + residual (its hidden width a
    multiple of 128: :func:`prepare_params`); else the plain torch layers,
    as the JAX package's XLA ones. The same math either way (fp32 LN
    statistics and accumulation). The JAX function's tiling knobs
    (``MSE_TEXT_RQ``, ``MSE_TEXT_NQ``, ``MSE_TEXT_ATTN_HPP``,
    ``MSE_MLP_MH``, and ``MSE_SCAN_UNROLL`` of its fat encoder) change a
    TPU kernel's blocking, never its math: the port reads none of them.
    """
    b, s, d = x.shape
    dh = d // num_heads
    qkv = _packed_qkv(blocks) if qkv is None else qkv
    for blk, w in zip(_layers(blocks), _layers(qkv)):
        if fused_qkv:
            y = ln_matmul(x, blk["ln1"]["g"], blk["ln1"]["b"], w["w"], w["b"])
        else:
            y = _dense(_layer_norm(x, blk["ln1"]), w)
        y = y.reshape(b, s, 3, num_heads, dh)
        o = fused_mha(y[:, :, 0], y[:, :, 1], y[:, :, 2]).reshape(b, s, d)
        po = blk["attn"]["o"]
        x = matmul_residual(o, po["w"], po["b"], x) if fused_o else x + _dense(o, po)
        del y, o  # freed before the MLP's hidden activations are allocated
        if fused_mlp:
            fc1, fc2 = blk["mlp"]["fc1"], blk["mlp"]["fc2"]
            x = ln_mlp_residual(x, blk["ln2"]["g"], blk["ln2"]["b"], fc1["w"], fc1["b"],
                                fc2["w"], fc2["b"])
        else:
            x = x + _mlp(_layer_norm(x, blk["ln2"]), blk["mlp"])
    return x


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


def _patches(p: Params, x: torch.Tensor, cfg: SigLIPConfig) -> torch.Tensor:
    """(B, R, R, 3) model input -> (B, num_patches, width): the patch
    embedding (a stride == kernel conv is a crop, a blocked reshape and one
    matmul) plus the position embedding."""
    b = x.shape[0]
    n_side = cfg.image_size // cfg.patch_size
    span = n_side * cfg.patch_size
    ps = cfg.patch_size
    x = x[:, :span, :span, :].reshape(b, n_side, ps, n_side, ps, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, n_side * n_side, ps * ps * 3)
    x = _dense(x, p["patch_embed"])
    return x + p["pos_emb"][None].to(x.dtype)


def _resize_taps(pos: torch.Tensor, n_out: torch.Tensor, n_in: int) -> torch.Tensor:
    """(..., n_in) fp32 weights that resize n_in samples to n_out (a
    tensor broadcast against ``pos``) at output positions ``pos``, as
    ``F.interpolate(mode="bilinear", align_corners=False, antialias=True)``
    takes them: a triangle of half-width max(n_in / n_out, 1) in source
    samples around ``(pos + 0.5) * n_in / n_out``, normalised. Upsampling
    that is plain bilinear (its two neighbours, clamped at the edges)."""
    scale = n_in / n_out.float()
    center = (pos.float() + 0.5) * scale
    support = scale.clamp_min(1.0)
    j = torch.arange(n_in, device=pos.device, dtype=torch.float32) + 0.5
    w = (1.0 - ((j - center[..., None]) / support[..., None]).abs()).clamp_min(0.0)
    return w / w.sum(-1, keepdim=True)


def naflex_position_weights(grids: torch.Tensor, rows: int, side: int) -> torch.Tensor:
    """(B, rows, side^2) fp32: row s of picture b holds the weights that
    take its position embedding from the side x side table (row i*side+j
    is the table's (i, j)) resized to the picture's (h, w) grid as the
    published model resizes it (``F.interpolate(..., mode="bilinear",
    align_corners=False, antialias=True)``, separable: a product of one
    weight vector a side). Patch s lies at (s // w, s % w); pad rows
    (s >= h*w) take the resized table's first row, as the published model
    pads. ``grids``: (B, 2) integer (h, w), on the device the weights
    are wanted on. A few launches a bucket, whatever its grids."""
    h, w = grids[:, :1].long(), grids[:, 1:].long()
    s = torch.arange(rows, device=grids.device)[None, :]
    valid = s < h * w
    y = torch.where(valid, s // w, 0)
    x = torch.where(valid, s % w, 0)
    wy = _resize_taps(y, h, side)
    wx = _resize_taps(x, w, side)
    return (wy[..., :, None] * wx[..., None, :]).reshape(grids.shape[0], rows, side * side)


def naflex_patchify(pixels: torch.Tensor, grids: torch.Tensor, cfg: SigLIPConfig) -> torch.Tensor:
    """A bucket's pictures as (B, max_num_patches, P*P*3) patches in
    row-major grid order, each flattened as (row, col, channel), by one
    gather on the pictures' device. ``pixels``: (B, max_num_patches*P*P*3)
    uint8, row b picture b's (P h, P w, 3) pixels in C order, zero past
    them; ``grids``: (B, 2) integer (h, w) in patches on the same device.
    Pad patches come out zero."""
    p, rows = cfg.patch_size, cfg.max_num_patches
    b = pixels.shape[0]
    chunk = p * 3  # one patch row's bytes: 16 pixels of 3 channels
    h, w = grids[:, :1].long(), grids[:, 1:].long()
    k = torch.arange(rows, device=pixels.device)[None, :]
    py = torch.arange(p, device=pixels.device)
    # picture b's pixel row P y + py, patch column x is its chunk
    # (P y + py) w + x; a pad patch k reads chunks P k + py, past the picture
    inside = ((k // w) * p)[..., None] + py
    idx = torch.where((k < h * w)[..., None], inside * w[..., None] + (k % w)[..., None],
                      k[..., None] * p + py)
    idx = idx + (torch.arange(b, device=pixels.device) * (rows * p))[:, None, None]
    return pixels.reshape(b * rows * p, chunk).index_select(0, idx.reshape(-1)).reshape(
        b, rows, p * chunk)


def _encode_naflex(p: Params, images: torch.Tensor, grids, cfg: SigLIPConfig,
                   preprocessed: bool) -> torch.Tensor:
    """The NaFlex image tower over one bucket, before the L2 norm."""
    if not _uses_fat_path(cfg):
        raise ValueError("the NaFlex image tower runs the fat layout; attn_impl='xla' has no key masks")
    if "patch_pos" not in p:
        raise ValueError("encode_image needs prepare_params(params, cfg) with the NaFlex cfg first")
    g = torch.as_tensor(grids).to(images.device, torch.int32)
    b, rows = images.shape[0], cfg.max_num_patches
    if tuple(g.shape) != (b, 2):
        raise ValueError(f"grids: expected ({b}, 2) (h, w) in patches, got {tuple(g.shape)}")
    with profiling.span("siglip.positions", images=b):
        side = cfg.image_size // cfg.patch_size
        pos = naflex_position_weights(g, rows, side).to(cfg.param_dtype)
    if images.dim() == 2:
        images = naflex_patchify(images, g, cfg)
    x = images.to(cfg.param_dtype) if preprocessed else (images.float() / 127.5 - 1.0).to(cfg.param_dtype)
    x = _dense(torch.cat([x, pos], dim=-1), p["patch_pos"])
    del pos
    sp = ((rows + 15) // 16) * 16
    x = F.pad(x, (0, 0, 0, sp - rows)).contiguous()
    lens = (g[:, 0] * g[:, 1]).contiguous()
    x = _encoder_fat(x, p["blocks"], cfg.num_heads, n_valid=lens)
    return _map_head_fat(x, p["ln_final"], p["map_head"], cfg.num_heads, n_valid=lens)


def _normalized(emb: torch.Tensor, normalize: bool) -> torch.Tensor:
    emb = emb.float()
    return emb / torch.linalg.norm(emb, dim=-1, keepdim=True) if normalize else emb


def _embed_image(
    params: Params, x: torch.Tensor, cfg: SigLIPConfig, attention=mha, par=None,
    normalize: bool = True,
) -> torch.Tensor:
    """The image tower's plain route, as a graph: (B, R, R, 3) model input
    in [-1, 1] -> fp32 (B, d_emb). Reads the source tree (not prepared)."""
    p = params["img"]
    if _is_prepared(p):
        raise ValueError(
            "the plain image route reads the source tree; these params were prepared "
            "for the fat-layout path"
        )
    x = _patches(p, x.to(cfg.param_dtype), cfg)
    x = _encoder(x, p["blocks"], cfg.num_heads, attention, par)
    x = _layer_norm(x, p["ln_final"])
    return _normalized(_map_head(x, p["map_head"], cfg.num_heads, attention), normalize)


@torch.inference_mode()
def encode_image(
    params: Params,
    images: torch.Tensor,
    cfg: SigLIPConfig = SO400M_14_384,
    *,
    normalize: bool = True,
    preprocessed: bool = False,
    grids=None,
) -> torch.Tensor:
    """Images -> fp32 embeddings (B, d_emb), L2-normalised by default.

    ``images``: uint8 (B,H,W,3), or float (B,R,R,3) in [-1,1] when
    ``preprocessed``. ``params`` must have been through
    :func:`prepare_params` with the same ``cfg``.

    NaFlex (``cfg.max_num_patches``): ``images`` is a bucket's patches,
    (B, max_num_patches, P*P*3) uint8 (or float in [-1, 1] when
    ``preprocessed``) in row-major grid order, or its pictures' pixels
    as :func:`naflex_patchify` takes them, (B, max_num_patches*P*P*3)
    uint8; ``grids`` (B, 2) their (h, w) in patches, best on the
    images' device (the engine's staging buffer carries both in one copy,
    ``serving.engine.naflex_views``).
    """
    if cfg.max_num_patches:
        if grids is None:
            raise ValueError("the NaFlex image tower needs each picture's grid")
        return _normalized(_encode_naflex(params["img"], images, grids, cfg, preprocessed), normalize)
    x = images.to(cfg.param_dtype) if preprocessed else preprocess_image(images, cfg)
    if not _uses_fat_path(cfg):
        return _embed_image(params, x, cfg, normalize=normalize)
    p = params["img"]
    if not _is_prepared(p):
        raise ValueError("encode_image needs prepare_params(params, cfg) first")
    x = _patches(p, x, cfg)
    s = cfg.num_patches
    sp = ((s + 15) // 16) * 16  # row padding, as the reference (729 -> 736)
    x = F.pad(x, (0, 0, 0, sp - s)).contiguous()
    x = _encoder_fat(x, p["blocks"], cfg.num_heads, n_valid=s)
    emb = _map_head_fat(x, p["ln_final"], p["map_head"], cfg.num_heads, n_valid=s)
    return _normalized(emb, normalize)


def _embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, tokens, axis=0)``: ids in [-V, -1] wrap, any
    other out-of-range id gives a NaN row. The gather itself only sees
    clamped ids, so a bad id never becomes a device-side assert."""
    vocab = table.shape[0]
    ids = tokens.long()
    ids = torch.where(ids < 0, ids + vocab, ids)
    valid = (ids >= 0) & (ids < vocab)
    rows = table[ids.clamp(0, vocab - 1)]
    return rows.masked_fill(~valid[..., None], float("nan"))


def _embed_text(
    params: Params, tokens: torch.Tensor, cfg: SigLIPConfig, attention=mha, par=None,
    normalize: bool = True, encoder=None,
) -> torch.Tensor:
    """The text tower as a graph: token ids (B, text_len) -> fp32
    (B, d_emb). big_vision text_transformer semantics, as the reference:
    token and position embeddings, the pre-LN encoder (``encoder(x)``
    where given, else :func:`_encoder`), final LN, last-token pool (the
    sticky-EOS tokenisation puts the sentence at position -1), then the
    output head."""
    p = params["txt"]
    x = _embed_tokens(p["token_emb"], tokens)
    x = x + p["pos_emb"][None].to(x.dtype)
    if encoder is None:
        x = _encoder(x, p["blocks"], cfg.text_num_heads, attention, par)
    else:
        x = encoder(x)
    x = _layer_norm(x, p["ln_final"])
    return _normalized(_dense(x[:, -1], p["head"]), normalize)


@torch.inference_mode()
def encode_text(
    params: Params,
    tokens: torch.Tensor,
    cfg: SigLIPConfig = SO400M_14_384,
    *,
    normalize: bool = True,
) -> torch.Tensor:
    """Token ids (B, text_len) -> fp32 embeddings (B, d_emb), L2-normalised
    by default, by the JAX package's route choice (its ``encode_text``):

    - the fat-layout encoder (``_encoder_fat`` with every key valid, the
      image tower's kernels 1, 7, 2 and 3) when ``fat_layout_ok`` holds
      and ``cfg.attn_impl`` is "fat_interpret" (or "auto" on the card at a
      sequence of 256 or more, which no config has);
    - else :func:`_encoder_text` when ``MSE_TEXT_FUSED=1``, the weights
      lie on the card (the JAX package's "the backend is a TPU") and the
      head width is a multiple of 8, its sub-blocks routed by
      ``MSE_TEXT_QKV``, ``MSE_TEXT_O`` and ``MSE_TEXT_MLP`` (``fused`` or
      ``xla``, the default); off by default, as in the JAX package;
    - else the plain encoder (self-attention through ``mha``).

    The variables are read at each call; the JAX package reads them when
    it traces. The two routes' packed QKV weights are built on a route's
    first use (:func:`_text_layout`), so ``params`` must have been
    through :func:`prepare_params` for them.
    """
    p = params["txt"]
    th = cfg.text_num_heads
    dh = cfg.text_width // th
    sp = cfg.text_len
    on_card = p["token_emb"].device.type == "cuda"
    encoder = None
    if fat_layout_ok(th, dh, sp) and (
        cfg.attn_impl == "fat_interpret" or (cfg.attn_impl == "auto" and on_card and sp >= 256)
    ):
        blocks = _text_layout(p, "fat", dh)
        encoder = lambda x: _encoder_fat(x, blocks, th, n_valid=sp)  # noqa: E731
    elif os.environ.get("MSE_TEXT_FUSED", "0") == "1" and on_card and dh % 8 == 0:
        qkv = _text_layout(p, "qkv", dh)
        flags = {f"fused_{k.lower()}": os.environ.get(f"MSE_TEXT_{k}", "xla") == "fused"
                 for k in ("QKV", "O", "MLP")}
        encoder = lambda x: _encoder_text(x, p["blocks"], th, qkv, **flags)  # noqa: E731
    return _embed_text(params, tokens, cfg, normalize=normalize, encoder=encoder)


# ---------------------------------------------------------------------------
# SigLIP sigmoid loss (the train step's; the reference never trains)
# ---------------------------------------------------------------------------


def _loss(params: Params, images, tokens, cfg: SigLIPConfig, attention, par=None):
    """The sigmoid loss over every image-text pair of the batch; with
    ``par``, of the global batch, whose embeddings ``par.gather_batch``
    brings from every data-parallel rank."""
    zi = _embed_image(params, images, cfg, attention, par)
    zt = _embed_text(params, tokens, cfg, attention, par)
    if par is not None:
        zi, zt = par.gather_batch(zi), par.gather_batch(zt)
    logits = (zi @ zt.T) * torch.exp(params["t"]) + params["b"]
    n = logits.shape[0]
    labels = 2.0 * torch.eye(n, dtype=torch.float32, device=logits.device) - 1.0
    # -log sigmoid(labels * logits), pairwise sigmoid contrastive loss
    return F.softplus(-labels * logits).mean()


def siglip_loss(
    params: Params, images: torch.Tensor, tokens: torch.Tensor, cfg: SigLIPConfig
) -> torch.Tensor:
    """``mean(softplus(-labels * (zi @ zt.T * exp(t) + b)))``, labels
    ``2 I - 1``, over the whole batch; a graph for autograd.

    ``images``: float (B, R, R, 3) in [-1, 1] (preprocessed); ``tokens``:
    (B, text_len) ids; ``params``: the source tree (not prepared). The
    route is the plain one whatever ``cfg.attn_impl`` says: the image
    tower's plain encoder and MAP head, and ``mha_xla`` for every
    attention, as the JAX package's loss runs off a TPU (no kernel has a
    backward).
    """
    return _loss(params, images, tokens, cfg, attention=mha_xla)


# The leaves whose loss gradient is zero in exact arithmetic, by path: the
# k biases, since a constant added to every key adds one q.b_k to every
# score of a row, which the softmax ignores. A computed gradient there is
# rounding noise, so a comparison holds them to an absolute bound.
ZERO_GRAD_LEAVES = frozenset({"img/blocks/attn/k/b", "txt/blocks/attn/k/b", "img/map_head/k/b"})


# ---------------------------------------------------------------------------
# Checkpoint loading (HF / big_vision name mapping)
# ---------------------------------------------------------------------------


def _hf_block(tensors: Dict[str, torch.Tensor], prefix: str, i: int, dt) -> Params:
    """Map one HF SiglipEncoderLayer onto the block layout."""

    def t(name):
        return tensors[f"{prefix}.layers.{i}.{name}"].to(dt)

    def lin(name):
        return {"w": t(f"{name}.weight").t(), "b": t(f"{name}.bias")}

    return {
        "ln1": {"g": t("layer_norm1.weight"), "b": t("layer_norm1.bias")},
        "attn": {
            "q": lin("self_attn.q_proj"),
            "k": lin("self_attn.k_proj"),
            "v": lin("self_attn.v_proj"),
            "o": lin("self_attn.out_proj"),
        },
        "ln2": {"g": t("layer_norm2.weight"), "b": t("layer_norm2.bias")},
        "mlp": {"fc1": lin("mlp.fc1"), "fc2": lin("mlp.fc2")},
    }


def _stack(trees) -> Params:
    """Per-layer trees -> one tree of (depth, ...) contiguous tensors."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def load_hf_siglip(path: str, cfg: SigLIPConfig = SO400M_14_384) -> Params:
    """Load google/siglip-so400m-patch14-384 safetensors into the tree.

    Accepts a file or a directory holding ``model.safetensors``. The same
    name mapping as the JAX package's loader; every leaf is a contiguous
    CPU tensor in ``cfg.param_dtype``, except the fp32 scalars ``t`` and
    ``b`` (``logit_scale`` and ``logit_bias`` where the file has them).
    """
    if os.path.isdir(path):
        path = os.path.join(path, "model.safetensors")
    tensors = read_safetensors(path)
    dt = cfg.param_dtype
    vp, tp = "vision_model.encoder", "text_model.encoder"

    def arr(name):
        return tensors[name].to(dt).contiguous()

    def proj(w, b):  # a torch Linear's (out, in) weight -> (in, out)
        return {"w": w.t().to(dt).contiguous(), "b": b.to(dt).contiguous()}

    def lin(name):
        return proj(tensors[name + ".weight"], tensors[name + ".bias"])

    img_blocks = _stack([_hf_block(tensors, vp, i, dt) for i in range(cfg.depth)])
    txt_blocks = _stack([_hf_block(tensors, tp, i, dt) for i in range(cfg.text_depth)])

    # HF patch conv weight: (width, 3, P, P) -> (P*P*3, width), matching
    # the (h, w, c) patch flattening order; SigLIP 2's Linear (width,
    # P*P*3) already flattens patches (row, col, channel)
    wconv = tensors["vision_model.embeddings.patch_embedding.weight"]
    if wconv.dim() == 2:
        wmat = wconv.t()
    else:
        wmat = wconv.permute(2, 3, 1, 0).reshape(-1, cfg.width)

    # HF MAP head: probe, in_proj (packed qkv), out_proj, layernorm, mlp
    hp = "vision_model.head"
    w_q, w_k, w_v = tensors[f"{hp}.attention.in_proj_weight"].chunk(3, dim=0)
    b_q, b_k, b_v = tensors[f"{hp}.attention.in_proj_bias"].chunk(3, dim=0)
    params = {
        "img": {
            "patch_embed": {
                "w": wmat.to(dt).contiguous(),
                "b": arr("vision_model.embeddings.patch_embedding.bias"),
            },
            "pos_emb": arr("vision_model.embeddings.position_embedding.weight"),
            "blocks": img_blocks,
            "ln_final": {
                "g": arr("vision_model.post_layernorm.weight"),
                "b": arr("vision_model.post_layernorm.bias"),
            },
            "map_head": {
                "probe": arr(f"{hp}.probe")[0],
                "q": proj(w_q, b_q),
                "k": proj(w_k, b_k),
                "v": proj(w_v, b_v),
                "o": lin(f"{hp}.attention.out_proj"),
                "ln": {"g": arr(f"{hp}.layernorm.weight"), "b": arr(f"{hp}.layernorm.bias")},
                "mlp": {"fc1": lin(f"{hp}.mlp.fc1"), "fc2": lin(f"{hp}.mlp.fc2")},
            },
        },
        "txt": {
            "token_emb": arr("text_model.embeddings.token_embedding.weight"),
            "pos_emb": arr("text_model.embeddings.position_embedding.weight"),
            "blocks": txt_blocks,
            "ln_final": {
                "g": arr("text_model.final_layer_norm.weight"),
                "b": arr("text_model.final_layer_norm.bias"),
            },
            "head": lin("text_model.head"),
        },
        "t": torch.tensor(float(np.log(10.0)), dtype=torch.float32),
        "b": torch.tensor(-10.0, dtype=torch.float32),
    }
    for key, name in (("t", "logit_scale"), ("b", "logit_bias")):
        if name in tensors:
            params[key] = tensors[name].to(torch.float32).reshape(())
    return params


def load_hf_siglip2(path: str, cfg: SigLIPConfig = SO400M_16_NAFLEX_1024) -> Params:
    """Load a SigLIP 2 NaFlex checkpoint (google/siglip2-so400m-patch16-naflex
    safetensors, a file or its directory) into the tree. HF's Siglip2
    names are SigLIP's but for the patch embedding, a Linear over
    (row, col, channel)-flattened patches, and the position table, the
    16 x 16 grid's 256 rows in row-major order; the text tower is SigLIP's
    with the Gemma vocabulary."""
    if not cfg.max_num_patches:
        raise ValueError("load_hf_siglip2 takes a NaFlex config (max_num_patches > 0)")
    params = load_hf_siglip(path, cfg)
    want = (cfg.patch_size ** 2 * 3, cfg.width)
    if tuple(params["img"]["patch_embed"]["w"].shape) != want:
        raise ValueError(f"patch embedding {tuple(params['img']['patch_embed']['w'].shape)}, "
                         f"expected a Linear of {want}")
    return params


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
