"""Multi-head attention for the SigLIP towers.

Counterpart of ``meme_search_engine_tpu/ops/attention.py``, in two parts.

**Plain-layout attention** on (B, S, H, Dh) q/k/v, as the text tower and
the image tower's ``attn_impl="xla"`` route call it through :func:`mha`.
The dispatch is the JAX package's: non-causal self-attention with
``1 < Sq == Sk <= 2048`` goes to the fused kernel (``fused_mha_pallas``
on the TPU, ``csrc/mha.cu`` here, :func:`fused_mha`); anything else
(the MAP head's single probe query, causal attention) goes to
:func:`mha_xla`, the reference's own route for those shapes. The fused
kernel's plain version (:func:`fused_mha_plain`) runs for CPU tensors.
:func:`flash_mha`, the JAX package's blocked attention, is plain torch
there too (a ``lax.scan``, no Pallas kernel) and no served path calls it.

**Fat-layout attention** for the image tower (and the text tower's fat route). q/k/v arrive in the "fat"
head-major layout (B, SP, H*C), C = ``fat_width(head_dim)``: per head the
head_dim features, then one constant column, then zero padding.

- q is pre-scaled by 1/sqrt(head_dim) (folded into its projection) and
  its constant column is 1;
- k's constant column is 0 on valid rows and -1e30 on pad rows, so Q.K^T
  gives masked scores with no separate mask;
- v's constant column is 1, so column head_dim of P.V is the softmax sum.

:func:`fat_layout_ok` is the JAX package's test of whether a geometry takes
this layout, so both packages route the same inputs alike.

The plain versions compute exactly that with full score matrices in
fp32; the wrappers launch ``csrc/fat_attention.cu`` on CUDA tensors, a
streaming (online-softmax) kernel, and take the plain version only for
CPU tensors. :func:`fat_vit_mha_packed_proj` adds the o-projection and
the residual (``csrc/fat_attention_proj.cu``: the same attention code,
through ``csrc/fat_attention.cuh``, in a thread-block cluster over heads
whose CTAs then share their heads' outputs for the projection); like the
JAX op, no model path calls it: the image tower runs
:func:`fat_vit_mha_packed` then ``fused.matmul_residual``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .fused import _check, _refuse_grad, _on_cpu

__all__ = [
    "mha",
    "mha_xla",
    "flash_mha",
    "fused_mha",
    "fused_mha_plain",
    "fat_width",
    "fat_layout_ok",
    "kernel_width",
    "fat_pad",
    "fat_vit_mha",
    "fat_vit_mha_packed",
    "fat_vit_mha_plain",
    "fat_vit_mha_packed_plain",
    "fat_vit_mha_packed_proj",
    "fat_vit_mha_packed_proj_plain",
    "fat_vit_mha_packed_proj_occupancy",
    "launches",
    "reset_launches",
]

# Kernel launches: "fused_mha" counts one per call of the fused kernel's
# wrapper; "fat_vit_mha" counts the fat kernel through either wrapper;
# "fat_vit_mha_packed_proj" the fused attention + o-projection kernel.
launches = {"fused_mha": 0, "fat_vit_mha": 0, "fat_vit_mha_packed_proj": 0}

# The fat kernels are compiled for these fat widths padded to 16: 80 for
# SO400M (head_dim 72), 32 for the tiny test config (head_dim 16) and 16
# for the tiny fat test config (head_dim 7).
KERNEL_FAT_WIDTHS = (16, 32, 80)

# The fused kernel is compiled for these head widths padded to 16: 80 for
# SO400M (72) and 16 for the tiny test configs (16, and 7 padded to 8).
# The longest sequence mha() sends it is the JAX dispatch's.
KERNEL_MHA_WIDTHS = (16, 80)
MHA_MAX_SEQ = 2048
_STABLE_MODES = {"row": 0, "scalar": 1, "none": 2}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Plain-layout attention (B, S, H, Dh)
# ---------------------------------------------------------------------------


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False) -> torch.Tensor:
    """Scaled dot-product attention with the JAX package's dispatch.

    q, k, v: (B, S, H, Dh). Returns (B, Sq, H, Dh) in q.dtype. Non-causal
    self-attention with ``1 < Sq == Sk <= 2048`` runs the fused kernel
    (its plain version for CPU tensors); everything else runs
    :func:`mha_xla`.
    """
    sq, sk = q.shape[1], k.shape[1]
    if not causal and sq == sk and 1 < sq <= MHA_MAX_SEQ:
        return fused_mha(q, k, v)
    return mha_xla(q, k, v, causal=causal)


def mha_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False) -> torch.Tensor:
    """The reference's XLA attention: fp32 scores and softmax, probs cast
    to v's dtype before P.V with fp32 accumulation."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / dh**0.5)
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, block_q: int = 256, block_k: int = 256
) -> torch.Tensor:
    """Blocked (flash) attention: a loop over key blocks with an online
    softmax, fp32 throughout, as the JAX ``flash_mha`` (a ``lax.scan``
    there, plain XLA with no Pallas kernel). Same signature and semantics
    as :func:`mha` (non-causal); the last key block is zero-padded and its
    pad keys masked. ``block_q`` is kept for the JAX signature: as there,
    the queries are not blocked. No served path calls it, in either
    package."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    qf = q.transpose(1, 2).float() * (1.0 / dh**0.5)  # (B, H, Sq, Dh)
    kf, vf = (t.transpose(1, 2).float() for t in (k, v))
    pad = (-sk) % block_k
    if pad:
        kf, vf = (F.pad(t, (0, 0, 0, pad)) for t in (kf, vf))
    valid = torch.arange(sk + pad, device=q.device) < sk
    m = torch.full((b, h, sq), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    for start in range(0, sk + pad, block_k):
        kb, vb = kf[:, :, start : start + block_k], vf[:, :, start : start + block_k]
        s = (qf @ kb.transpose(-1, -2)).masked_fill(
            ~valid[start : start + block_k], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vb
        m = m_new
    return (acc / l[..., None]).transpose(1, 2).to(q.dtype)


def fused_mha_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, stable: str = "scalar"
) -> torch.Tensor:
    """``_fused_attention_kernel``'s function, per (batch, head): fp32
    scores times 1/sqrt(Dh); p = exp(s - M) with M one max over the head's
    whole S x S block ("scalar"), the row max ("row") or 0 ("none"); l
    summed from fp32 p; P cast to v's dtype before P.V; out = o * (1/l)."""
    if stable not in _STABLE_MODES:
        raise ValueError(f"stable must be one of {tuple(_STABLE_MODES)}, got {stable!r}")
    dh = q.shape[-1]
    qh, kh, vh = (t.permute(0, 2, 1, 3).float() for t in (q, k, v))  # (B, H, S, Dh)
    s = (qh @ kh.transpose(-1, -2)) * (1.0 / dh**0.5)
    if stable == "row":
        s = s - s.amax(dim=-1, keepdim=True)
    elif stable == "scalar":
        s = s - s.amax(dim=(-2, -1), keepdim=True)
    p = torch.exp(s)
    l = p.sum(dim=-1, keepdim=True)
    o = p.to(v.dtype).float() @ vh
    out = o * (1.0 / l)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _check_mha_operand(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: kernel takes bfloat16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(
            f"{name}: kernel takes views with unit stride on Dh and strides that are "
            f"multiples of 8 elements elsewhere, got strides {t.stride()}"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: kernel takes 16-byte aligned tensors")


def fused_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, stable: str = "scalar"
) -> torch.Tensor:
    """Fused non-causal self-attention (B, S, H, Dh) -> (B, S, H, Dh).

    CPU tensors take :func:`fused_mha_plain`. CUDA tensors launch
    ``csrc/mha.cu``, reading q/k/v in place through their strides; Dh is
    zero-padded to a multiple of 8 first, as the JAX wrapper pads it.
    """
    if stable not in _STABLE_MODES:
        raise ValueError(f"stable must be one of {tuple(_STABLE_MODES)}, got {stable!r}")
    _refuse_grad("fused_mha", q, k, v)
    if _on_cpu(q, k, v):
        return fused_mha_plain(q, k, v, stable)
    if q.dim() != 4:
        raise ValueError(f"q: expected (B, S, H, Dh), got {tuple(q.shape)}")
    b, s, h, d = q.shape
    dp = -(-d // 8) * 8
    if -(-dp // 16) * 16 not in KERNEL_MHA_WIDTHS:
        raise ValueError(
            f"head width {d} is not one the kernel is compiled for: "
            f"{KERNEL_MHA_WIDTHS} after padding to 16"
        )
    if dp != d:
        q, k, v = (F.pad(t, (0, dp - d)) for t in (q, k, v))
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_mha_operand(name, t, (b, s, h, dp))
    out = torch.empty((b, s, h, dp), dtype=torch.bfloat16, device=q.device)
    mode = _STABLE_MODES[stable]
    # with more than one 64-row query block per head, the scalar mode's
    # max over the head comes from a pre-pass through this scratch
    gmax = None
    if stable == "scalar" and s > 64:
        gmax = torch.full((b * h,), float("-inf"), dtype=torch.float32, device=q.device)
    scale = 1.0 / d**0.5
    err = _build.library("mha").mse_mha(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if gmax is None else gmax.data_ptr(),
        b, s, h, dp, mode, scale,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        _build.stream_ptr(q.device),
    )
    _build.check(err, "fused_mha")
    launches["fused_mha"] += 1
    return out if dp == d else out[..., :d]


# ---------------------------------------------------------------------------
# Fat-layout attention (B, SP, H*C)
# ---------------------------------------------------------------------------


def fat_width(head_dim: int) -> int:
    """Per-head fat width: head_dim + const column, padded to 8."""
    return ((head_dim + 1 + 7) // 8) * 8


def fat_layout_ok(n_heads: int, head_dim: int, sp: int) -> bool:
    """Whether (n_heads, head_dim, padded sequence) takes the fat layout:
    the JAX package's predicate as it is (its Pallas block widths are
    multiples of 128 lanes, its row blocks of 16), so both packages route
    the same inputs the same way. The kernel's own width check
    (``_check_width``) is separate and still raises."""
    return (n_heads * fat_width(head_dim)) % 128 == 0 and sp % 16 == 0


def fat_vit_mha_plain(qf, kf, vf, n_heads: int, head_dim: int) -> torch.Tensor:
    """(B, SP, H*C) x3 -> (B, SP, H*head_dim), reference cast points:
    fp32 scores, P = exp(s - rowmax) rounded to bf16, fp32 P.V, l from
    v's ones column (attention.py:_fat_vit_kernel)."""
    b, sp, hc = qf.shape
    c = fat_width(head_dim)

    def heads(t):
        return t.reshape(b, sp, n_heads, c).permute(0, 2, 1, 3).float()

    q, k, v = heads(qf), heads(kf), heads(vf)
    s = q @ k.transpose(-1, -2)  # (B, H, SP, SP)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(torch.bfloat16).float()
    o = p @ v  # (B, H, SP, C)
    o = o[..., :head_dim] / o[..., head_dim : head_dim + 1]
    return o.permute(0, 2, 1, 3).reshape(b, sp, n_heads * head_dim).to(qf.dtype)


def fat_vit_mha_packed_plain(qkvf, n_heads: int, head_dim: int) -> torch.Tensor:
    hc = n_heads * fat_width(head_dim)
    return fat_vit_mha_plain(
        qkvf[..., :hc], qkvf[..., hc : 2 * hc], qkvf[..., 2 * hc :],
        n_heads, head_dim,
    )


def kernel_width(head_dim: int) -> int:
    """The per-head width the fat kernel reads: ``fat_width`` padded to
    16, the bf16 MMA's k-step (80 at SO400M, where nothing is padded)."""
    return (fat_width(head_dim) + 15) // 16 * 16


def fat_pad(x: torch.Tensor, n_heads: int, width: int, padded: int) -> torch.Tensor:
    """(B, SP, n_heads*width) -> (B, SP, n_heads*padded): each head's
    ``width`` columns, then zeros. The kernel reads 16-column boxes at
    h*C, which at the tiny fat widths (8, 24) would reach into the next
    head; it reads this copy instead. Zero columns add nothing to Q.K^T
    or P.V."""
    b, sp, _ = x.shape
    x = F.pad(x.reshape(b, sp, n_heads, width), (0, padded - width))
    return x.reshape(b, sp, n_heads * padded)


def _launch(q, k, v, row_stride, batch_stride, b, sp, n_heads, head_dim, device):
    out = torch.empty((b, sp, n_heads * head_dim), dtype=torch.bfloat16, device=device)
    err = _build.library("fat_attention").mse_fat_attention(
        q, k, v, out.data_ptr(), b, sp, n_heads, kernel_width(head_dim), head_dim,
        row_stride[0], row_stride[1], row_stride[2],
        batch_stride[0], batch_stride[1], batch_stride[2],
        _build.stream_ptr(device),
    )
    _build.check(err, "fat_vit_mha")
    launches["fat_vit_mha"] += 1
    return out


def _check_width(head_dim: int) -> None:
    if kernel_width(head_dim) not in KERNEL_FAT_WIDTHS:
        raise ValueError(
            f"fat width {fat_width(head_dim)} (head_dim {head_dim}) is not one the "
            f"kernel is compiled for: {KERNEL_FAT_WIDTHS} after padding to 16"
        )


def fat_vit_mha(
    qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor, n_heads: int, head_dim: int
) -> torch.Tensor:
    """Fat-layout attention: (B, SP, H*C) q/k/v -> (B, SP, H*head_dim) bf16."""
    _refuse_grad("fat_vit_mha", qf, kf, vf)
    if _on_cpu(qf, kf, vf):
        return fat_vit_mha_plain(qf, kf, vf, n_heads, head_dim)
    b, sp, hc = qf.shape
    c, cp = fat_width(head_dim), kernel_width(head_dim)
    if hc != n_heads * c:
        raise ValueError(f"width {hc} != n_heads * fat_width({head_dim})")
    _check_width(head_dim)
    for name, t in (("qf", qf), ("kf", kf), ("vf", vf)):
        _check(name, t, (b, sp, hc))
    if cp != c:
        qf, kf, vf = (fat_pad(t, n_heads, c, cp) for t in (qf, kf, vf))
    hcp = n_heads * cp
    return _launch(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
        (hcp,) * 3, (sp * hcp,) * 3, b, sp, n_heads, head_dim, qf.device,
    )


def fat_vit_mha_packed(qkvf: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """:func:`fat_vit_mha` over one packed (B, SP, 3*H*C) [qf | kf | vf]
    array, read in place through strides (no split copies; at the tiny
    fat widths the kernel reads a :func:`fat_pad` copy)."""
    _refuse_grad("fat_vit_mha_packed", qkvf)
    if _on_cpu(qkvf):
        return fat_vit_mha_packed_plain(qkvf, n_heads, head_dim)
    b, sp, hc3 = qkvf.shape
    c, cp = fat_width(head_dim), kernel_width(head_dim)
    if hc3 != 3 * n_heads * c:
        raise ValueError(f"width {hc3} != 3 * n_heads * fat_width({head_dim})")
    _check_width(head_dim)
    _check("qkvf", qkvf, (b, sp, hc3))
    if cp != c:
        qkvf = fat_pad(qkvf, 3 * n_heads, c, cp)
    hcp = n_heads * cp
    base, el = qkvf.data_ptr(), qkvf.element_size()
    return _launch(
        base, base + hcp * el, base + 2 * hcp * el,
        (3 * hcp,) * 3, (sp * 3 * hcp,) * 3, b, sp, n_heads, head_dim, qkvf.device,
    )


# The fused kernel runs thread-block clusters of H / 2 CTAs, two heads a
# CTA, each cluster walking (image, 128-row query block) tiles; a cluster
# holds at most 8 CTAs (the portable size). CTA j of a cluster computes output columns
# [NC j, NC j + NC), NC = DM / (H / 2) rounded up to 16. For each fat width
# padded to 16 the kernel is compiled for one head width in its attention
# slice, DP (head_dim rounded up to 8), and one NC: SO400M, tiny_test_config
# and tiny_fat_test_config.
PROJ_MAX_CLUSTER = 8
PROJ_GEOMETRIES = {80: (72, 144), 32: (16, 32), 16: (8, 16)}  # CP -> (DP, NC)


def _proj_geometry(n_heads: int, head_dim: int, dm: int) -> tuple:
    """(cluster size, DP) for the fused kernel, or ValueError."""
    _check_width(head_dim)
    cluster = n_heads // 2
    if n_heads % 2 or not 1 <= cluster <= PROJ_MAX_CLUSTER:
        raise ValueError(
            f"kernel takes an even head count up to {2 * PROJ_MAX_CLUSTER} (two heads a "
            f"CTA of a cluster of at most {PROJ_MAX_CLUSTER}), got {n_heads}"
        )
    dp, nc = PROJ_GEOMETRIES[kernel_width(head_dim)]
    if -(-head_dim // 8) * 8 != dp:
        raise ValueError(f"head_dim {head_dim}: the kernel is compiled for {dp} at this fat width")
    per_cta = -(-dm // cluster)
    got = -(-per_cta // 16) * 16
    if got != nc:
        raise ValueError(
            f"DM {dm} over {cluster} CTAs is {got} output columns a CTA; the kernel is "
            f"compiled for {nc} at head_dim {head_dim}"
        )
    return cluster, dp


def fat_vit_mha_packed_proj_plain(qkvf, wo, bo, res, n_heads: int, head_dim: int) -> torch.Tensor:
    """``_fat_vit_proj_kernel``'s cast points: the attention rounded to
    qkvf's dtype (the kernel's scratch), then ``attn @ wo`` in fp32 plus
    bo and res in fp32, one rounding to res.dtype."""
    attn = fat_vit_mha_packed_plain(qkvf, n_heads, head_dim)
    return (attn.float() @ wo.float() + bo.float() + res.float()).to(res.dtype)


def fat_vit_mha_packed_proj(
    qkvf: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    res: torch.Tensor,
    n_heads: int,
    head_dim: int,
) -> torch.Tensor:
    """res + fat_attention(qkvf) @ wo + bo, fused.

    qkvf: packed (B, SP, 3*H*C); wo: (H*head_dim, DM); bo: (DM,); res:
    (B, SP, DM). Returns (B, SP, DM) in res.dtype. CPU tensors take
    :func:`fat_vit_mha_packed_proj_plain`; CUDA tensors launch
    ``csrc/fat_attention_proj.cu`` (bf16, contiguous) or raise. At the
    tiny widths the kernel reads a :func:`fat_pad` copy of qkvf and, where
    head_dim is not a multiple of 8, of wo's rows (zero rows to DP a head).
    """
    _refuse_grad("fat_vit_mha_packed_proj", qkvf, wo, bo, res)
    if _on_cpu(qkvf, wo, bo, res):
        return fat_vit_mha_packed_proj_plain(qkvf, wo, bo, res, n_heads, head_dim)
    if qkvf.dim() != 3 or wo.dim() != 2:
        raise ValueError(f"qkvf: expected (B, SP, 3*H*C), wo: (H*D, DM), got "
                         f"{tuple(qkvf.shape)} and {tuple(wo.shape)}")
    b, sp, hc3 = qkvf.shape
    c, cp = fat_width(head_dim), kernel_width(head_dim)
    hd, dm = n_heads * head_dim, wo.shape[1]
    if hc3 != 3 * n_heads * c:
        raise ValueError(f"width {hc3} != 3 * n_heads * fat_width({head_dim})")
    if dm % 8:
        raise ValueError(f"kernel needs DM a multiple of 8, got {dm}")
    _, dp = _proj_geometry(n_heads, head_dim, dm)
    _check("qkvf", qkvf, (b, sp, hc3))
    _check("wo", wo, (hd, dm))
    _check("bo", bo, (dm,))
    _check("res", res, (b, sp, dm))
    if cp != c:
        qkvf = fat_pad(qkvf, 3 * n_heads, c, cp)
    if dp != head_dim:  # each head's rows of Wo, then zero rows up to DP
        wo = F.pad(wo.reshape(n_heads, head_dim, dm), (0, 0, 0, dp - head_dim))
        wo = wo.reshape(n_heads * dp, dm)
    out = torch.empty((b, sp, dm), dtype=torch.bfloat16, device=qkvf.device)
    err = _build.library("fat_attention_proj").mse_fat_attention_proj(
        qkvf.data_ptr(), wo.data_ptr(), bo.data_ptr(), res.data_ptr(), out.data_ptr(),
        b, sp, n_heads, cp, head_dim, dm, _build.stream_ptr(qkvf.device),
    )
    _build.check(err, "fat_vit_mha_packed_proj")
    launches["fat_vit_mha_packed_proj"] += 1
    return out


def fat_vit_mha_packed_proj_occupancy(n_heads: int, head_dim: int, dm: int) -> tuple:
    """(cluster size, clusters the card holds at once) of the fused
    kernel's launch for a geometry (``cudaOccupancyMaxActiveClusters``)."""
    _proj_geometry(n_heads, head_dim, dm)
    cluster, clusters = ctypes.c_int(0), ctypes.c_int(0)
    err = _build.library("fat_attention_proj").mse_fat_attention_proj_occupancy(
        n_heads, kernel_width(head_dim), head_dim, dm,
        ctypes.addressof(cluster), ctypes.addressof(clusters),
    )
    _build.check(err, "fat_vit_mha_packed_proj_occupancy")
    return cluster.value, clusters.value
