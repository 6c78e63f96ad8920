"""Fat-layout ViT attention for the SigLIP image tower.

Counterpart of the fat-layout part of
``meme_search_engine_tpu/ops/attention.py``. q/k/v arrive in the "fat"
head-major layout (B, SP, H*C), C = ``fat_width(head_dim)``: per head the
head_dim features, then one constant column, then zero padding.

- q is pre-scaled by 1/sqrt(head_dim) (folded into its projection) and
  its constant column is 1;
- k's constant column is 0 on valid rows and -1e30 on pad rows, so Q.K^T
  gives masked scores with no separate mask;
- v's constant column is 1, so column head_dim of P.V is the softmax sum.

The plain versions compute exactly that with full score matrices in
fp32; the wrappers launch ``csrc/fat_attention.cu`` on CUDA tensors, a
streaming (online-softmax) kernel, and take the plain version only for
CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build
from .fused import _check, _on_cpu

__all__ = [
    "fat_width",
    "fat_vit_mha",
    "fat_vit_mha_packed",
    "fat_vit_mha_plain",
    "fat_vit_mha_packed_plain",
    "launches",
    "reset_launches",
]

# Launches of the fat attention kernel, through either wrapper.
launches = {"fat_vit_mha": 0}

# The kernel is compiled for these fat widths padded to 16: 80 for SO400M
# (head_dim 72) and 16 for the tiny test geometry (head_dim 7).
KERNEL_FAT_WIDTHS = (16, 80)


def reset_launches() -> None:
    launches["fat_vit_mha"] = 0


def fat_width(head_dim: int) -> int:
    """Per-head fat width: head_dim + const column, padded to 8."""
    return ((head_dim + 1 + 7) // 8) * 8


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


def _launch(q, k, v, row_stride, batch_stride, b, sp, n_heads, head_dim, device):
    c = fat_width(head_dim)
    if (c + 15) // 16 * 16 not in KERNEL_FAT_WIDTHS:
        raise ValueError(
            f"fat width {c} (head_dim {head_dim}) is not one the kernel is "
            f"compiled for: {KERNEL_FAT_WIDTHS} after padding to 16"
        )
    out = torch.empty((b, sp, n_heads * head_dim), dtype=torch.bfloat16, device=device)
    err = _build.library("fat_attention").mse_fat_attention(
        q, k, v, out.data_ptr(), b, sp, n_heads, c, head_dim,
        row_stride[0], row_stride[1], row_stride[2],
        batch_stride[0], batch_stride[1], batch_stride[2],
        _build.stream_ptr(device),
    )
    _build.check(err, "fat_vit_mha")
    launches["fat_vit_mha"] += 1
    return out


def fat_vit_mha(
    qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor, n_heads: int, head_dim: int
) -> torch.Tensor:
    """Fat-layout attention: (B, SP, H*C) q/k/v -> (B, SP, H*head_dim) bf16."""
    if _on_cpu(qf, kf, vf):
        return fat_vit_mha_plain(qf, kf, vf, n_heads, head_dim)
    b, sp, hc = qf.shape
    if hc != n_heads * fat_width(head_dim):
        raise ValueError(f"width {hc} != n_heads * fat_width({head_dim})")
    for name, t in (("qf", qf), ("kf", kf), ("vf", vf)):
        _check(name, t, (b, sp, hc))
    return _launch(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
        (hc, hc, hc), (sp * hc,) * 3, b, sp, n_heads, head_dim, qf.device,
    )


def fat_vit_mha_packed(qkvf: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """:func:`fat_vit_mha` over one packed (B, SP, 3*H*C) [qf | kf | vf]
    array, read in place through strides (no split copies)."""
    if _on_cpu(qkvf):
        return fat_vit_mha_packed_plain(qkvf, n_heads, head_dim)
    b, sp, hc3 = qkvf.shape
    hc = n_heads * fat_width(head_dim)
    if hc3 != 3 * hc:
        raise ValueError(f"width {hc3} != 3 * n_heads * fat_width({head_dim})")
    _check("qkvf", qkvf, (b, sp, 3 * hc))
    base, el = qkvf.data_ptr(), qkvf.element_size()
    return _launch(
        base, base + hc * el, base + 2 * hc * el,
        (3 * hc,) * 3, (sp * 3 * hc,) * 3, b, sp, n_heads, head_dim, qkvf.device,
    )
