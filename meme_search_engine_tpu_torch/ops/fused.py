"""Fused LayerNorm / projection / MLP kernels for the SigLIP image tower.

Counterpart of ``meme_search_engine_tpu/ops/fused.py``. Each function has
a plain PyTorch version (``*_plain``) with the reference's cast points,
and a wrapper that takes the plain version for CPU tensors and launches
the hand-written CUDA kernel (``csrc/gemm.cu``) for CUDA tensors, raising
on anything the kernel does not take. ``launches`` counts kernel launches
per wrapper; the CPU path never touches it.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "ln_matmul",
    "matmul_residual",
    "ln_mlp_residual",
    "ln_matmul_plain",
    "matmul_residual_plain",
    "ln_mlp_residual_plain",
    "pad_hidden",
    "launches",
    "reset_launches",
]

# Kernel launches per wrapper (ln_mlp_residual counts one per call: its
# two GEMM launches form one fused sub-block).
launches = {"ln_matmul": 0, "matmul_residual": 0, "ln_mlp_residual": 0}

# Rows of the hidden dimension the kernels' tiles cover at once; the
# hidden width is zero-padded to it at load time (pad_hidden).
HIDDEN_TILE = 128


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------


def _ln_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm (eps 1e-6), rounded to bf16 as the kernels feed the MMA."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + 1e-6) * gamma.float() + beta.float()
    return y.to(torch.bfloat16)


# (n_valid, n_heads, c, d): n_valid one int for every sequence, or an int32
# tensor of each sequence's own valid length
KMask = Tuple[Union[int, torch.Tensor], int, int, int]


def _k_mask_plain(y: torch.Tensor, k_mask: KMask) -> torch.Tensor:
    n_valid, n_heads, c, d = k_mask
    hc = n_heads * c
    const = torch.zeros(hc, dtype=y.dtype, device=y.device)
    const[d::c] = -1e30
    if isinstance(n_valid, torch.Tensor):
        pad = torch.arange(y.shape[1], device=y.device)[None, :] >= n_valid.to(y.device)[:, None]
        y[..., hc : 2 * hc] = torch.where(pad[..., None], const, y[..., hc : 2 * hc])
    else:
        y[:, n_valid:, hc : 2 * hc] = const
    return y


def ln_matmul_plain(x, gamma, beta, w, bias, act=None, k_mask=None):
    y = _ln_plain(x, gamma, beta).float() @ w.float() + bias.float()
    if act == "gelu":
        y = F.gelu(y, approximate="tanh")
    if k_mask is not None:
        y = _k_mask_plain(y, k_mask)
    return y.to(x.dtype)


def matmul_residual_plain(x, w, bias, res):
    return (x.float() @ w.float() + bias.float() + res.float()).to(x.dtype)


def ln_mlp_residual_plain(x, gamma, beta, w1, b1, w2, b2, res=None):
    h = _ln_plain(x, gamma, beta).float() @ w1.float() + b1.float()
    h = F.gelu(h, approximate="tanh").to(x.dtype)
    res = x if res is None else res
    return (res.float() + h.float() @ w2.float() + b2.float()).to(x.dtype)


def pad_hidden(w1, b1, w2, multiple: int = HIDDEN_TILE):
    """Zero-pad the MLP hidden width to a multiple of ``multiple``.

    Exact: a pad unit's pre-activation is 0 and gelu(0) = 0, and its fc2
    row is 0 (the reference pads the same way, fused.py:294-297).
    """
    m = w1.shape[-1]
    pad = (-m) % multiple
    if pad == 0:
        return w1, b1, w2
    return (
        F.pad(w1, (0, pad)),
        F.pad(b1, (0, pad)),
        F.pad(w2, (0, 0, 0, pad)),
    )


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _refuse_grad(name: str, *ts: torch.Tensor) -> None:
    """Refuse inputs that require grad: no kernel here has a backward (nor
    has any Pallas kernel of the JAX package), and a launch through ctypes
    would hand back a tensor cut from the graph. Checked before the device
    dispatch, so the CPU's plain versions refuse them too."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name} has no backward: an input requires grad; differentiate the "
            "plain route (siglip.siglip_loss, ops.attention.mha_xla) instead"
        )


def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"}:
        raise ValueError(f"tensors must all be on the CPU or all on CUDA, got {devs}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("tensors lie on different CUDA devices")
    return False


def _check(name: str, t: torch.Tensor, shape: Tuple[Optional[int], ...]) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: kernel takes bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous tensors")
    if t.dim() != len(shape) or any(
        s is not None and s != ts for s, ts in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: kernel takes 16-byte aligned tensors")


def _check_gemm(x, w):
    if x.dim() != 3:
        raise ValueError(f"x: expected (B, SP, K), got {tuple(x.shape)}")
    b, sp, k = x.shape
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"w: expected ({k}, N), got {tuple(w.shape)}")
    n = w.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"kernel needs K % 8 == 0 and N % 8 == 0, got K={k} N={n}")
    return b, sp, k, n


def _ln_matmul_launch(x, gamma, beta, w, bias, act, k_mask, out):
    b, sp, k, n = _check_gemm(x, w)
    n_valid, hc, c, d, lens = 0, 0, 0, 0, None
    if k_mask is not None:
        n_valid, n_heads, c, d = k_mask
        hc = n_heads * c
        if 2 * hc > n or not 0 <= d < c:
            raise ValueError(f"k_mask {k_mask} does not fit N={n}")
        if isinstance(n_valid, torch.Tensor):
            lens = n_valid
            if lens.dtype != torch.int32 or lens.shape != (b,) or lens.device != x.device:
                raise ValueError(f"k_mask lengths: int32 ({b},) on {x.device}, got "
                                 f"{lens.dtype} {tuple(lens.shape)} on {lens.device}")
            lens, n_valid = lens.contiguous(), 0
    stats = torch.empty((b * sp, 2), dtype=torch.float32, device=x.device)
    err = _build.library("gemm").mse_ln_matmul(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
        bias.data_ptr(), out.data_ptr(), stats.data_ptr(),
        b * sp, n, k, 1 if act == "gelu" else 0,
        n_valid, sp, hc, c, d, None if lens is None else lens.data_ptr(),
        _build.stream_ptr(x.device),
    )
    _build.check(err, "ln_matmul")


def _matmul_residual_launch(x, w, bias, res, out):
    b, sp, k, n = _check_gemm(x, w)
    err = _build.library("gemm").mse_matmul_residual(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), res.data_ptr(),
        out.data_ptr(), b * sp, n, k, _build.stream_ptr(x.device),
    )
    _build.check(err, "matmul_residual")


def ln_matmul(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    act: Optional[str] = None,
    k_mask: Optional[KMask] = None,
) -> torch.Tensor:
    """act(LayerNorm(x) @ w + bias): (B, SP, K) x (K, N) -> (B, SP, N) bf16.

    LN statistics in fp32 (eps 1e-6), LN output rounded to bf16, fp32
    accumulation. ``act``: None or "gelu" (tanh). ``k_mask=(n_valid,
    n_heads, c, d)``: packed fat-QKV mode, rows >= n_valid of the K
    section (columns [H*C, 2*H*C)) become 0 with -1e30 in each head's
    constant column. ``n_valid`` is one int for every sequence, or an
    int32 (B,) tensor on x's device, each sequence's own. Every row is
    written, pad rows included.
    """
    if act not in (None, "gelu"):
        raise ValueError(f"act must be None or 'gelu', got {act!r}")
    _refuse_grad("ln_matmul", x, gamma, beta, w, bias)
    if _on_cpu(x, gamma, beta, w, bias):
        return ln_matmul_plain(x, gamma, beta, w, bias, act, k_mask)
    b, sp, k, n = _check_gemm(x, w)
    _check("x", x, (b, sp, k))
    _check("gamma", gamma, (k,))
    _check("beta", beta, (k,))
    _check("w", w, (k, n))
    _check("bias", bias, (n,))
    out = torch.empty((b, sp, n), dtype=x.dtype, device=x.device)
    _ln_matmul_launch(x, gamma, beta, w, bias, act, k_mask, out)
    launches["ln_matmul"] += 1
    return out


def matmul_residual(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, res: torch.Tensor
) -> torch.Tensor:
    """res + x @ w + bias with fp32 accumulation: (B, SP, K) -> (B, SP, N) bf16."""
    _refuse_grad("matmul_residual", x, w, bias, res)
    if _on_cpu(x, w, bias, res):
        return matmul_residual_plain(x, w, bias, res)
    b, sp, k, n = _check_gemm(x, w)
    _check("x", x, (b, sp, k))
    _check("w", w, (k, n))
    _check("bias", bias, (n,))
    _check("res", res, (b, sp, n))
    out = torch.empty((b, sp, n), dtype=x.dtype, device=x.device)
    _matmul_residual_launch(x, w, bias, res, out)
    launches["matmul_residual"] += 1
    return out


def ln_mlp_residual(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    res: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """res + gelu_tanh(LayerNorm(x) @ w1 + b1) @ w2 + b2, res = x by default.

    On the card this is two launches of the GEMM kernel: LN + fc1 + gelu
    into a bf16 (rows, M) scratch (the reference rounds the gelu output
    to bf16 before fc2 too, fused.py:206), then fc2 + b2 with the
    residual. The scratch's round trip through device memory is what this
    version pays over the reference's on-chip intermediate. The hidden
    width M must be a multiple of 128 (``pad_hidden`` at load time).
    ``res`` apart from x adds the MLP onto another residual stream.
    """
    res = x if res is None else res
    _refuse_grad("ln_mlp_residual", x, gamma, beta, w1, b1, w2, b2, res)
    if _on_cpu(x, gamma, beta, w1, b1, w2, b2, res):
        return ln_mlp_residual_plain(x, gamma, beta, w1, b1, w2, b2, res)
    if x.dim() != 3 or w1.dim() != 2:
        raise ValueError("x: (B, SP, D), w1: (D, M)")
    b, sp, d = x.shape
    m = w1.shape[1]
    if m % HIDDEN_TILE:
        raise ValueError(
            f"hidden width {m} is not a multiple of {HIDDEN_TILE}; pad_hidden at load"
        )
    _check("x", x, (b, sp, d))
    _check("gamma", gamma, (d,))
    _check("beta", beta, (d,))
    _check("w1", w1, (d, m))
    _check("b1", b1, (m,))
    _check("w2", w2, (m, d))
    _check("b2", b2, (d,))
    _check("res", res, (b, sp, d))
    h = torch.empty((b, sp, m), dtype=x.dtype, device=x.device)
    _ln_matmul_launch(x, gamma, beta, w1, b1, "gelu", None, h)
    out = torch.empty_like(x)
    _matmul_residual_launch(h, w2, b2, res, out)
    launches["ln_mlp_residual"] += 1
    return out
