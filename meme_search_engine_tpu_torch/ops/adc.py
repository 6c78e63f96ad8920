"""Asymmetric distance computation (ADC) over PQ codes.

Counterpart of ``meme_search_engine_tpu/ops/adc.py``. The reference's hot
loop sums per-chunk LUT entries with fp32 accumulation
(diskann/src/vector.rs:387-405; the comment at :401-403 says why fp32 is
kept). :func:`adc_scores`, :func:`adc_scores_batched` and
:func:`adc_scores_pallas` all compute

    scores[b, n] = sum over m of luts[b, m, codes[n, m]]

with a code >= C scoring 0 (the TPU kernel zero-pads the LUT to 256
entries, and the one-hot route gives an all-zero row). CUDA tensors launch
``csrc/adc.cu`` (for M a multiple of 32 up to 128, a kernel whose lookups
are free of bank conflicts, up to three queries a CTA; for other M the
one-query kernel); CPU tensors take the plain version,
:func:`adc_scores_plain`, a gather and an fp32 sum over m (not the
reference's one-hot product, whose (N, M*C) fp32 operand is 65 GB at
N = 1e6). ``launches`` counts kernel launches; the CPU path never touches it.

:func:`descriptor_scores` is XLA in the reference and plain torch here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .fused import _on_cpu

__all__ = [
    "adc_scores",
    "adc_scores_batched",
    "adc_scores_pallas",
    "adc_scores_plain",
    "descriptor_scores",
    "launches",
    "reset_launches",
]

launches = {"adc_scores": 0}

LUT_WIDTH = 256
# The kernels hold at least one query's (M, 256) fp32 LUT in shared
# memory: 227 KB a CTA on Hopper allows M <= 227.
MAX_CHUNKS = 227
# Rows a CTA of the one-query kernel takes; its one-dimensional grid holds
# at most 2^31 - 1 CTAs of (query, row tile), a bound the wrapper applies to
# both kernels.
TILE_ROWS = 4096
MAX_CTAS = 2**31 - 1


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def adc_scores_plain(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """(N, M) u8 x (B, M, C) -> (B, N) fp32: one gather of
    ``luts[b, m, codes[n, m]]`` per query, summed over m in fp32."""
    n, m = codes.shape
    b, _, c = luts.shape
    lut = luts.float()
    if c < LUT_WIDTH:  # a code >= C scores 0
        lut = F.pad(lut, (0, LUT_WIDTH - c))
    width = lut.shape[-1]
    flat = codes.long() + torch.arange(m, device=codes.device) * width
    lut = lut.reshape(b, m * width)
    out = torch.empty((b, n), dtype=torch.float32, device=codes.device)
    for i in range(b):
        out[i] = lut[i][flat].sum(dim=1)
    return out


def _launch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    if codes.dtype != torch.uint8 or codes.dim() != 2 or not codes.is_contiguous():
        raise TypeError(
            f"codes: kernel takes contiguous (N, M) uint8, got {codes.dtype} "
            f"{tuple(codes.shape)} contiguous={codes.is_contiguous()}"
        )
    if luts.dtype != torch.float32 or luts.dim() != 3 or not luts.is_contiguous():
        raise TypeError(
            f"luts: kernel takes contiguous (B, M, C) float32, got {luts.dtype} "
            f"{tuple(luts.shape)} contiguous={luts.is_contiguous()}"
        )
    n, m = codes.shape
    b, m2, c = luts.shape
    if m != m2:
        raise ValueError(f"codes have {m} chunks, luts {m2}")
    if c > LUT_WIDTH:
        raise ValueError(f"luts have {c} entries per chunk; the kernel takes at most {LUT_WIDTH}")
    if not 1 <= m <= MAX_CHUNKS:
        raise ValueError(f"{m} chunks: the kernel's LUT in shared memory holds 1 to {MAX_CHUNKS}")
    if b * -(-n // TILE_ROWS) > MAX_CTAS:
        raise ValueError(f"{b} queries x {n} rows need more than {MAX_CTAS} CTAs of {TILE_ROWS} rows")
    out = torch.empty((b, n), dtype=torch.float32, device=codes.device)
    if n == 0 or b == 0:  # an empty grid is not a launch CUDA takes
        return out
    err = _build.library("adc").mse_adc(
        codes.data_ptr(), luts.data_ptr(), out.data_ptr(), n, m, c, b,
        _build.stream_ptr(codes.device),
    )
    _build.check(err, "adc_scores")
    launches["adc_scores"] += 1
    return out


def adc_scores_batched(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Batched ADC: (N, M) u8 codes x (B, M, C) f32 LUTs -> (B, N) f32."""
    if _on_cpu(codes, luts):
        return adc_scores_plain(codes, luts)
    return _launch(codes, luts)


def adc_scores_pallas(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's name for :func:`adc_scores_batched`: the same
    function and, on CUDA tensors, the same kernel."""
    return adc_scores_batched(codes, luts)


def adc_scores(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Single-query ADC: (N, M) u8 codes x (M, C) f32 LUT -> (N,) f32."""
    return adc_scores_batched(codes, lut[None])[0]


def descriptor_scores(desc_codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(N, K) u8 CDF descriptor bytes x (K,) f32 scales -> (N,) f32.

    "Effectively an extra part of the vector to dot product"
    (query_disk_index.rs:133-142)."""
    return desc_codes.float() @ scales.float()
