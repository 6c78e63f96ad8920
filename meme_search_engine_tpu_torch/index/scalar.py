"""Per-dimension u8 scalar quantizer with quantile clipping.

Counterpart of ``meme_search_engine_tpu/index/scalar.py`` (capability
parity with diskann/scalar_quantize.py): per-dimension affine u8
quantization clipped at the 1e-3/2 quantile tails (:13-17), with
integer-dot rescale factors sized against i32 accumulation overflow and
16-bit multiply limits (:61-83). Artifact layout matches
``quantizer.msgpack`` (:103-110: permutation, offsets, scales, q_offsets,
q_scales).

Training is host numpy, copied from the JAX package. ``quantize`` and
``dequantize`` are host work there too: here numpy input is answered on
the host and a tensor where it lies. ``integer_dot`` runs on ``device``
("cuda" unless the caller asks for the CPU) in int32, elementwise products
then an int32 sum (cuBLAS has no int32 product).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .opq import _tensor

__all__ = ["ScalarQuantizer", "train_scalar_quantizer"]

CUTOFF = 1e-3 / 2  # quantile clip (scalar_quantize.py:12)


@dataclasses.dataclass
class ScalarQuantizer:
    permutation: np.ndarray  # (D,) dimension order (identity by default)
    offsets: np.ndarray  # (D,) f32 — value of u8 0
    scales: np.ndarray  # (D,) f32 — 1/step_size
    q_offsets: np.ndarray  # (D,) i16 — integer offset added at dot time
    q_scales: np.ndarray  # (D,) i16 — integer per-dim rescale

    @property
    def n_dims(self) -> int:
        return self.permutation.shape[0]

    # -- artifact -----------------------------------------------------------

    def to_msgpack(self) -> bytes:
        import msgpack

        return msgpack.packb(
            {
                "permutation": self.permutation.astype(int).tolist(),
                "offsets": self.offsets.astype(float).tolist(),
                "scales": self.scales.astype(float).tolist(),
                "q_offsets": [int(x) for x in self.q_offsets],
                "q_scales": [int(x) for x in self.q_scales],
            }
        )

    @classmethod
    def from_msgpack(cls, data: bytes) -> "ScalarQuantizer":
        import msgpack

        d = msgpack.unpackb(data, raw=False)
        return cls(
            permutation=np.asarray(d["permutation"], np.int32),
            offsets=np.asarray(d["offsets"], np.float32),
            scales=np.asarray(d["scales"], np.float32),
            q_offsets=np.asarray(d["q_offsets"], np.int16),
            q_scales=np.asarray(d["q_scales"], np.int16),
        )

    # -- runtime ------------------------------------------------------------

    def _f32(self, a, device) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    def quantize(self, x):
        """(B, D) f32 -> (B, D) u8 (scalar_quantize.py:112-120)."""
        xt = _tensor(x, "cpu", torch.float32)
        perm = torch.as_tensor(self.permutation, dtype=torch.long, device=xt.device)
        raw = (xt[:, perm] - self._f32(self.offsets, xt.device)) * self._f32(
            self.scales, xt.device
        )
        codes = torch.clamp(torch.round(raw), 0, 255).to(torch.uint8)
        return codes if isinstance(x, torch.Tensor) else codes.numpy()

    def dequantize(self, codes):
        """(B, D) u8 -> (B, D) f32 in permuted order (:122-128)."""
        ct = _tensor(codes, "cpu")
        out = ct.float() / self._f32(self.scales, ct.device) + self._f32(
            self.offsets, ct.device
        )
        return out if isinstance(codes, torch.Tensor) else out.numpy()

    def integer_dot(self, x, y, device="cuda"):
        """Rescaled integer dot of u8 code rows; monotone proxy for the
        true dot (scalar_quantize.py:130-141 rdot):
        (x + q_off) * q_scale . (y + q_off), accumulated in int32."""
        xt = _tensor(x, device, torch.int32)
        dev = xt.device
        yt = _tensor(y, dev, torch.int32).to(dev)
        q_off = torch.as_tensor(self.q_offsets, dtype=torch.int32, device=dev)
        q_sc = torch.as_tensor(self.q_scales, dtype=torch.int32, device=dev)
        out = _integer_dot(xt, yt, q_off, q_sc)
        return out if isinstance(x, torch.Tensor) else out.cpu().numpy()


def _integer_dot(x, y, q_offsets, q_scales):
    x1 = (x + q_offsets[None, :]) * q_scales[None, :]
    y1 = y + q_offsets[None, :]
    # i32 accumulation: q_scales are bounded at train time so per-element
    # products fit i32 with headroom (scalar_quantize.py:70-78)
    return torch.sum(x1 * y1, dim=-1, dtype=torch.int32)


def column_quantile(x: torch.Tensor, q: float, chunk: int = 64) -> np.ndarray:
    """``np.quantile(x, q, axis=0)`` for an fp32 (N, D) tensor, bit for bit.

    The two order statistics that numpy's "linear" method reads are found
    per column on the tensor's device (``torch.kthvalue`` over ``chunk``
    columns at a time, so the device holds one (chunk, N) copy); numpy's
    own interpolation then runs on the host, in numpy's dtypes: q takes
    the data's dtype, the virtual index is ``(n - 1) * q`` and ``_lerp``
    switches form at gamma 0.5 (numpy/lib/_function_base_impl.py).
    """
    n, d = x.shape
    qa = np.asanyarray(q, dtype=np.float32)
    virtual = np.asanyarray((n - 1) * qa)
    if virtual >= n - 1:
        lo = hi = n - 1
    elif virtual < 0:
        lo = hi = 0
    else:
        lo = int(np.floor(virtual))
        hi = lo + 1
    gamma = np.asanyarray(virtual - np.floor(virtual), dtype=virtual.dtype)
    a = np.empty(d, np.float32)
    b = np.empty(d, np.float32)
    for c0 in range(0, d, chunk):
        cols = x[:, c0 : c0 + chunk].T.contiguous()
        a[c0 : c0 + chunk] = cols.kthvalue(lo + 1, dim=1).values.cpu().numpy()
        b[c0 : c0 + chunk] = cols.kthvalue(hi + 1, dim=1).values.cpu().numpy()
        del cols
    diff_b_a = np.subtract(b, a)
    lerp = np.asanyarray(np.add(a, diff_b_a * gamma))
    np.subtract(b, diff_b_a * (1 - gamma), out=lerp, where=gamma >= 0.5,
                casting="unsafe", dtype=type(lerp.dtype))
    return lerp


def train_scalar_quantizer(data) -> ScalarQuantizer:
    """Fit per-dim ranges on a dataset sample (scalar_quantize.py:13-83).

    ``data`` is numpy or a tensor; the quantiles' order statistics are
    found where it lies (:func:`column_quantile`), the rest is the JAX
    package's host numpy.
    """
    x = _tensor(data, "cpu", torch.float32)
    n_dims = x.shape[1]
    smin = column_quantile(x, CUTOFF)
    smax = column_quantile(x, 1 - CUTOFF)
    ranges = np.maximum(smax - smin, 1e-12)

    step = ranges / 255.0
    scales = 1.0 / step
    q_offsets = np.trunc(smin / step).astype(np.int64)

    # bound the integer rescale factor against i32 accumulator overflow
    # (one dim per bucket here, n_dims_per_bucket == 1) and 16-bit
    # multiply range (scalar_quantize.py:70-78)
    sfb = np.inf
    for j in range(n_dims):
        qo = q_offsets[j]
        nsfb = (2**31 - 1) / abs(255**2 + 2 * qo * 255 + qo**2) / 2
        sfb = min(sfb, nsfb, (2**15 - 1) // max(1, abs(qo) + 255))
    sfb = sfb / float(np.max(ranges) ** 2)
    q_scales = (ranges**2 * sfb).astype(np.int64)
    q_scales = np.maximum(q_scales, 1)

    return ScalarQuantizer(
        permutation=np.arange(n_dims, dtype=np.int32),
        offsets=smin.astype(np.float32),
        scales=scales.astype(np.float32),
        q_offsets=q_offsets.astype(np.int16),
        q_scales=q_scales.astype(np.int16),
    )
