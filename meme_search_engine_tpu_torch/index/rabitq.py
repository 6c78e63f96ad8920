"""RaBitQ-style 1-bit quantization (https://arxiv.org/abs/2405.12497).

Counterpart of ``meme_search_engine_tpu/index/rabitq.py`` (capability
parity with diskann/rabitq.py): vectors are mean-centered and
unit-normalised, rotated by a random orthonormal projection P
(output_dims x n_dims, default 512), and stored as sign bits plus an
exact-dot correction factor <o_bar, o>; the approximate inner product
reconstructs as norm * (o_bar . Pq) * dot + mean . q (rabitq.py:30-48).
Artifact layout matches ``rabitq.msgpack`` (rabitq.py:62-68).

Scoring a query against N codes is one product with the +-scale sign
matrix. As in ``index/opq.py``, device work runs on ``device`` ("cuda"
unless the caller asks for the CPU) or where a tensor argument lies, and
numpy input is answered with numpy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .opq import _tensor

__all__ = ["RaBitQ", "train_rabitq"]


@dataclasses.dataclass
class RaBitQ:
    mean: np.ndarray  # (D,)
    transform: np.ndarray  # (output_dims, D) rows of a random ortho matrix
    output_dims: int
    n_dims: int

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.output_dims)

    # -- artifact -----------------------------------------------------------

    def to_msgpack(self) -> bytes:
        import msgpack

        return msgpack.packb(
            {
                "mean": self.mean.astype(np.float32).flatten().tolist(),
                "transform": self.transform.astype(np.float32).flatten().tolist(),
                "output_dims": self.output_dims,
                "n_dims": self.n_dims,
            }
        )

    @classmethod
    def from_msgpack(cls, data: bytes) -> "RaBitQ":
        import msgpack

        d = msgpack.unpackb(data, raw=False)
        return cls(
            mean=np.asarray(d["mean"], np.float32),
            transform=np.asarray(d["transform"], np.float32).reshape(
                d["output_dims"], d["n_dims"]
            ),
            output_dims=d["output_dims"],
            n_dims=d["n_dims"],
        )

    # -- runtime ------------------------------------------------------------

    def _arrays(self, device):
        return (
            torch.as_tensor(self.mean, dtype=torch.float32, device=device),
            torch.as_tensor(self.transform, dtype=torch.float32, device=device),
        )

    def quantize(self, vectors, device="cuda") -> Tuple:
        """(N, D) -> (signs (N, output_dims) bool, dots (N,), norms (N,)).

        dots = <dequantized sign vector, rotated centered vector>, the
        per-vector correction factor (rabitq.py:30-35)."""
        v = _tensor(vectors, device, torch.float32)
        out = _quantize(v, *self._arrays(v.device), self.scale)
        if isinstance(vectors, torch.Tensor):
            return out
        return tuple(t.cpu().numpy() for t in out)

    def approx_dot(self, signs, dots, norms, query, device="cuda"):
        """Estimated inner products against the original vectors
        (rabitq.py:42-48), on the device the signs lie on."""
        s = _tensor(signs, device, torch.bool)
        dev = s.device
        out = _approx_dot(
            s,
            _tensor(dots, dev, torch.float32).to(dev),
            _tensor(norms, dev, torch.float32).to(dev),
            _tensor(query, dev, torch.float32).to(dev),
            *self._arrays(dev),
            self.scale,
        )
        return out if isinstance(signs, torch.Tensor) else out.cpu().numpy()

    @staticmethod
    def pack_bits(signs: np.ndarray) -> np.ndarray:
        """(N, B) bool -> (N, B/8) u8 for disk storage."""
        return np.packbits(np.asarray(signs, bool), axis=1)

    @staticmethod
    def unpack_bits(packed: np.ndarray, output_dims: int) -> np.ndarray:
        return np.unpackbits(packed, axis=1, count=output_dims).astype(bool)


def _quantize(vectors, mean, transform, scale):
    centered = vectors - mean[None, :]
    norms = torch.linalg.vector_norm(centered, dim=1)
    unit = centered / torch.clamp_min(norms[:, None], 1e-30)
    xs = unit @ transform.T
    signs = xs > 0
    dequant = scale * (2.0 * signs.float() - 1.0)
    dots = torch.sum(dequant * xs, dim=1)
    return signs, dots, norms


def _approx_dot(signs, dots, norms, query, mean, transform, scale):
    qt = transform @ query
    dequant = scale * (2.0 * signs.float() - 1.0)
    obar_q = dequant @ qt
    return norms * obar_q * dots + mean @ query


def train_rabitq(sample, output_dims: int = 512, seed: int = 0) -> RaBitQ:
    """Fit mean + random rotation from a dataset sample (rabitq.py:13-28).

    Only the first output_dims rows of the orthonormal matrix are kept
    (the algorithm uses P^-1 = P^T of a full rotation). The sample may be
    numpy or a tensor on any device; the rotation is drawn and factored on
    the CPU from a ``torch.Generator`` seeded with ``seed``, so it does not
    depend on the device.
    """
    sample = _tensor(sample, "cpu", torch.float32)
    n_dims = sample.shape[1]
    mean = sample.mean(dim=0).cpu().numpy()
    h = torch.randn((n_dims, n_dims), generator=torch.Generator().manual_seed(seed))
    q = torch.linalg.qr(h)[0]
    return RaBitQ(
        mean=mean,
        transform=q[:output_dims, :].contiguous().numpy(),
        output_dims=output_dims,
        n_dims=n_dims,
    )
