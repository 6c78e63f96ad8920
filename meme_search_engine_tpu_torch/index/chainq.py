"""ChainQ: chain (residual/LSQ-style) quantization with Viterbi encoding.

Counterpart of ``meme_search_engine_tpu/index/chainq.py`` (capability
parity with diskann/chainq.py, experimental in the reference and unused
downstream): M codebooks of H entries over the full dimension, where
codebook supports overlap only between neighbours, so the exact joint
assignment minimising ||x - sum_m c_m||^2 decomposes into a chain and
dynamic programming (Viterbi) finds it:

  unary[m, h]  = -2 <c_mh, x> + ||c_mh||^2        (chainq.py:22)
  binary[m, h, h'] = 2 <c_mh, c_(m+1)h'>          (chainq.py:23-25)

The DP runs M - 1 steps with all N vectors in lockstep, each an (N, H, H)
min over fp32 unary and binary terms, in torch on ``device`` ("cuda"
unless the caller asks for the CPU); the argmins keep the first index of
equal costs, as JAX's do. Training alternates encode and an orthogonal
Procrustes update of the transform, whose SVD runs in fp64 as the port's
OPQ's does. The artifact format matches ``chainq.msgpack``
(chainq.py:158-164); ``msgpack`` is imported where it is used.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["ChainQuantizer", "viterbi_encode", "train_chainq"]

# (rows, H, H) fp32 costs of one DP step are held at most this many bytes
_STEP_BYTES = 1 << 30


def viterbi_encode(vectors, codebooks, device="cuda") -> torch.Tensor:
    """Optimal chain codes: (N, D) x (M, H, D) -> (N, M) int32, on the
    device of ``vectors`` if it is a tensor, else on ``device``.

    Exact when codebook supports overlap only between adjacent codebooks
    (the chain assumption; chainq.py:10-54).
    """
    x = torch.as_tensor(vectors, dtype=torch.float32, device=vectors.device
                        if isinstance(vectors, torch.Tensor) else device)
    cb = torch.as_tensor(codebooks, dtype=torch.float32, device=x.device)
    n, d = x.shape
    m, h, d2 = cb.shape
    if d != d2:
        raise ValueError(f"vectors of {d} dims against codebooks of {d2}")
    # binary[m]: (H, H') = 2 c_m . c_(m+1)
    binary = 2.0 * torch.einsum("mhd,mgd->mhg", cb[:-1], cb[1:])
    norms = torch.square(cb).sum(dim=2)  # (M, H)
    codes = torch.empty((n, m), dtype=torch.int32, device=x.device)
    rows = max(1, _STEP_BYTES // (4 * h * h))
    for lo in range(0, n, rows):
        xs = x[lo : lo + rows]
        # unary[m]: (rows, H) = ||c||^2 - 2 c.x  (x.x constant dropped)
        unary = -2.0 * torch.einsum("mhd,nd->mnh", cb, xs) + norms[:, None, :]
        cost = unary[0]  # (rows, H) best cost ending at state h of step m
        back = []
        for step in range(1, m):
            total = cost[:, :, None] + binary[step - 1][None, :, :]  # (rows, H, H')
            best, prev = torch.min(total, dim=1)
            back.append(prev)
            cost = best + unary[step]
        code = torch.argmin(cost, dim=1)
        codes[lo : lo + rows, m - 1] = code.int()
        for step in range(m - 2, -1, -1):
            code = back[step].gather(1, code[:, None])[:, 0]
            codes[lo : lo + rows, step] = code.int()
    return codes


@dataclasses.dataclass
class ChainQuantizer:
    codebooks: np.ndarray  # (M, H, D)
    transform: np.ndarray  # (D, D)
    n_dims: int
    n_dims_per_code: int

    def encode(self, vectors: np.ndarray, device="cuda") -> np.ndarray:
        xt = np.asarray(vectors, np.float32) @ self.transform.T
        return viterbi_encode(xt, self.codebooks, device).cpu().numpy()

    def reconstruct(self, codes: np.ndarray) -> np.ndarray:
        """Codes -> transformed-space reconstruction (chainq.py:123-126)."""
        out = np.zeros((len(codes), self.n_dims), np.float32)
        for m_i in range(self.codebooks.shape[0]):
            out += self.codebooks[m_i, codes[:, m_i]]
        return out

    def preprocess_query(self, query: np.ndarray) -> np.ndarray:
        """LUT (M, H): per-codebook dot with the rotated query; ADC then
        sums LUT entries exactly like PQ."""
        qt = np.asarray(query, np.float32) @ self.transform.T
        return np.einsum("mhd,d->mh", self.codebooks, qt)

    def to_msgpack(self) -> bytes:
        import msgpack

        return msgpack.packb(
            {
                "codebooks": self.codebooks.astype(np.float32).flatten().tolist(),
                "transform": self.transform.astype(np.float32).flatten().tolist(),
                "n_dims": self.n_dims,
                "n_dims_per_code": self.n_dims_per_code,
            }
        )

    @classmethod
    def from_msgpack(cls, data: bytes) -> "ChainQuantizer":
        import msgpack

        d = msgpack.unpackb(data, raw=False)
        n_dims = d["n_dims"]
        m = n_dims // d["n_dims_per_code"]
        codebooks = np.asarray(d["codebooks"], np.float32).reshape(m, -1, n_dims)
        return cls(
            codebooks=codebooks,
            transform=np.asarray(d["transform"], np.float32).reshape(n_dims, n_dims),
            n_dims=n_dims,
            n_dims_per_code=d["n_dims_per_code"],
        )


def train_chainq(
    vectors: np.ndarray,
    n_codebooks: int,
    n_entries: int,
    *,
    init_transform: Optional[np.ndarray] = None,
    init_centroids: Optional[np.ndarray] = None,
    n_iters: int = 10,
    seed: int = 0,
    device="cuda",
) -> ChainQuantizer:
    """Alternate Viterbi encode / Procrustes transform update
    (chainq.py:113-138) on ``device``. Codebooks init from per-chunk
    centroid slices (chainq.py:146-151) or random rows, as in the JAX
    package; like it, the loop updates the transform only.
    """
    x = np.asarray(vectors, np.float32)
    n, d = x.shape
    m, h = n_codebooks, n_entries
    dpc = d // m
    rng = np.random.default_rng(seed)

    transform = (
        np.asarray(init_transform, np.float32)
        if init_transform is not None
        else np.eye(d, dtype=np.float32)
    )
    codebooks = np.zeros((m, h, d), np.float32)
    if init_centroids is None:
        init_centroids = x[rng.permutation(n)[:h]] @ transform.T
    for dim in range(d):
        codebooks[dim // dpc, :, dim] = init_centroids[:, dim]

    cb = torch.from_numpy(codebooks).to(device)
    x_dev = torch.from_numpy(x).to(device)
    t = torch.from_numpy(transform).to(device)
    steps = torch.arange(m, device=x_dev.device)[None, :]
    for _ in range(n_iters):
        xt = x_dev @ t.T
        codes = viterbi_encode(xt, cb).long()
        quantized = cb[steps, codes].sum(dim=1)  # (N, D)
        # orthogonal Procrustes on the transform (chainq.py:130-135), in
        # fp64: the rotation stays orthonormal to rounding
        u, _s, vt = torch.linalg.svd((xt.T @ quantized).double())
        # convention: rotate with x @ T.T; the chain uses T = (U V^T)^T-form
        t = ((u @ vt).T @ t.double()).float()

    return ChainQuantizer(
        codebooks=cb.cpu().numpy(),
        transform=t.cpu().numpy(),
        n_dims=d,
        n_dims_per_code=dpc,
    )
