"""Inner-product OPQ: training and asymmetric-distance runtime.

Counterpart of ``meme_search_engine_tpu/index/opq.py``, artifact-compatible
with the reference's ``opq.msgpack`` (diskann/aopq_train.py:87-93: flat
centroids, flat DxD orthonormal transform, n_dims_per_code, n_dims) and its
runtime semantics (diskann/src/vector.rs:308-406 ProductQuantizer): 64
subspaces x 18 dims x 256 centroids over d=1152; codes are per-subspace
argmax *inner product* (not L2) against full-D centroid rows sliced per
subspace.

Training follows the reference's query-aware scheme (aopq_train.py:33-85):
  (a) Adam on centroids minimising E_q[(q . (x - quant(x)))^2] over
      sampled real queries;
  (b) orthogonal Procrustes update of the rotation from SVD(X^T Y).

The quantizer's fields are numpy, as in the JAX package. Its device work
runs on ``device`` ("cuda" unless the caller asks for the CPU); methods
that take a tensor run on that tensor's device and answer with a tensor
there, and answer numpy input with numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["ProductQuantizer", "train_opq"]

# Rows encoded at once: (rows, 64, 256) fp32 sims are 2.1 GB at 32k rows,
# where the whole of a 1e6-row corpus would need 65.5 GB.
ENCODE_ROWS = 1 << 15


def _tensor(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


@dataclasses.dataclass
class ProductQuantizer:
    centroids: np.ndarray  # (C, D) float32 — full-D rows, sliced per chunk
    transform: np.ndarray  # (D, D) orthonormal
    n_dims_per_code: int
    n_dims: int

    @property
    def n_chunks(self) -> int:
        return self.n_dims // self.n_dims_per_code

    @property
    def n_centroids(self) -> int:
        return self.centroids.shape[0]

    # -- msgpack artifact (opq.msgpack layout, aopq_train.py:87-93) --------

    def to_msgpack(self) -> bytes:
        import msgpack

        return msgpack.packb(
            {
                "centroids": self.centroids.astype(np.float32).flatten().tolist(),
                "transform": self.transform.astype(np.float32).flatten().tolist(),
                "n_dims_per_code": self.n_dims_per_code,
                "n_dims": self.n_dims,
            }
        )

    @classmethod
    def from_msgpack(cls, data: bytes) -> "ProductQuantizer":
        import msgpack

        d = msgpack.unpackb(data, raw=False)
        n_dims = d["n_dims"]
        centroids = np.asarray(d["centroids"], np.float32).reshape(-1, n_dims)
        transform = np.asarray(d["transform"], np.float32).reshape(n_dims, n_dims)
        return cls(centroids, transform, d["n_dims_per_code"], n_dims)

    # -- runtime ------------------------------------------------------------

    def _arrays(self, device):
        return (
            torch.as_tensor(self.transform, dtype=torch.float32, device=device),
            torch.as_tensor(self.centroids, dtype=torch.float32, device=device),
        )

    def apply_transform(self, x, device="cuda"):
        """Rotate vectors into the quantization basis: x @ transform^T
        (the reference's transform (DxD) @ x^T written back row-major,
        vector.rs:320-329)."""
        xt = _tensor(x, device, torch.float32)
        out = xt @ self._arrays(xt.device)[0].T
        return out if isinstance(x, torch.Tensor) else out.cpu().numpy()

    def quantize(self, x, device="cuda") -> np.ndarray:
        """(B, D) -> (B, n_chunks) u8 codes on the host (vector.rs:331-364)."""
        return self.quantize_async(x, device).cpu().numpy()

    def quantize_async(self, x, device="cuda") -> torch.Tensor:
        """Encode without fetching the result: the codes stay on the device,
        so the bulk-pack loop can queue the next batch while the host packs
        this one. ``x`` is uploaded in its own dtype and widened on the
        device: fp16 corpora move half the bytes for bit-identical codes
        (fp16 -> fp32 widening is exact). A tensor is encoded where it lies."""
        xt = _tensor(x, device)
        return _quantize(xt, *self._arrays(xt.device), self.n_dims_per_code)

    def preprocess_query(self, query: np.ndarray) -> np.ndarray:
        """Query -> LUT (n_chunks, C) of per-chunk centroid dots
        (vector.rs:367-384). Host numpy: one ~100 KFLOP GEMV on the
        per-query serving path, cheaper than a device dispatch."""
        qt = np.asarray(query, np.float32) @ self.transform.T
        qc = qt.reshape(self.n_chunks, self.n_dims_per_code)
        cc = self.centroids.reshape(self.n_centroids, self.n_chunks, self.n_dims_per_code)
        return np.einsum("kd,ckd->kc", qc, cc, optimize=True)

    def asymmetric_dot(self, lut, codes, device="cuda"):
        """LUT-sum ADC scores with fp32 accumulation (vector.rs:387-405).

        ``codes`` may already lie on the device (a tensor), so a loop over
        queries uploads the corpus's codes once; the scores then stay there.
        numpy codes are uploaded to ``device`` and the scores come back as
        numpy."""
        from ..ops.adc import adc_scores

        codes_t = _tensor(codes, device, torch.uint8).contiguous()
        lut_t = torch.as_tensor(np.ascontiguousarray(lut, np.float32), device=codes_t.device)
        out = adc_scores(codes_t, lut_t)
        return out if isinstance(codes, torch.Tensor) else out.cpu().numpy()


def _quantize(x, transform, centroids, n_dims_per_code):
    """(B, D) any float dtype -> (B, chunks) u8, encoded ENCODE_ROWS rows at
    a time; the function is the reference's whole-batch one."""
    b, d = x.shape
    c = centroids.shape[0]
    n_chunks = d // n_dims_per_code
    cc = centroids.reshape(c, n_chunks, n_dims_per_code)
    out = torch.empty((b, n_chunks), dtype=torch.uint8, device=x.device)
    for lo in range(0, b, ENCODE_ROWS):
        xt = x[lo : lo + ENCODE_ROWS].float() @ transform.T
        xc = xt.reshape(-1, n_chunks, n_dims_per_code)
        # (rows, chunks, C) similarity per subspace in one batched product
        sims = torch.einsum("bkd,ckd->bkc", xc, cc)
        out[lo : lo + ENCODE_ROWS] = sims.argmax(dim=-1).to(torch.uint8)
    return out


def _make_lut(query, transform, centroids, n_dims_per_code):
    """One query (D,) -> LUT (chunks, C), on the query's device."""
    d = query.shape[-1]
    c = centroids.shape[0]
    n_chunks = d // n_dims_per_code
    qt = query.reshape(-1) @ transform.T
    qc = qt.reshape(n_chunks, n_dims_per_code)
    cc = centroids.reshape(c, n_chunks, n_dims_per_code)
    return torch.einsum("kd,ckd->kc", qc, cc)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _pq_assign_reconstruct(centroids, batch, n_dims_per_code):
    """Per-subspace nearest (max-IP) centroid reconstruction
    (aopq_train.py:18-28 semantics). The gradient reaches the centroids
    through the gather of the winning slices; the argmax carries none.

    Over the whole training sample (Procrustes) the (rows, chunks, C) fp32
    sims are 3.3 GB at 50k rows x 64 x 256: it fits the card."""
    b, d = batch.shape
    c = centroids.shape[0]
    n_chunks = d // n_dims_per_code
    xc = batch.reshape(b, n_chunks, n_dims_per_code)
    cc = centroids.reshape(c, n_chunks, n_dims_per_code)
    with torch.no_grad():
        assign = torch.einsum("bkd,ckd->bkc", xc, cc).argmax(dim=-1)  # (B, chunks)
    # each chunk's winning centroid slice: (chunks, C, dpc)[k, assign]
    recon = cc.transpose(0, 1)[torch.arange(n_chunks, device=batch.device)[None, :], assign]
    return recon.reshape(b, d)


def train_opq(
    vectors,
    queries,
    *,
    n_chunks: int = 64,
    n_centroids: int = 256,
    outer_iters: int = 10,
    adam_iters: int = 100,
    batch_size: int = 4096,
    query_batch_size: int = 2048,
    lr: float = 5e-4,
    seed: int = 0,
    verbose: bool = False,
    pause_point=None,  # optional safe-point callback, as in the JAX package
    device="cuda",
) -> ProductQuantizer:
    """Query-aware OPQ training (aopq_train.py flow).

    vectors: (N, D) dataset sample; queries: (Q, D) real query sample;
    numpy or tensors (tensors are used where they lie). Random numbers come
    from a CPU ``torch.Generator`` seeded with ``seed``, so the card and the
    CPU start from the same rotation, centroids and query draws.
    """
    x_dev = _tensor(vectors, device, torch.float32)
    dev = x_dev.device
    q_dev = _tensor(queries, dev, torch.float32).to(dev)
    n, d = x_dev.shape
    if d % n_chunks:
        raise ValueError(f"{d} dims do not split into {n_chunks} chunks")
    n_dims_per_code = d // n_chunks
    gen = torch.Generator().manual_seed(seed)

    # random orthonormal init via QR (aopq_train.py:62-65)
    h = torch.randn((d, d), generator=gen).to(dev)
    projection = torch.linalg.qr(h)[0]
    perm = torch.randperm(n, generator=gen)[:n_centroids].to(dev)
    # init codebook from sampled vectors *in the projected space* (the
    # space assignments happen in), so Adam starts from a sane partition
    centroids = x_dev[perm] @ projection

    # rows that do not fill a batch are dropped
    n_batches = max(1, n // batch_size)
    x_batched = x_dev[: n_batches * batch_size].reshape(
        n_batches, batch_size if n >= batch_size else n, d
    )

    for outer in range(outer_iters):
        # the projected batches do not depend on the centroids
        xp = x_batched @ projection
        qidx = torch.randint(0, q_dev.shape[0], (adam_iters, query_batch_size), generator=gen)
        qidx = qidx.to(dev)
        cen = centroids.clone().requires_grad_(True)
        opt = torch.optim.Adam([cen], lr=lr)  # fresh state each outer iteration
        for it in range(adam_iters):
            if pause_point is not None and it % 16 == 0:
                pause_point()
            qs = q_dev[qidx[it]]
            opt.zero_grad(set_to_none=False)
            # loss = sum over batches of the mean squared query error; one
            # backward per batch accumulates the same gradient
            loss = torch.zeros((), device=dev)
            for batch in xp:
                residual = batch - _pq_assign_reconstruct(cen, batch, n_dims_per_code)
                batch_loss = torch.mean(torch.square(qs @ residual.T))
                batch_loss.backward()
                loss += batch_loss.detach()
            opt.step()
        centroids = cen.detach()
        if verbose:
            print(f"opq outer {outer}: loss {float(loss):.5f}")
        # R = U V^T from SVD(X^T Y), Y = per-chunk reconstruction of X
        # (aopq_train.py:79-85): maximises tr(R^T X^T Y) over orthonormal R
        # (our convention is x @ projection). The (D, D) SVD runs in fp64:
        # on an H100 the fp32 one left R orthonormal only to 4.5e-4 at D=1152
        y = _pq_assign_reconstruct(centroids, x_dev @ projection, n_dims_per_code)
        u, _s, vt = torch.linalg.svd((x_dev.T @ y).double())
        projection = (u @ vt).float()

    return ProductQuantizer(
        centroids=centroids.cpu().numpy(),
        # runtime applies x @ transform.T; training projected with
        # x @ projection, so transform = projection.T
        transform=projection.T.contiguous().cpu().numpy(),
        n_dims_per_code=n_dims_per_code,
        n_dims=d,
    )
