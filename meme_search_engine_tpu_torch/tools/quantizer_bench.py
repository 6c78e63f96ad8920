"""Quantizer quality benchmark (reference: faiss_bench_quantizer.py +
diskann/opq_test.py).

Counterpart of ``meme_search_engine_tpu/tools/quantizer_bench.py``: the same
CLI and JSON keys. It compares the codecs (OPQ 64x256, RaBitQ 512, scalar
u8) on encode throughput and approx-vs-exact rank agreement, and FAISS
codecs if faiss is importable. The corpus, the codes and the exact scores
stay on ``--device`` (the card unless the caller asks for the CPU), and
each query's top-k is taken there; top-k sets differ from an argsort's only
at exact ties. Without ``--vectors`` the corpus is the synthetic unit-norm
one, drawn on the device from a seeded ``torch.Generator``.

``encode_vecs_per_s`` keeps the JAX tool's key but times less: the encode
of a corpus that already lies on the device, with the codes left there.
The JAX tool's figure also holds the corpus's upload and the codes' copy
to the host (its scalar codec encodes on the host), so the two figures are
not to be read against each other.

Usage:
  python -m meme_search_engine_tpu_torch.tools.quantizer_bench \
      [--vectors x.bin --queries q.bin --d-emb 1152] [--n 20000] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..index.opq import ProductQuantizer


def rank_agreement(approx: torch.Tensor, exact: torch.Tensor, k: int = 20) -> float:
    """Fraction of true top-k recovered by approx top-k (opq_test.py:37-45
    flavour)."""
    ta = torch.topk(approx, k).indices
    te = torch.topk(exact, k).indices
    return float(torch.isin(ta, te).sum()) / k


@dataclasses.dataclass
class Run:
    """What a run leaves behind beside its printed results."""

    results: dict
    x: torch.Tensor  # (N, D) corpus on the device
    q: torch.Tensor  # (64, D) queries on the device
    pq: ProductQuantizer
    codes: torch.Tensor  # (N, chunks) u8 OPQ codes on the device


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _timed(device, fn):
    """fn() and its wall time, the device's queued work included."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def main(argv=None) -> Run:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vectors")
    ap.add_argument("--queries")
    ap.add_argument("--d-emb", type=int, default=1152)
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is False")

    if args.vectors:
        x = np.fromfile(args.vectors, np.float16).reshape(-1, args.d_emb)[: args.n]
        q = np.fromfile(args.queries, np.float16).reshape(-1, args.d_emb)[:64]
        x = torch.from_numpy(np.ascontiguousarray(x)).to(dev).float()
        q = torch.from_numpy(np.ascontiguousarray(q)).to(dev).float()
    else:
        gen = torch.Generator(device=dev).manual_seed(0)
        x = _unit(torch.randn((args.n, args.d_emb), generator=gen, device=dev))
        q = _unit(torch.randn((64, args.d_emb), generator=gen, device=dev))

    exact = x @ q.T  # (N, B)
    results = {}

    # OPQ
    from ..index.opq import train_opq

    pq = train_opq(
        x[: min(len(x), 50_000)],
        q,
        outer_iters=3,
        adam_iters=60,
        verbose=False,
        device=dev,
    )
    codes, enc_t = _timed(dev, lambda: pq.quantize_async(x))
    agree = np.mean(
        [
            rank_agreement(
                pq.asymmetric_dot(pq.preprocess_query(q[b].cpu().numpy()), codes),
                exact[:, b],
                args.k,
            )
            for b in range(len(q))
        ]
    )
    results["opq_64x256"] = {
        "encode_vecs_per_s": round(len(x) / enc_t, 0),
        "bytes_per_vec": pq.n_chunks,
        f"rank_agreement@{args.k}": round(float(agree), 4),
    }

    # RaBitQ
    from ..index.rabitq import train_rabitq

    rq = train_rabitq(x, output_dims=512)
    (signs, dots, norms), enc_t = _timed(dev, lambda: rq.quantize(x))
    agree = np.mean(
        [
            rank_agreement(rq.approx_dot(signs, dots, norms, q[b]), exact[:, b], args.k)
            for b in range(len(q))
        ]
    )
    del signs, dots, norms
    results["rabitq_512"] = {
        "encode_vecs_per_s": round(len(x) / enc_t, 0),
        "bytes_per_vec": 512 // 8 + 8,
        f"rank_agreement@{args.k}": round(float(agree), 4),
    }

    # scalar u8
    from ..index.scalar import train_scalar_quantizer

    sq = train_scalar_quantizer(x)
    sq_codes, enc_t = _timed(dev, lambda: sq.quantize(x))
    recon = sq.dequantize(sq_codes)
    del sq_codes
    perm = torch.as_tensor(sq.permutation, dtype=torch.long, device=dev)
    agree = np.mean(
        [
            rank_agreement(recon @ q[b][perm], exact[:, b], args.k)
            for b in range(len(q))
        ]
    )
    del recon
    results["scalar_u8"] = {
        "encode_vecs_per_s": round(len(x) / enc_t, 0),
        "bytes_per_vec": x.shape[1],
        f"rank_agreement@{args.k}": round(float(agree), 4),
    }

    # optional FAISS comparison (faiss_bench_quantizer.py parity)
    try:
        import faiss  # noqa

        xh = x.cpu().numpy()
        d = xh.shape[1]
        for name, factory in [("faiss_pq64", "PQ64x8"), ("faiss_opq64", "OPQ64,PQ64x8")]:
            idx = faiss.index_factory(d, factory, faiss.METRIC_INNER_PRODUCT)
            t0 = time.perf_counter()
            idx.train(xh)
            idx.add(xh)
            results[name] = {"train_add_s": round(time.perf_counter() - t0, 2)}
    except ImportError:
        results["faiss"] = "not available"

    print(json.dumps(results, indent=2))
    return Run(results=results, x=x, q=q, pq=pq, codes=codes)


if __name__ == "__main__":
    main()
