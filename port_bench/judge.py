"""The comparison that decides ``correct``: a seeded sample of the rows a
window served against the plain reference's.

:func:`sample_rows` draws (call, row) pairs from the seed once the window
has closed, half of them from each half of a batch, so a batch whose
second half went missing shows. :func:`reference_rows` works the sampled
inputs out again with the reference (``reference/``) from its own copy of
the seed's weights, fp32 with TF32 off (the control: the same, one
precision below). :func:`emb_err` is the number compared: the largest L2
distance between a served row and the reference's.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from . import data, generate

__all__ = ["sample_rows", "reference_rows", "emb_err"]


def sample_rows(n_calls: int, batch: int, count: int, seed: int) -> List[Tuple[int, int]]:
    rng = np.random.default_rng(data.sub_seed(seed, "sample"))
    half = batch // 2
    out = []
    for j in range(count):
        lo = 0 if j % 2 == 0 or half == 0 else half
        hi = half if (j % 2 == 0 and half) else batch
        out.append((int(rng.integers(0, n_calls)), int(rng.integers(lo, hi))))
    return out


def reference_rows(ctx, items: Sequence[Tuple[str, object]], precision: str = "fp32") -> np.ndarray:
    """The reference's (n, d_emb) fp32 rows of ``items``, (kind, input)
    pairs, each kind through its term's reference in one pass."""
    from .reference import siglip as ref

    ref.no_tf32()
    out = np.zeros((len(items), ctx.model["d_emb"]), np.float32)
    for kind in sorted({k for k, _ in items}):
        t = generate.term(kind)
        tree = data.siglip_params(ctx.model, ctx.seed, ctx.device)
        params = ref.to_fp32({t.TOWER: tree[t.TOWER]})
        del tree
        rows = [i for i, (k, _) in enumerate(items) if k == kind]
        got = t.reference(params, [items[i][1] for i in rows], ctx.model, precision, ctx.device)
        out[rows] = got.cpu().numpy()
        del params
    return out


def emb_err(got: np.ndarray, want: np.ndarray) -> float:
    err = np.linalg.norm(np.asarray(got, np.float32) - want, axis=1)
    return float(err.max()) if np.isfinite(err).all() else math.inf
