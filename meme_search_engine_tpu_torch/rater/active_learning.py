"""Active-learning pair selection for the rating queue.

Parity with meme-rater/active_learning.py (ensemble-variance selection,
:44-57), active_learning_gradients.py (per-sample gradient norms via
vmapped grad, :44-72) and active_learning_find_top.py (top-percentile
random pairs). Selected pairs feed the labelling queue
(copy_into_queue.py semantics -> RatingsDB.push_queue).

Counterpart of ``meme_search_engine_tpu/rater/active_learning.py``. Each
function runs the ensemble on ``device`` ("cuda" unless the caller asks
for the CPU). Variances are population variances (``correction=0``, as
``jnp.var``); the pair ranking takes the ensemble's outputs to the host
and ranks them in numpy, as the JAX function does, so both order ties
alike. ``gradient_norms`` takes per-pair gradients with ``torch.func``
(``functional_call``, ``vmap``, ``grad``) over every parameter, in
chunks of pairs: at full width one pair's gradient is 21.3 M floats.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..models.score_model import ScoreEnsemble, ensemble_forward, on_device

__all__ = [
    "ensemble_variance",
    "select_pairs_by_variance",
    "gradient_norms",
    "select_top_percentile_pairs",
]

# pairs a chunk of gradient_norms: 16 per-pair gradients are 1.4 GB at
# the reference's width
GRAD_CHUNK = 16


def ensemble_variance(
    params: ScoreEnsemble, embeddings: np.ndarray, *, device="cuda"
) -> np.ndarray:
    """Per-item variance of ensemble scores, summed over channels —
    high variance = most informative to label."""
    params = on_device(params, device)
    with torch.no_grad():
        out = ensemble_forward(params, embeddings)
        return torch.var(out, dim=0, correction=0).sum(dim=-1).cpu().numpy()


def select_pairs_by_variance(
    params: ScoreEnsemble,
    embeddings: np.ndarray,
    n_pairs: int,
    *,
    seed: int = 0,
    device="cuda",
) -> List[Tuple[int, int]]:
    """Pair up the highest-variance items (active_learning.py:44-57:
    candidate pairs ranked by ensemble disagreement on the pair
    difference)."""
    rng = np.random.default_rng(seed)
    n = len(embeddings)
    n_cand = min(n * 4, 4096)
    cand = rng.integers(0, n, (n_cand, 2))
    cand = cand[cand[:, 0] != cand[:, 1]]
    params = on_device(params, device)
    with torch.no_grad():
        out = ensemble_forward(params, embeddings).cpu().numpy()  # (E, N, C)
    diff = out[:, cand[:, 0]] - out[:, cand[:, 1]]
    probs = 1 / (1 + np.exp(-diff))  # (E, P, C)
    var = probs.var(axis=0).sum(axis=-1)
    order = np.argsort(-var)[:n_pairs]
    return [tuple(map(int, cand[i])) for i in order]


def gradient_norms(
    params: ScoreEnsemble,
    pairs: np.ndarray,
    targets: np.ndarray,
    *,
    device="cuda",
) -> np.ndarray:
    """Per-pair gradient norm of the BT loss over every parameter
    (vmapped grad over samples, active_learning_gradients.py:44-72)."""
    from torch.func import functional_call, grad, vmap

    params = on_device(params, device)
    dev = params.device
    leaves = {k: v.detach() for k, v in params.named_parameters()}
    e = params.n_ensemble

    def single_loss(p, pair, tgt):
        s1 = functional_call(params, p, (pair[0][None].expand(e, 1, -1),))
        s2 = functional_call(params, p, (pair[1][None].expand(e, 1, -1),))
        eps = 1e-7
        probs = torch.clamp(torch.sigmoid(s1 - s2).mean(dim=0), eps, 1 - eps)
        return -torch.mean(tgt * torch.log(probs) + (1 - tgt) * torch.log(1 - probs))

    per_pair = vmap(grad(single_loss), in_dims=(None, 0, 0))
    pairs_t = torch.from_numpy(np.asarray(pairs, np.float32))
    targets_t = torch.from_numpy(np.asarray(targets, np.float32))
    out = []
    for s in range(0, len(pairs_t), GRAD_CHUNK):
        grads = per_pair(
            leaves, pairs_t[s : s + GRAD_CHUNK].to(dev), targets_t[s : s + GRAD_CHUNK].to(dev)
        )
        total = sum(g.reshape(g.shape[0], -1).square().sum(dim=1) for g in grads.values())
        out.append(torch.sqrt(total).cpu())
    if not out:
        return np.zeros(0, np.float32)
    return torch.cat(out).numpy()


def select_top_percentile_pairs(
    scores: np.ndarray,
    n_pairs: int,
    percentile: float = 90.0,
    seed: int = 0,
) -> List[Tuple[int, int]]:
    """Random pairs among top-percentile items
    (active_learning_find_top.py)."""
    rng = np.random.default_rng(seed)
    threshold = np.percentile(scores, percentile)
    top = np.flatnonzero(scores >= threshold)
    if len(top) < 2:
        return []
    pairs = []
    for _ in range(n_pairs):
        i, j = rng.choice(top, 2, replace=False)
        pairs.append((int(i), int(j)))
    return pairs
