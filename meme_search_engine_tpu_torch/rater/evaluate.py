"""Quality-model evaluation (reference: meme-rater/eval.py,
auroc_test.py, roc_plot.py, final_eval_results.py).

- AUROC of model pair-orderings against held-out human labels
  (auroc_test.py) with the full ROC curve (roc_plot.py:15-31).
- Percentile sheets: sample items at each score percentile for visual
  inspection (eval.py:52-85) — emitted as an HTML grid.
- Loss-curve extraction from the trainer's JSONL logs (run_graph.py).

A copy of ``meme_search_engine_tpu/rater/evaluate.py``, which the port
keeps rather than imports.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np


def roc_curve(
    labels: np.ndarray, scores: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (false positive rate, true positive rate) sweeping thresholds."""
    order = np.argsort(-scores)
    labels = np.asarray(labels, bool)[order]
    tps = np.cumsum(labels)
    fps = np.cumsum(~labels)
    tpr = tps / max(1, labels.sum())
    fpr = fps / max(1, (~labels).sum())
    return np.concatenate([[0.0], fpr]), np.concatenate([[0.0], tpr])


def auroc(labels: np.ndarray, scores: np.ndarray) -> float:
    fpr, tpr = roc_curve(labels, scores)
    return float(np.trapezoid(tpr, fpr))


def pairwise_auroc(
    model_scores: np.ndarray,  # (N,) per-item model scores
    pairs: Sequence[Tuple[int, int]],
    human_prefers_first: Sequence[bool],
) -> float:
    """AUROC of score differences vs human pair preferences
    (auroc_test.py semantics: does the model's margin predict the human
    choice?)."""
    diffs = np.asarray(
        [model_scores[i] - model_scores[j] for i, j in pairs]
    )
    return auroc(np.asarray(human_prefers_first, bool), diffs)


def percentile_sheet(
    filenames: Sequence[str],
    scores: np.ndarray,
    *,
    percentiles: Sequence[float] = (0, 10, 25, 50, 75, 90, 99),
    per_bucket: int = 8,
    image_prefix: str = "/image/",
    seed: int = 0,
) -> str:
    """HTML sheet of sampled items around each score percentile
    (eval.py:52-85)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(scores)
    n = len(order)
    rows = []
    for p in percentiles:
        lo = int(n * p / 100)
        hi = min(n, max(lo + 1, int(n * (p + 10) / 100)))
        bucket = order[lo:hi]
        sample = rng.choice(bucket, min(per_bucket, len(bucket)), replace=False)
        imgs = "".join(
            f'<img src="{image_prefix}{filenames[i]}" title="{scores[i]:.3f}">'
            for i in sample
        )
        rows.append(f"<h3>p{p}</h3><div>{imgs}</div>")
    return (
        "<!doctype html><html><head><style>img{max-height:160px;margin:2px}"
        "</style></head><body>" + "".join(rows) + "</body></html>"
    )


def loss_curves(log_path: str) -> Dict[str, List[float]]:
    """JSONL training log -> {loss: [...], val_loss: [...]}
    (run_graph.py flavour)."""
    out: Dict[str, List[float]] = {"loss": [], "val_loss": []}
    with open(log_path) as f:
        for line in f:
            entry = json.loads(line)
            out["loss"].append(entry["loss"])
            if "val_loss" in entry:
                out["val_loss"].append(entry["val_loss"])
    return out
