"""Bradley-Terry ensemble trainer (meme-rater/train.py parity).

Pairwise BCE on human win probabilities, AdamW 3e-4, each ensemble
member sees its own shuffled order of the same data (train.py:115-127),
JSONL step logging and checkpoints every 50 steps (train.py:96-127).

Counterpart of ``meme_search_engine_tpu/rater/train.py``. The members
train together: the per-member batch is a gathered (E, B, 2, D) tensor
and one step updates the whole stacked module. The data orders come
from ``numpy.random.default_rng(seed)`` in the JAX package's order, so
both packages draw the same batches. AdamW is ``torch.optim.AdamW`` at
optax ``adamw``'s settings (b1 0.9, b2 0.999, eps 1e-8, weight decay
1e-4; torch decays the parameter before the Adam update where optax adds
the decay to it, the same step up to an fp32 ulp). Dropout masks come
from a ``torch.Generator`` on the device seeded with ``seed``.

Checkpoints are the port's own: an ``.npz`` of the named parameters and
each one's AdamW moments and step. The JAX ``load_checkpoint`` cannot
read them (its optax tree has no torch counterpart), nor can
:func:`load_checkpoint` read the JAX package's.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.score_model import (
    ScoreEnsemble,
    ScoreModelConfig,
    bradley_terry_prob,
    init_ensemble,
)
from ..parallel.train import ADAMW_DEFAULTS
from ..serving.engine import resolve_device

CHECKPOINT_EVERY = 50  # train.py:98-102


@dataclasses.dataclass
class TrainSettings:
    lr: float = 3e-4
    batch_size: int = 128
    steps: int = 1000
    dropout: float = 0.1
    seed: int = 0
    log_path: Optional[str] = None
    checkpoint_dir: Optional[str] = None


def _bce(probs, targets):
    eps = 1e-7
    p = torch.clamp(probs, eps, 1 - eps)
    return -torch.mean(targets * torch.log(p) + (1 - targets) * torch.log(1 - p))


def train(
    pairs: np.ndarray,  # (N, 2, D)
    targets: np.ndarray,  # (N, channels)
    cfg: ScoreModelConfig,
    settings: TrainSettings = TrainSettings(),
    val: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    *,
    device: str | torch.device = "cuda",
    params: Optional[ScoreEnsemble] = None,
):
    """-> (params, history list of dicts). Runs on ``device`` ("cuda"
    unless the caller asks for the CPU); starts from a copy of ``params``
    where given, else from ``init_ensemble`` at ``settings.seed``."""
    n = len(pairs)
    if n == 0:
        raise ValueError("no pairs to train on")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(settings.seed)
    if params is None:
        model = init_ensemble(cfg, gen, dev)
    else:
        model = copy.deepcopy(params).to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=settings.lr, **ADAMW_DEFAULTS)

    pairs_dev = torch.from_numpy(np.asarray(pairs, np.float32)).to(dev)
    targets_dev = torch.from_numpy(np.asarray(targets, np.float32)).to(dev)

    # per-member shuffled data orders (train.py:115-120)
    rng = np.random.default_rng(settings.seed)
    orders = np.stack(
        [rng.permutation(n) for _ in range(cfg.n_ensemble)]
    )  # (E, N)

    def step(idx):
        # idx: (E, B) per-member sample indices
        batch = pairs_dev[idx]  # (E, B, 2, D)
        tgt = targets_dev[idx]  # (E, B, C)
        probs = bradley_terry_prob(
            model, batch, generator=gen, dropout_rate=settings.dropout
        )
        loss = _bce(probs, tgt)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        opt.step()
        return loss.detach()

    def val_loss_fn(vpairs, vtargets):
        with torch.no_grad():
            probs = bradley_terry_prob(
                model, vpairs[None].expand(cfg.n_ensemble, *vpairs.shape)
            )
            return _bce(probs, vtargets[None])

    history = []
    log_f = open(settings.log_path, "a") if settings.log_path else None
    b = min(settings.batch_size, n)
    pos = np.zeros(cfg.n_ensemble, np.int64)

    try:
        for it in range(settings.steps):
            idx = np.zeros((cfg.n_ensemble, b), np.int64)
            for e in range(cfg.n_ensemble):
                if pos[e] + b > n:
                    orders[e] = rng.permutation(n)
                    pos[e] = 0
                idx[e] = orders[e][pos[e] : pos[e] + b]
                pos[e] += b
            loss = step(torch.from_numpy(idx).to(dev))

            entry = {"step": it, "loss": float(loss), "time": time.time()}
            if val is not None and it % CHECKPOINT_EVERY == 0 and len(val[0]):
                entry["val_loss"] = float(
                    val_loss_fn(
                        torch.from_numpy(np.asarray(val[0], np.float32)).to(dev),
                        torch.from_numpy(np.asarray(val[1], np.float32)).to(dev),
                    )
                )
            history.append(entry)
            if log_f:
                log_f.write(json.dumps(entry) + "\n")
            if settings.checkpoint_dir and it % CHECKPOINT_EVERY == 0:
                save_checkpoint(
                    os.path.join(settings.checkpoint_dir, f"ckpt_{it}"), model, opt
                )
    finally:
        if log_f:
            log_f.close()
    return model, history


def save_checkpoint(path: str, params: ScoreEnsemble, opt: torch.optim.Optimizer):
    """Params + optimizer state (train.py:98-102 keeps both for resume)
    as ``path/state.npz``: ``param/<name>`` and, once the optimizer has
    stepped, ``exp_avg/<name>``, ``exp_avg_sq/<name>``, ``step/<name>``."""
    os.makedirs(path, exist_ok=True)
    arrays = {}
    for name, p in params.named_parameters():
        arrays[f"param/{name}"] = p.detach().cpu().numpy()
        for key, value in opt.state.get(p, {}).items():
            arrays[f"{key}/{name}"] = torch.as_tensor(value).detach().cpu().numpy()
    np.savez(os.path.join(path, "state.npz"), **arrays)


def load_checkpoint(path: str, params: ScoreEnsemble, opt: torch.optim.Optimizer):
    """Restore what :func:`save_checkpoint` wrote into ``params`` and
    ``opt`` (made as ``train`` makes them), in place."""
    data = np.load(os.path.join(path, "state.npz"))
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(torch.from_numpy(data[f"param/{name}"]))
            if f"step/{name}" in data.files:
                opt.state[p] = {
                    key: torch.from_numpy(data[f"{key}/{name}"]).to(
                        p.device if key != "step" else "cpu"
                    )
                    for key in ("step", "exp_avg", "exp_avg_sq")
                }
