"""Sharded training-state checkpoints.

Counterpart of ``meme_search_engine_tpu/parallel/checkpoint.py`` (orbax
there). ``step_{n}/`` holds one file per rank, ``rank_{r}.pt``, with the
rank's slices of the params and its AdamW state (``torch.save`` of plain
tensors, read back with ``weights_only=True``), and ``mesh.json`` with the
mesh's shape and the spec of every leaf. A state restores onto a mesh of
the same shape only: orbax's resharding is not copied, so another shape
raises.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import siglip_param_specs, tree_flat
from .train import AdamWState

__all__ = ["save_train_state", "restore_train_state"]


def _placement(opt_state: AdamWState) -> Tuple[int, int, int]:
    """(data, model, rank) of the state's mesh; (1, 1, 0) without one."""
    m = opt_state.mesh
    return (1, 1, 0) if m is None else (m.data, m.model, m.rank)


def _barrier(opt_state: AdamWState) -> None:
    if opt_state.mesh is not None and dist.is_initialized():
        dist.barrier()


def save_train_state(path: str, params: dict, opt_state: AdamWState, step: int) -> None:
    """Every rank calls this; each writes its own file under ``step_{step}``."""
    data, model, rank = _placement(opt_state)
    out = os.path.join(os.path.abspath(path), f"step_{step}")
    os.makedirs(out, exist_ok=True)
    state = {
        "params": {k: v.detach().cpu() for k, v in tree_flat(params).items()},
        "mu": {k: v.cpu() for k, v in tree_flat(opt_state.mu).items()},
        "nu": {k: v.cpu() for k, v in tree_flat(opt_state.nu).items()},
        "count": {k: v.cpu() for k, v in tree_flat(opt_state.count).items()},
    }
    torch.save(state, os.path.join(out, f"rank_{rank}.pt"))
    if rank == 0:
        specs = {k: list(v) for k, v in tree_flat(siglip_param_specs()).items()}
        with open(os.path.join(out, "mesh.json"), "w") as f:
            json.dump({"data": data, "model": model, "specs": specs}, f)
    _barrier(opt_state)


def restore_train_state(
    path: str, params_like: dict, opt_state_like: AdamWState, step: Optional[int] = None
) -> Tuple[dict, AdamWState, int]:
    """Restore (params, opt_state, step) into the tensors of ``*_like``
    (e.g. from ``make_train_state`` on the target mesh), in place; the
    latest step if ``step`` is None. Raises on a mesh of another shape."""
    path = os.path.abspath(path)
    if step is None:
        steps = [int(d.split("_")[1]) for d in os.listdir(path) if d.startswith("step_")]
        if not steps:
            raise FileNotFoundError(f"no step_* checkpoint under {path}")
        step = max(steps)
    src = os.path.join(path, f"step_{step}")
    with open(os.path.join(src, "mesh.json")) as f:
        saved = json.load(f)
    data, model, rank = _placement(opt_state_like)
    if (saved["data"], saved["model"]) != (data, model):
        raise ValueError(
            f"checkpoint saved on a {saved['data']} x {saved['model']} mesh; restoring onto "
            f"{data} x {model} would need resharding, which is not supported"
        )
    state = torch.load(os.path.join(src, f"rank_{rank}.pt"), weights_only=True)
    targets = {
        "params": tree_flat(params_like), "mu": tree_flat(opt_state_like.mu),
        "nu": tree_flat(opt_state_like.nu), "count": tree_flat(opt_state_like.count),
    }
    with torch.no_grad():
        for part, leaves in targets.items():
            if set(leaves) != set(state[part]):
                raise ValueError(f"checkpoint {part} leaves differ from the target's")
            for k, t in leaves.items():
                if t.shape != state[part][k].shape:
                    raise ValueError(f"{part} {k}: saved {tuple(state[part][k].shape)}, "
                                     f"target {tuple(t.shape)}")
                t.copy_(state[part][k])
    return params_like, opt_state_like, step
