"""Sharded training-state checkpoints.

Counterpart of ``meme_search_engine_tpu/parallel/checkpoint.py`` (orbax
there). ``step_{n}/`` holds one file per rank, ``rank_{r}.pt``, with the
rank's slices of the params and its AdamW state (``torch.save`` of plain
tensors, read back with ``weights_only=True``), and ``mesh.json`` with the
mesh's shape and the spec of every leaf. A state restores onto a mesh of
any shape, as orbax's does: each rank reads the saved model slices that
overlap its own (from data row 0; every data row holds the same), joins
them and cuts its part, for the params and AdamW's moments alike. Only
what orbax refuses is refused: another logical shape or dtype.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import siglip_param_specs, split_dim, tree_flat
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
    (e.g. from ``make_train_state`` on the target mesh, whatever its
    shape), in place; the latest step if ``step`` is None. Raises where a
    leaf's logical (whole) shape or dtype differs from the saved one."""
    path = os.path.abspath(path)
    if step is None:
        steps = [int(d.split("_")[1]) for d in os.listdir(path) if d.startswith("step_")]
        if not steps:
            raise FileNotFoundError(f"no step_* checkpoint under {path}")
        step = max(steps)
    src = os.path.join(path, f"step_{step}")
    with open(os.path.join(src, "mesh.json")) as f:
        saved = json.load(f)
    _, model, rank = _placement(opt_state_like)
    saved_model, mine = saved["model"], rank % model
    # every split leaf is cut into equal parts, so the saved columns that
    # overlap this rank's part are the same for all: [first, last)
    first = mine * saved_model // model
    last = -(-(mine + 1) * saved_model // model)
    states = [torch.load(os.path.join(src, f"rank_{m}.pt"), weights_only=True)
              for m in range(first, last)]
    targets = {
        "params": tree_flat(params_like), "mu": tree_flat(opt_state_like.mu),
        "nu": tree_flat(opt_state_like.nu), "count": tree_flat(opt_state_like.count),
    }
    with torch.no_grad():
        for part, leaves in targets.items():
            if set(leaves) != set(states[0][part]):
                raise ValueError(f"checkpoint {part} leaves differ from the target's")
            for k, t in leaves.items():
                t.copy_(_my_part(k, part, t, [st[part][k] for st in states], saved["specs"][k],
                                 saved_model, model, mine, first))
    return params_like, opt_state_like, step


def _my_part(key, part, t, pieces, spec, saved_model, model, mine, first):
    """This rank's part of a leaf from the saved columns ``first``, ...
    (``pieces``), checked against the target ``t``'s logical shape and
    dtype."""
    dim = split_dim(tuple(spec)) if t.dim() else None  # AdamW's counts are 0-d
    whole, want = list(pieces[0].shape), list(t.shape)
    if dim is not None:
        whole[dim] *= saved_model
        want[dim] *= model
    if whole != want or pieces[0].dtype != t.dtype:
        raise ValueError(f"{part} {key}: saved {tuple(whole)} {pieces[0].dtype}, "
                         f"target {tuple(want)} {t.dtype}")
    if dim is None:
        return pieces[0]
    lo = mine * t.shape[dim] - first * pieces[0].shape[dim]
    return torch.cat(pieces, dim).narrow(dim, lo, t.shape[dim])
