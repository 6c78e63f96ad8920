"""The (data x model) device mesh on ``torch.distributed``, and SigLIP's
tensor-parallel layout.

Counterpart of ``meme_search_engine_tpu/parallel/mesh.py``. There a
``jax.sharding.Mesh`` holds every device of one program and XLA inserts
the collectives; here each rank is one process with one device, and the
mesh is two sets of process groups over the ranks:

- ``data``: the batch and corpus-row dimension. Rank r sits at data
  coordinate ``r // model``, as device r of the JAX mesh's
  ``devices.reshape(data, model)`` grid.
- ``model``: tensor parallelism inside the towers (Megatron): q, k, v and
  fc1 split by columns, o and fc2 by rows (``parallel/train.py``).

``siglip_param_specs()`` is the JAX package's ``PartitionSpec`` tree as
tuples (``()`` replicated, ``(None, MODEL)`` the second dimension split
over ``model``); ``shard_params`` keeps on each rank the slice that the
JAX ``NamedSharding`` puts on the device at the same mesh position.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "DATA",
    "MODEL",
    "Mesh",
    "make_mesh",
    "siglip_param_specs",
    "shard_params",
    "split_dim",
    "tree_flat",
    "tree_leaves",
    "tree_map",
]

DATA, MODEL = "data", "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data x model) mesh of processes."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_group: object  # the ranks that share this rank's model coordinate
    model_group: object  # the ranks that share its data coordinate

    @property
    def shape(self) -> dict:
        return {DATA: self.data, MODEL: self.model}

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


def make_mesh(data: Optional[int] = None, model: int = 1, device=None) -> Mesh:
    """The (data x model) mesh over every rank of the initialised process
    group (``torch.distributed.init_process_group``, one process a device).

    ``data`` defaults to world size / model. ``device``: this rank's
    device; by default ``cuda:<current device>`` whatever the backend (gloo
    carries CUDA tensors too), so a caller that wants the CPU passes
    ``device="cpu"``. A CUDA device without a card raises.
    Every rank must call this, in the same order as its other group
    creations (each group is a ``new_group`` over all ranks).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    data = data if data is not None else world // model
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks, have {world}")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("mesh device 'cuda' requested but torch.cuda.is_available() is False")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    data_group = model_group = None
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            model_group = g
    return Mesh(data, model, rank, device, data_group, model_group)


def _block_specs() -> dict:
    """Specs of one stacked encoder block (leading axis = depth): q, k, v
    and fc1 split their output dimension, o and fc2 their input."""
    col = (None, None, MODEL)
    row = (None, MODEL, None)
    colb = (None, MODEL)
    rep = ()
    return {
        "ln1": {"g": rep, "b": rep},
        "attn": {
            "q": {"w": col, "b": colb},
            "k": {"w": col, "b": colb},
            "v": {"w": col, "b": colb},
            "o": {"w": row, "b": rep},
        },
        "ln2": {"g": rep, "b": rep},
        "mlp": {"fc1": {"w": col, "b": colb}, "fc2": {"w": row, "b": rep}},
    }


def siglip_param_specs() -> dict:
    """Spec tree matching ``models.siglip.init_params``'s output, the JAX
    package's (``parallel/mesh.py:62-95``)."""
    rep = ()
    col = {"w": (None, MODEL), "b": (MODEL,)}
    return {
        "img": {
            "patch_embed": col,
            "pos_emb": rep,
            "blocks": _block_specs(),
            "ln_final": {"g": rep, "b": rep},
            "map_head": {
                "probe": rep,
                "q": col,
                "k": col,
                "v": col,
                "o": {"w": (MODEL, None), "b": rep},
                "ln": {"g": rep, "b": rep},
                "mlp": {"fc1": col, "fc2": {"w": (MODEL, None), "b": rep}},
            },
        },
        "txt": {
            "token_emb": (None, MODEL),  # vocab-major table, width split
            "pos_emb": rep,
            "blocks": _block_specs(),
            "ln_final": {"g": rep, "b": rep},
            "head": col,
        },
        "t": rep,
        "b": rep,
    }


def split_dim(spec: tuple) -> Optional[int]:
    """The dimension a spec splits over ``model``, or None."""
    return spec.index(MODEL) if MODEL in spec else None


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and of trees shaped alike)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_flat(tree, prefix: str = "") -> dict:
    """The leaves of nested dicts keyed by their ``/``-joined paths."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tree_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _local(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    dim = split_dim(spec)
    if dim is not None:
        size = x.shape[dim]
        if size % mesh.model:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split {mesh.model} ways")
        part = size // mesh.model
        x = x.narrow(dim, mesh.model_rank * part, part)
    return x.to(mesh.device, copy=True).contiguous()


def shard_params(params: dict, mesh: Mesh) -> dict:
    """This rank's slice of a whole parameter tree, per
    :func:`siglip_param_specs`, on the mesh's device (a copy)."""
    return tree_map(lambda x, s: _local(x, s, mesh), params, siglip_param_specs())
