"""Sharded SigLIP training step (dp x tp over a :class:`mesh.Mesh`).

Counterpart of ``meme_search_engine_tpu/parallel/train.py``. The
reference consumes pretrained SigLIP weights and never trains the tower;
the step exists so the multi-device path runs end to end (and for
fine-tuning deployments).

Where JAX lets XLA insert the collectives, each rank here runs the
forward on its own slice of the parameters and of the batch:

- Inside each encoder block, Megatron's layout: q, k, v and fc1 split by
  columns (each rank holds whole heads), o and fc2 by rows. Before a
  column-parallel product the input passes Megatron's f (identity
  forward, all-reduce over ``model`` backward); after a row-parallel
  product the fp32 partial sums pass g (all-reduce forward, identity
  backward), then the bias is added once.
- Every leaf that the specs split outside the blocks (``patch_embed``,
  ``token_emb``, the MAP head's q, k, v, o, fc1, fc2 and the text
  ``head``) is gathered whole over ``model`` before use.
- The loss is the global batch's, as JAX's: every rank gathers the
  image and text embeddings of every data-parallel rank and computes the
  same B x B loss. The gather's backward is its adjoint (the gradients of
  all ranks summed, this rank's slice kept), so each of the ``data``
  copies of the loss counts once, and the step averages the gradients
  over ``data``. That holds for ``t`` and ``b`` too, which only the
  copies past the gather read.
- Attention is ``ops.attention.mha_xla`` (the plain route of
  ``siglip_loss``: no kernel has a backward).

The optimizer is ``torch.optim.AdamW`` at optax ``adamw``'s defaults
(b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every leaf), its
moments in the param dtype, as optax keeps them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
import torch.distributed as dist

from ..models import siglip
from ..ops.attention import mha_xla
from .mesh import Mesh, shard_params, siglip_param_specs, split_dim, tree_leaves, tree_map

__all__ = ["AdamWState", "adamw", "make_train_state", "make_train_step"]

ADAMW_DEFAULTS = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}


class _Enter(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    """Megatron's g: all-reduce over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over a group whose every rank then computes
    the same function of the result, and whose gradients are not summed
    over the group: the backward takes this rank's slice of the gradient,
    which is then the whole gradient of its input (Megatron's layout over
    ``model``)."""

    @staticmethod
    def forward(ctx, x, dim, group, index, size):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        ctx.dim, ctx.index, ctx.n = dim, index, x.shape[dim]
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None, None


class _GatherBatch(torch.autograd.Function):
    """All-gather along dim 0 over ``data``; the backward is the adjoint:
    every rank's gradient summed, this rank's rows kept."""

    @staticmethod
    def forward(ctx, x, group, index, size):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        ctx.group, ctx.index, ctx.n = group, index, x.shape[0]
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(0, ctx.index * ctx.n, ctx.n), None, None, None


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with fp32 accumulation, as an fp32 tensor: on the card one GEMM
    in x's dtype (fp32 accumulation, one rounding), on the CPU in fp32."""
    if x.device.type == "cuda":
        return torch.matmul(x, w).float()
    return x.float() @ w.float()


class _TensorParallel:
    """The ``par`` context of ``models/siglip.py``'s encoders and loss."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.mesh.model_group)

    def row_dense(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        y = _Reduce.apply(_matmul_f32(x, p["w"]), self.mesh.model_group)
        return (y + p["b"].float()).to(x.dtype)

    def gather_batch(self, z: torch.Tensor) -> torch.Tensor:
        m = self.mesh
        return _GatherBatch.apply(z, m.data_group, m.data_rank, m.data)


def _forward_view(local: dict, specs, mesh: Mesh) -> dict:
    """The tree the forward reads: the blocks as this rank holds them, every
    other split leaf gathered whole over ``model``."""
    if isinstance(local, dict):
        return {
            k: v if k == "blocks" else _forward_view(v, specs[k], mesh)
            for k, v in local.items()
        }
    dim = split_dim(specs)
    if dim is None:
        return local
    return _Gather.apply(local, dim, mesh.model_group, mesh.model_rank, mesh.model)


@dataclasses.dataclass
class AdamWState:
    """The optimizer's state as trees shaped like the params (optax's
    ``ScaleByAdamState``): the tensors ``torch.optim.AdamW`` updates in
    place, and the mesh they are laid out on."""

    mu: dict  # first moments (exp_avg)
    nu: dict  # second moments (exp_avg_sq)
    count: dict  # steps taken, a 0-d fp32 tensor a leaf
    mesh: Mesh | None = None


def adamw(params: dict, learning_rate: float = 1e-4, mesh: Mesh | None = None):
    """``torch.optim.AdamW`` over the leaves of ``params`` at optax
    ``adamw``'s defaults, with its state made up front (zero moments in
    each leaf's dtype) so that :class:`AdamWState` holds the very tensors
    the optimizer updates. Returns (optimizer, opt_state)."""
    leaves = tree_leaves(params)
    optimizer = torch.optim.AdamW(leaves, lr=learning_rate, **ADAMW_DEFAULTS)

    def init(p):
        state = optimizer.state[p]
        state["step"] = torch.tensor(0.0, dtype=torch.float32)
        state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return state

    states = tree_map(init, params)
    opt_state = AdamWState(
        mu=_select(states, "exp_avg"), nu=_select(states, "exp_avg_sq"),
        count=_select(states, "step"), mesh=mesh,
    )
    return optimizer, opt_state


def _select(states, key):
    """The ``key`` entry of every optimizer state in a tree of them."""
    if isinstance(states, dict) and key not in states:
        return {k: _select(v, key) for k, v in states.items()}
    return states[key]


def make_train_state(
    seed_or_gen,
    cfg: siglip.SigLIPConfig,
    mesh: Mesh,
    learning_rate: float = 1e-4,
    params: dict | None = None,
):
    """(this rank's params, optimizer, opt_state).

    The whole tree is ``siglip.init_params`` on the mesh's device from
    ``seed_or_gen`` (an int seed or a ``torch.Generator``; every rank draws
    the same tree), or ``params`` when given (e.g. the JAX package's
    ``init_params`` through ``models/convert.py``). Each rank keeps its
    slice (``mesh.shard_params``) as leaves that require grad.
    """
    if params is None:
        gen = seed_or_gen
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=mesh.device).manual_seed(int(seed_or_gen))
        params = siglip.init_params(cfg, gen, mesh.device)
    local = shard_params(params, mesh)
    del params
    for leaf in tree_leaves(local):
        leaf.requires_grad_(True)
    optimizer, opt_state = adamw(local, learning_rate, mesh)
    return local, optimizer, opt_state


def make_train_step(
    cfg: siglip.SigLIPConfig, mesh: Mesh, optimizer: torch.optim.Optimizer
) -> Callable[..., Tuple[dict, AdamWState, torch.Tensor]]:
    """``step(params, opt_state, images, tokens) -> (params, opt_state,
    loss)``, the params and moments updated in place.

    images: this rank's share of the global batch, float (B / data, R, R,
    3) in [-1, 1]; tokens: (B / data, L) ids; the ranks of one data
    coordinate pass the same share. The loss (a 0-d tensor on the mesh's
    device) is the global batch's, the same on every rank. After the step
    each leaf's ``.grad`` holds its slice of that loss's gradient (the
    average over ``data``).
    """
    par = _TensorParallel(mesh)
    specs = siglip_param_specs()

    def step(params, opt_state, images, tokens):
        optimizer.zero_grad(set_to_none=True)
        view = _forward_view(params, specs, mesh)
        loss = siglip._loss(
            view, images.to(mesh.device), tokens.to(mesh.device), cfg, mha_xla, par
        )
        loss.backward()
        for leaf in tree_leaves(params):
            if leaf.grad is None:
                raise RuntimeError("a parameter received no gradient")
            dist.all_reduce(leaf.grad, group=mesh.data_group)
            leaf.grad.div_(mesh.data)
        optimizer.step()
        return params, opt_state, loss.detach()

    return step
