"""Parameter bridge from the JAX package's SigLIP tree to the port's.

The input is the JAX tree as numpy arrays (``jax.tree.map(np.asarray,
params)``), bf16 leaves as ``ml_dtypes.bfloat16``. Each bf16 leaf goes
through float32 to ``torch.bfloat16``, which is exact both ways;
``torch.from_numpy`` does not take the ml_dtypes type.
``tree_from_numpy`` keeps the tree's layout; ``params_from_numpy`` then
replaces the image tower's leaves with the kernel layouts, once, here
(``siglip.prepare_params``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import siglip

__all__ = ["params_from_numpy", "tensor_from_numpy", "tree_from_numpy"]


def tensor_from_numpy(x: Any, device: str | torch.device = "cpu") -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def tree_from_numpy(tree: dict, device: str | torch.device = "cpu") -> dict:
    """JAX-layout numpy tree -> the same layout as tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def params_from_numpy(
    tree: dict, cfg: siglip.SigLIPConfig, device: str | torch.device = "cpu"
) -> dict:
    """JAX-layout numpy tree -> the port's tree on ``device``, with the
    image tower in the kernel layouts."""
    return siglip.prepare_params(tree_from_numpy(tree, torch.device(device)), cfg)
