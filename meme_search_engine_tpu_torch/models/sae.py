"""Top-k sparse autoencoder over embeddings (interpretability).

Capability parity with sae/model.py: tied-init up/down projections,
ReLU then keep only the top-k activations per sample (k=128 over
d_hidden=262144 at reference scale), strict-greater thresholding so ties
at the boundary drop out (sae/model.py:31-43), plus per-feature
activation counters.

Trainer parity with sae/train.py: MSE reconstruction, AdamW; the
activation counters support dead-feature tracking.

Counterpart of ``meme_search_engine_tpu/models/sae.py``: the parameters
are a dict of tensors in the JAX layout (``up_w`` (d_emb, d_hidden),
``down_w`` (d_hidden, d_emb), ``down_b``, optional ``up_b``). The
threshold is the (k+1)-th largest value, ``torch.topk(x, k + 1)``'s
last, which does not depend on how ties are ordered; the mask carries no
gradient. AdamW is ``torch.optim.AdamW`` at optax ``adamw``'s settings
(weight decay 1e-4). Everything runs on ``device`` ("cuda" unless the
caller asks for the CPU); initialisation draws from a ``torch.Generator``
there, batches from ``numpy.random.default_rng(seed)`` in the JAX
package's order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.train import ADAMW_DEFAULTS
from ..serving.engine import resolve_device

__all__ = [
    "SAEConfig",
    "decoder_features",
    "init_sae",
    "make_sae_train_step",
    "params_from_jax",
    "sae_forward",
    "train_sae",
]


@dataclasses.dataclass(frozen=True)
class SAEConfig:
    d_emb: int = 1152
    d_hidden: int = 262144
    top_k: int = 128
    up_proj_bias: bool = False


def init_sae(
    cfg: SAEConfig, generator: torch.Generator, device: str | torch.device = "cuda"
) -> Dict[str, torch.Tensor]:
    """N(0, 1/d_emb) up projection from ``generator`` (on ``device``), the
    down projection its transpose (tied init, sae/model.py:22), zero
    biases."""
    dev = resolve_device(device)
    scale = (1.0 / cfg.d_emb) ** 0.5
    up = torch.randn((cfg.d_emb, cfg.d_hidden), generator=generator, device=dev) * scale
    params = {
        "up_w": up,
        "down_w": up.T.contiguous(),
        "down_b": torch.zeros(cfg.d_emb, device=dev),
    }
    if cfg.up_proj_bias:
        params["up_b"] = torch.zeros(cfg.d_hidden, device=dev)
    return params


def params_from_jax(tree, device: str | torch.device = "cuda") -> Dict[str, torch.Tensor]:
    """The JAX package's SAE tree (numpy or jax arrays) on ``device``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev) for k, v in tree.items()}


def sae_forward(
    params: Dict[str, torch.Tensor], embs: torch.Tensor, cfg: SAEConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (reconstruction (B, d_emb), activation counts (d_hidden,) i32).

    Top-k with strict-greater masking: the threshold is the (k+1)-th
    largest post-ReLU value; only values strictly above it survive, so a
    row keeps at most k and ReLU ties at zero never activate
    (sae/model.py:34-41 semantics).
    """
    x = embs @ params["up_w"]
    if "up_b" in params:
        x = x + params["up_b"]
    x = torch.relu(x)
    kth = torch.topk(x.detach(), cfg.top_k + 1, dim=1).values[:, -1]  # (B,)
    mask = x.detach() > kth[:, None]
    x = torch.where(mask, x, 0.0)
    counts = mask.sum(dim=0, dtype=torch.int32)
    recon = torch.addmm(params["down_b"], x, params["down_w"])
    return recon, counts


def make_sae_train_step(
    cfg: SAEConfig, optimizer: torch.optim.Optimizer
) -> Callable:
    """-> ``step(params, batch, counters) -> (loss, counters)``: one MSE +
    AdamW step on ``params`` (the tensors ``optimizer`` holds, updated in
    place); the loss is a 0-d tensor on the device."""

    def step(params, batch, counters):
        recon, counts = sae_forward(params, batch, cfg)
        loss = torch.mean(torch.square(recon - batch))
        optimizer.zero_grad(set_to_none=False)
        loss.backward()
        optimizer.step()
        return loss.detach(), counters + counts

    return step


def train_sae(
    embeddings: np.ndarray,
    cfg: SAEConfig,
    *,
    steps: int = 1000,
    batch_size: int = 1024,
    lr: float = 1e-4,
    seed: int = 0,
    verbose: bool = False,
    device: str | torch.device = "cuda",
    params: Optional[Dict[str, torch.Tensor]] = None,
):
    """-> (params, feature activation counters). MSE + AdamW
    (sae/train.py flow). Starts from a copy of ``params`` where given,
    else from ``init_sae`` at ``seed``."""
    dev = resolve_device(device)
    if params is None:
        params = init_sae(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    params = {k: v.detach().to(dev, copy=True).requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.AdamW(list(params.values()), lr=lr, **ADAMW_DEFAULTS)
    step = make_sae_train_step(cfg, opt)
    counters = torch.zeros(cfg.d_hidden, dtype=torch.int32, device=dev)

    if isinstance(embeddings, torch.Tensor):
        x = embeddings.to(device=dev, dtype=torch.float32)
    else:
        x = torch.from_numpy(np.asarray(embeddings, np.float32)).to(dev)
    n = len(x)
    rng = np.random.default_rng(seed)
    for it in range(steps):
        idx = rng.integers(0, n, min(batch_size, n))
        loss, counters = step(params, x[torch.from_numpy(idx).to(dev)], counters)
        if verbose and it % 100 == 0:
            print(f"sae step {it}: loss {float(loss):.6f}")
    return {k: v.detach() for k, v in params.items()}, counters.cpu().numpy()


def decoder_features(params) -> np.ndarray:
    """Decoder rows for feature-exemplar export (sae/export_features.py
    queries these against the live search backend)."""
    return params["down_w"].detach().cpu().numpy()
