"""Quality (meme-rater) model: Bradley-Terry ensemble + wide serving form.

Capability parity with meme-rater/model.py and src/score_model.rs:
- Ensemble of n_ensemble MLPs (n_hidden x [dropout -> Linear d->d ->
  SiLU] -> Linear d->output_channels), trained pairwise: win probability
  sigmoid(score1 - score2) (model.py:18-52).
- Wide export for serving: member hidden layers concatenate into one
  (E*d, d) up_proj and a (channels, E*d) down_proj; the ensemble mean
  becomes scale * down_proj @ silu(up_proj @ x + bias) with
  scale = d_emb / d_hidden = 1/E (ensemble_to_wide_model.py:39-68,
  score_model.rs:13-32). Output biases are zeroed first — Bradley-Terry
  scores are shift-invariant (ensemble_to_wide_model.py:36-37,52).

Counterpart of ``meme_search_engine_tpu/models/score_model.py``. The
members are stacked on a leading axis in the JAX layout (hidden ``w``
(E, d_in, d_out), ``b`` (E, d_out); output ``w`` (E, d, C), ``b`` (E, C))
inside one ``nn.Module``, so one ``torch.baddbmm`` a layer runs every
member, as the JAX package's ``vmap`` does. Randomness comes from an
explicit ``torch.Generator`` on the parameters' device. Dropout draws
its own masks, so it is the JAX package's in law, not in value. Products
are fp32; TF32 is left to the caller's ``torch.backends`` setting, which
must be off to match the JAX package's fp32 products.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..serving.engine import resolve_device
from .safetensors_io import read_safetensors, write_safetensors

__all__ = [
    "SCORE_CHUNK",
    "ScoreEnsemble",
    "ScoreModelConfig",
    "WideScoreModel",
    "bradley_terry_prob",
    "ensemble_forward",
    "export_wide",
    "init_ensemble",
    "on_device",
    "params_from_jax",
]

# rows a chunk of WideScoreModel.score_batch: the (rows, E*d) fp32 hidden
# is 4.8 GB at E*d = 18,432
SCORE_CHUNK = 65536


@dataclasses.dataclass(frozen=True)
class ScoreModelConfig:
    d_emb: int = 1152
    n_hidden: int = 1
    n_ensemble: int = 16
    output_channels: int = 3
    dropout: float = 0.1


class _Stacked(nn.Module):
    """One dense layer of every member: ``w`` (E, d_in, d_out), ``b``
    (E, d_out)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class ScoreEnsemble(nn.Module):
    """The stacked ensemble; ``forward`` is :func:`ensemble_forward`."""

    def __init__(self, hidden, output):
        super().__init__()
        self.hidden = nn.ModuleList(_Stacked(w, b) for w, b in hidden)
        self.output = _Stacked(*output)

    @property
    def n_ensemble(self) -> int:
        return self.output.w.shape[0]

    @property
    def device(self) -> torch.device:
        return self.output.w.device

    def forward(
        self,
        x: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        dropout_rate: float = 0.0,
    ) -> torch.Tensor:
        e = self.n_ensemble
        if x.ndim == 2:
            x = x.expand(e, *x.shape)
        for layer in self.hidden:
            if generator is not None and dropout_rate > 0:
                keep = torch.rand(x.shape, generator=generator, device=x.device) < 1 - dropout_rate
                x = torch.where(keep, x / (1 - dropout_rate), 0.0)
            x = F.silu(torch.baddbmm(layer.b[:, None, :], x, layer.w))
        return torch.baddbmm(self.output.b[:, None, :], x, self.output.w)


def init_ensemble(
    cfg: ScoreModelConfig, generator: torch.Generator, device: str | torch.device = "cuda"
) -> ScoreEnsemble:
    """Stacked members: every weight N(0, 1/d_emb), biases 0, drawn from
    ``generator`` (which must live on ``device``)."""
    dev = resolve_device(device)
    e, d = cfg.n_ensemble, cfg.d_emb
    scale = (1.0 / d) ** 0.5

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev) * scale

    hidden = [(normal(e, d, d), torch.zeros(e, d, device=dev)) for _ in range(cfg.n_hidden)]
    output = (normal(e, d, cfg.output_channels), torch.zeros(e, cfg.output_channels, device=dev))
    return ScoreEnsemble(hidden, output)


def params_from_jax(tree, device: str | torch.device = "cuda") -> ScoreEnsemble:
    """The JAX package's stacked tree (``{"hidden": [{"w", "b"}, ...],
    "output": {"w", "b"}}``, numpy or jax arrays) as a module on
    ``device``."""
    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x, np.float32)).to(dev)

    return ScoreEnsemble(
        [(t(h["w"]), t(h["b"])) for h in tree["hidden"]],
        (t(tree["output"]["w"]), t(tree["output"]["b"])),
    )


def on_device(params: ScoreEnsemble, device: str | torch.device) -> ScoreEnsemble:
    """``params`` if it lives on ``device``, else a copy there (the
    caller's module is never moved)."""
    dev = resolve_device(device)
    if params.device.type == dev.type:
        return params
    return ScoreEnsemble(
        [(h.w.detach().to(dev), h.b.detach().to(dev)) for h in params.hidden],
        (params.output.w.detach().to(dev), params.output.b.detach().to(dev)),
    )


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def ensemble_forward(
    params: ScoreEnsemble,
    x,
    *,
    generator: Optional[torch.Generator] = None,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """x: (E, B, D) per-member batches or (B, D) broadcast, on the
    parameters' device -> (E, B, channels)."""
    return params(_as_tensor(x, params.device), generator, dropout_rate)


def bradley_terry_prob(
    params: ScoreEnsemble,
    pairs,
    *,
    generator: Optional[torch.Generator] = None,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """pairs: (E, B, 2, D) -> win probabilities (E, B, channels)
    (model.py:40-52). With dropout, each item of a pair draws its own
    masks (the JAX package folds its key for the second)."""
    pairs = _as_tensor(pairs, params.device)
    s1 = params(pairs[:, :, 0], generator, dropout_rate)
    s2 = params(pairs[:, :, 1], generator, dropout_rate)
    return torch.sigmoid(s1 - s2)


# ---------------------------------------------------------------------------
# Wide serving model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WideScoreModel:
    """Serving form (score_model.rs:4-32): one fused up/down projection."""

    up_proj: np.ndarray  # (E*d, d)
    bias: np.ndarray  # (E*d,)
    down_proj: np.ndarray  # (channels, E*d)

    @property
    def d_emb(self) -> int:
        return self.up_proj.shape[1]

    @property
    def scale(self) -> float:
        return self.d_emb / self.up_proj.shape[0]

    def score_batch(self, x, device: str | torch.device = "cuda") -> np.ndarray:
        """(B, d) numpy or tensor -> (B, channels) numpy:
        scale * down(silu(up @ x + bias)), on ``device``, ``SCORE_CHUNK``
        rows at a time (the result does not depend on the chunk)."""
        chunk = SCORE_CHUNK
        dev = resolve_device(device)
        up = torch.from_numpy(np.asarray(self.up_proj, np.float32)).to(dev)
        bias = torch.from_numpy(np.asarray(self.bias, np.float32)).to(dev)
        down = torch.from_numpy(np.asarray(self.down_proj, np.float32)).to(dev)
        n = len(x)
        out = torch.empty((n, down.shape[0]), dtype=torch.float32, device=dev)
        with torch.no_grad():
            for s in range(0, n, chunk):
                h = torch.addmm(bias, _as_tensor(x[s : s + chunk], dev), up.T)
                out[s : s + chunk] = self.scale * torch.mm(F.silu(h, inplace=True), down.T)
                del h  # before the next chunk's
        return out.cpu().numpy()

    def save_safetensors(self, path: str):
        write_safetensors(
            path,
            {
                "up_proj": np.asarray(self.up_proj, np.float32),
                "bias": np.asarray(self.bias, np.float32),
                "down_proj": np.asarray(self.down_proj, np.float32),
            },
        )

    @classmethod
    def load_safetensors(cls, path: str) -> "WideScoreModel":
        t = read_safetensors(path)
        return cls(
            up_proj=t["up_proj"].numpy(),
            bias=t["bias"].numpy(),
            down_proj=t["down_proj"].numpy(),
        )


def export_wide(params: ScoreEnsemble, cfg: ScoreModelConfig) -> WideScoreModel:
    """Ensemble -> wide model, with the reference's self-check: wide
    output must equal the ensemble mean (output biases zeroed) within
    1e-4 (ensemble_to_wide_model.py:57-68), both on the parameters'
    device."""
    if cfg.n_hidden != 1:
        raise ValueError("wide export defined for one hidden layer")
    e = cfg.n_ensemble
    d = cfg.d_emb

    hidden = params.hidden[0]
    up = hidden.w.detach().cpu().numpy().transpose(0, 2, 1).reshape(e * d, d)
    bias = hidden.b.detach().cpu().numpy().reshape(e * d)
    # down_proj[:, i*d:(i+1)*d] = member i output weights
    down_wide = np.zeros((cfg.output_channels, e * d), np.float32)
    wout = params.output.w.detach().cpu().numpy()  # (E, d, channels)
    for i in range(e):
        down_wide[:, i * d : (i + 1) * d] = wout[i].T

    wide = WideScoreModel(
        up_proj=up.astype(np.float32),
        bias=bias.astype(np.float32),
        down_proj=down_wide,
    )

    # golden self-check
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, d)).astype(np.float32)
    zeroed = {"output.b": torch.zeros_like(params.output.b)}
    with torch.no_grad():
        out = torch.func.functional_call(params, zeroed, (_as_tensor(x, params.device),))
    truth = out.mean(0).cpu().numpy()
    got = wide.score_batch(x, device=params.device)
    err = np.abs(got - truth).mean()
    if not err < 1e-4:
        raise AssertionError(f"wide export self-check failed: {err}")
    return wide
