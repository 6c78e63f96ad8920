"""Device-side embedding engine: bucketed batch inference on one device.

Counterpart of ``meme_search_engine_tpu/serving/engine.py``. Request
batches are split into descending power-of-two buckets (the same split as
the JAX engine, so a request maps to the same device batches and the same
kernel shapes); each bucket runs ``siglip.encode_image`` on the engine's
device and comes back as L2-normalised fp32 numpy.

The engine runs on ``cuda`` unless the caller asks for ``cpu``; asking for
CUDA on a host without it raises, it never falls back to the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models import siglip

__all__ = ["EmbeddingEngine", "pow2_buckets", "resolve_device"]

_TEXT_NOT_PORTED = (
    "text embedding is not ported yet: encode_text and its attention kernel "
    "come with the next slice (ROADMAP.md, queue 1 item 4)"
)


def pow2_buckets(n: int, max_batch: int) -> List[int]:
    """Greedy descending power-of-two decomposition of n (≤ max_batch each)."""
    out = []
    while n > 0:
        b = 1 << (n.bit_length() - 1)
        b = min(b, 1 << (max_batch.bit_length() - 1))
        out.append(b)
        n -= b
    return out


def resolve_device(device: str | torch.device) -> torch.device:
    """The requested device; raises if it is CUDA and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain CPU path"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


class EmbeddingEngine:
    """Batched SigLIP image inference with power-of-two bucketing.

    Args:
      params: the port's SigLIP tree (``siglip.init_params`` or
        ``convert.params_from_numpy``); its image tower is moved to
        ``device`` and put into the kernel layouts here, once.
      cfg: model config.
      max_batch: largest single device batch.
      device: "cuda" (default) or "cpu".
    """

    def __init__(
        self,
        params,
        cfg: siglip.SigLIPConfig = siglip.SO400M_14_384,
        max_batch: int = 128,
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.max_batch = max_batch
        self.device = resolve_device(device)
        img = _to(params["img"], self.device)
        self.params = siglip.prepare_params({"img": img}, cfg)

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run every bucket once (builds the kernels on first use)."""
        r = self.cfg.image_size
        if buckets is None:
            buckets = [1 << i for i in range(self.max_batch.bit_length())]
        for b in buckets:
            self.embed_image_arrays(np.zeros((b, r, r, 3), np.uint8))

    def _run_bucketed(self, batch: np.ndarray, pre: bool) -> np.ndarray:
        n = batch.shape[0]
        out = np.empty((n, self.cfg.d_emb), dtype=np.float32)
        i = 0
        for b in pow2_buckets(n, self.max_batch):
            chunk = torch.from_numpy(np.ascontiguousarray(batch[i : i + b]))
            emb = siglip.encode_image(
                self.params, chunk.to(self.device), self.cfg, preprocessed=pre
            )
            out[i : i + b] = emb.cpu().numpy()
            i += b
        return out

    def embed_image_arrays(self, images: np.ndarray) -> np.ndarray:
        """uint8 (N,H,W,3) -> (N, d_emb) fp32 unit-norm embeddings.

        If H,W differ from the model resolution the resize runs on the
        device; float input in [-1,1] at the model resolution skips it.
        """
        return self._run_bucketed(images, images.dtype != np.uint8)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        raise NotImplementedError(_TEXT_NOT_PORTED)

    def embed_tokens(self, tokens: np.ndarray) -> np.ndarray:
        raise NotImplementedError(_TEXT_NOT_PORTED)
