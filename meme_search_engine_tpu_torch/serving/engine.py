"""Device-side embedding engine: bucketed batch inference on one device.

Counterpart of ``meme_search_engine_tpu/serving/engine.py``. Request
batches are split into descending power-of-two buckets (the same split as
the JAX engine, so a request maps to the same device batches and the same
kernel shapes); each bucket runs ``siglip.encode_image`` or
``siglip.encode_text`` on the engine's device and comes back as
L2-normalised fp32 numpy. Texts are tokenised on the host first
(``serving/tokenizer.py``).

The engine runs on ``cuda`` unless the caller asks for ``cpu``; asking for
CUDA on a host without it raises, it never falls back to the CPU. With
``mesh`` it is one process over a grid of devices, as the JAX engine is
one program over a (data x model) mesh. A list of devices is a column:
each device is a data replica that holds the weights, and a bucket that
divides evenly by the replica count runs split across them (JAX
``engine.py:115-121``); one that does not runs on the first. A list of
rows (``[["cuda:0", "cuda:1"], ...]``) has a replica a row; with
``model_parallel=True`` each row's devices are its model shards (the
JAX ``model_parallel``, which applies the Megatron layout of
``parallel/mesh.py``): each holds its column's slice of the blocks and of
the MAP head (``parallel/mesh.model_shards``) in the kernels' layouts, and
runs every kernel of a layer on its own heads and hidden slice
(``models/siglip.py``). Without it a row runs on its first device, as the
JAX engine's model axis then holds whole copies. One card serves a row of
two shards as ``[["cuda:0", "cuda:0"]]``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..models import siglip
from ..parallel.mesh import model_shards
from ..utils import profiling
from .tokenizer import load_tokenizer

__all__ = ["EmbeddingEngine", "pow2_buckets", "resolve_device"]


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
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _prepare(column: dict, device: torch.device, cfg: siglip.SigLIPConfig) -> dict:
    """One device's tree: each tower moved to ``device`` and put into the
    kernels' layouts, under an ``engine.prepare`` span a tower."""
    tree = {}
    for tower, sub in column.items():
        with profiling.span("engine.prepare", attrs={"tower": tower}):
            placed = _to(sub, device)
            if profiling.is_recording():
                profiling.count("bytes", _nbytes(placed))
            tree.update(siglip.prepare_params({tower: placed}, cfg))
    return tree


def _fetch(y: torch.Tensor) -> np.ndarray:
    """A bucket's embeddings on the host: waits for the device, then copies."""
    with profiling.span("engine.d2h"):
        out = y.cpu().numpy()
        profiling.count("bytes", out.nbytes)
        return out


def _join(trees: list) -> dict:
    """One row's tree from its model shards' prepared trees: the blocks
    and the MAP head as lists of the shards', every other leaf (and the
    text routes' ``layouts``) the first shard's."""
    return {
        tower: {**sub, **{k: [t[tower][k] for t in trees]
                          for k in ("blocks", "map_head") if k in sub}}
        for tower, sub in trees[0].items()
    }


class EmbeddingEngine:
    """Batched SigLIP inference, both towers, with power-of-two bucketing.

    Args:
      params: the port's SigLIP tree (``siglip.init_params``,
        ``siglip.load_hf_siglip`` or ``convert.params_from_numpy``); both
        towers are moved to ``device`` here and the image tower is put
        into the kernel layouts, once.
      cfg: model config.
      max_batch: largest single device batch.
      device: "cuda" (default) or "cpu".
      tokenizer_path: optional HF ``tokenizer.json`` (or its directory);
        without one, the hash tokenizer (``serving/tokenizer.py``).
      mesh: optional list of devices for data parallelism, or a list of
        rows of devices (replaces ``device``).
      model_parallel: each row's devices hold its model shards.
    """

    def __init__(
        self,
        params,
        cfg: siglip.SigLIPConfig = siglip.SO400M_14_384,
        max_batch: int = 128,
        device: str | torch.device = "cuda",
        tokenizer_path: Optional[str] = None,
        mesh: Optional[Sequence] = None,
        model_parallel: bool = False,
    ):
        with profiling.span("engine.init"):
            self.cfg = cfg
            self.max_batch = max_batch
            rows = [[device]] if not mesh else [
                list(r) if isinstance(r, (list, tuple)) else [r] for r in mesh
            ]
            if len({len(r) for r in rows}) != 1:
                raise ValueError(f"mesh rows differ in length: {mesh}")
            self.grid = [[resolve_device(d) for d in (r if model_parallel else r[:1])]
                         for r in rows]
            self.devices = [r[0] for r in self.grid]  # where each replica's batch lies
            self.device = self.devices[0]
            if any(d.type == "cuda" for r in self.grid for d in r):
                # the dense layers' bf16 GEMMs accumulate in fp32, split-K
                # partial sums included, as the reference's do (process-wide)
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
            towers = {k: params[k] for k in ("img", "txt")}
            n = len(self.grid[0])
            columns = model_shards(towers, n) if n > 1 else [towers]
            replicas = {}
            for r in self.grid:
                if tuple(r) not in replicas:
                    trees = [_prepare(c, d, cfg) for c, d in zip(columns, r)]
                    replicas[tuple(r)] = trees[0] if n == 1 else _join(trees)
            self._replicas = [replicas[tuple(r)] for r in self.grid]
            self.params = self._replicas[0]
            self.tokenizer = load_tokenizer(tokenizer_path, cfg.vocab_size, cfg.text_len)

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run every bucket of both towers once (builds the kernels on
        first use)."""
        r = self.cfg.image_size
        if buckets is None:
            buckets = [1 << i for i in range(self.max_batch.bit_length())]
        for b in buckets:
            self.embed_image_arrays(np.zeros((b, r, r, 3), np.uint8))
            self.embed_tokens(np.ones((b, self.cfg.text_len), np.int32))

    def _run(self, fn, replica: int, chunk: np.ndarray) -> torch.Tensor:
        device = self.devices[replica]
        with profiling.span("engine.h2d"):
            host = torch.from_numpy(np.ascontiguousarray(chunk))
            x = host.to(device)
            if profiling.is_recording():
                n = host.numel() * host.element_size()
                profiling.count("bytes", n)
                profiling.count("pageable_bytes", 0 if host.is_pinned() else n)
        with profiling.span("engine.launch"):
            if device.type == "cuda":
                with torch.cuda.device(device):
                    return fn(self._replicas[replica], x)
            return fn(self._replicas[replica], x)

    def _run_bucketed(self, fn: Callable[[dict, torch.Tensor], torch.Tensor], batch: np.ndarray) -> np.ndarray:
        """Spans: ``engine.call`` (counts ``rows``, ``buckets``) over one
        ``engine.bucket`` (``rows``) a bucket and replica, each holding its
        ``engine.h2d`` (``bytes``, ``pageable_bytes``), ``engine.launch``
        and ``engine.d2h`` (``bytes``). A bucket split across replicas
        fetches every replica's rows after all have launched, so there
        each ``engine.d2h`` lies under ``engine.call``."""
        n = batch.shape[0]
        nd = len(self.devices)
        out = np.empty((n, self.cfg.d_emb), dtype=np.float32)
        buckets = pow2_buckets(n, self.max_batch)
        with profiling.span("engine.call", rows=n, buckets=len(buckets)):
            i = 0
            for b in buckets:
                if nd > 1 and b % nd == 0:
                    # every device's share first, then the copies back
                    per = b // nd
                    parts = []
                    for r in range(nd):
                        with profiling.span("engine.bucket", rows=per):
                            parts.append(self._run(fn, r, batch[i + r * per : i + (r + 1) * per]))
                    out[i : i + b] = np.concatenate([_fetch(p) for p in parts])
                else:
                    with profiling.span("engine.bucket", rows=b):
                        out[i : i + b] = _fetch(self._run(fn, 0, batch[i : i + b]))
                i += b
        return out

    def embed_image_arrays(self, images: np.ndarray) -> np.ndarray:
        """uint8 (N,H,W,3) -> (N, d_emb) fp32 unit-norm embeddings.

        If H,W differ from the model resolution the resize runs on the
        device; float input in [-1,1] at the model resolution skips it.
        """
        pre = images.dtype != np.uint8
        return self._run_bucketed(
            lambda p, x: siglip.encode_image(p, x, self.cfg, preprocessed=pre), images
        )

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Strings -> (N, d_emb) fp32 unit-norm embeddings."""
        return self.embed_tokens(self.tokenizer(list(texts)))

    def embed_tokens(self, tokens: np.ndarray) -> np.ndarray:
        """Token ids (N, text_len) -> (N, d_emb) fp32 unit-norm embeddings."""
        return self._run_bucketed(
            lambda p, x: siglip.encode_text(p, x, self.cfg), tokens.astype(np.int32)
        )
