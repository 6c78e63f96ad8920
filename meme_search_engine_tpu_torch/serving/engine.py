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

A SigLIP 2 NaFlex engine (``cfg.max_num_patches``) takes pictures at
their own sizes (:meth:`EmbeddingEngine.embed_image_list`). A bucket runs
in parts of ``NAFLEX_PART`` pictures: each part's pictures are packed on
host threads into one staging buffer (pinned on a card, kept for the
next call), a picture's pixels a row and the grids after them
(:func:`naflex_views`), go to the card in one copy and are launched
before the next part is packed.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..models import siglip
from ..parallel.mesh import model_shards
from ..utils import profiling
from .tokenizer import load_tokenizer

__all__ = ["EmbeddingEngine", "naflex_views", "pow2_buckets", "resolve_device"]

# host threads that copy a NaFlex bucket's pictures into its staging
# buffer, each a run of pictures (numpy's copies release the GIL)
PACK_THREADS = min(8, os.cpu_count() or 1)
# a NaFlex bucket runs in parts of this many pictures, each packed, copied
# in and launched in turn, so that the host packs a part while the card
# runs the one before it (only the first part's packing leaves it idle)
NAFLEX_PART = 64


def naflex_views(buf: torch.Tensor, width: int):
    """A NaFlex staging buffer, (B * (width + 8),) uint8 on the host or
    the card, as (pixels (B, width) uint8, grids (B, 2) int32): the
    pictures' rows, then their grids, so that one copy takes both."""
    b = buf.numel() // (width + 8)
    return buf[: b * width].view(b, width), buf[b * width:].view(torch.int32).view(b, 2)


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
            self._staging: dict = {}  # (rows, slot) -> a NaFlex packing buffer
            self._staging_lock = threading.Lock()
            self._pack_pool: Optional[ThreadPoolExecutor] = None

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run every bucket of both towers once (builds the kernels on
        first use); a NaFlex tower at a square grid of its budget."""
        r, p = self.cfg.image_size, self.cfg.patch_size
        side = int(np.sqrt(self.cfg.max_num_patches)) * p
        if buckets is None:
            buckets = [1 << i for i in range(self.max_batch.bit_length())]
        for b in buckets:
            if self.cfg.max_num_patches:
                self.embed_image_list([np.zeros((side, side, 3), np.uint8)] * b)
            else:
                self.embed_image_arrays(np.zeros((b, r, r, 3), np.uint8))
            self.embed_tokens(np.ones((b, self.cfg.text_len), np.int32))

    def _run(self, fn, replica: int, chunk, pack=None, slot=None) -> torch.Tensor:
        device = self.devices[replica]
        if pack is not None:
            with profiling.span("engine.pack"):
                host = pack(chunk, replica, slot)
        with profiling.span("engine.h2d"):
            if pack is None:
                host = torch.from_numpy(np.ascontiguousarray(chunk))
            x = host.to(device, non_blocking=host.is_pinned())
            if profiling.is_recording():
                n = host.numel() * host.element_size()
                profiling.count("bytes", n)
                profiling.count("pageable_bytes", 0 if host.is_pinned() else n)
        with profiling.span("engine.launch"):
            if device.type == "cuda":
                with torch.cuda.device(device):
                    return fn(self._replicas[replica], x)
            return fn(self._replicas[replica], x)

    def _run_bucketed(self, fn: Callable[..., torch.Tensor], batch, pack=None,
                      part: Optional[int] = None) -> np.ndarray:
        """Spans: ``engine.call`` (counts ``rows``, ``buckets``) over one
        ``engine.bucket`` (``rows``) a bucket and replica, each holding its
        ``engine.h2d`` (``bytes``, ``pageable_bytes``), ``engine.launch``
        and ``engine.d2h`` (``bytes``). A bucket split across replicas
        fetches every replica's rows after all have launched, so there
        each ``engine.d2h`` lies under ``engine.call``. ``pack(chunk,
        replica, slot)``, where given, makes the host tensor and the
        keywords of ``fn`` under an ``engine.pack`` span before
        ``engine.h2d``; else the chunk is the host array. With ``pack``, a
        replica's chunk runs in parts of ``part`` rows, each packed, copied
        and launched before the next is packed, then all fetched: ``slot``
        is (replica, the part's first row)."""
        n = len(batch)
        nd = len(self.devices)

        def launch(r: int, chunk) -> list:
            if pack is None:
                return [self._run(fn, r, chunk)]
            step = part or len(chunk)
            return [self._run(fn, r, chunk[k:k + step], pack, (r, k))
                    for k in range(0, len(chunk), step)]

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
                            parts += launch(r, batch[i + r * per : i + (r + 1) * per])
                    out[i : i + b] = np.concatenate([_fetch(p) for p in parts])
                else:
                    with profiling.span("engine.bucket", rows=b):
                        parts = launch(0, batch[i : i + b])
                        out[i : i + b] = np.concatenate([_fetch(p) for p in parts])
                i += b
        return out

    def embed_image_arrays(self, images: np.ndarray) -> np.ndarray:
        """uint8 (N,H,W,3) -> (N, d_emb) fp32 unit-norm embeddings.

        If H,W differ from the model resolution the resize runs on the
        device; float input in [-1,1] at the model resolution skips it.
        """
        pre = images.dtype != np.uint8
        if self.cfg.max_num_patches:
            if pre:
                raise ValueError("a NaFlex tower takes uint8 pictures")
            return self.embed_image_list(list(images))
        return self._run_bucketed(
            lambda p, x: siglip.encode_image(p, x, self.cfg, preprocessed=pre), images
        )

    def embed_image_list(self, pictures: Sequence[np.ndarray]) -> np.ndarray:
        """SigLIP 2 NaFlex: uint8 (P h_i, P w_i, 3) pictures, each already
        at its grid's size (``preprocess.naflex_grid``; h_i w_i <=
        ``max_num_patches``), -> (N, d_emb) fp32 unit-norm embeddings.

        The buckets and spans are :meth:`_run_bucketed`'s; a bucket runs
        in parts of ``NAFLEX_PART`` pictures, each part's pictures and
        grids packed into one buffer (:meth:`_pack_naflex`, under
        ``engine.pack``) and copied in once. A picture's embedding is the
        same in any batch."""
        if not self.cfg.max_num_patches:
            raise ValueError("embed_image_list needs a NaFlex config (max_num_patches > 0)")
        width = self.cfg.max_num_patches * self.cfg.patch_size ** 2 * 3

        def tower(p, x):
            pixels, grids = naflex_views(x, width)
            return siglip.encode_image(p, pixels, self.cfg, grids=grids)

        with self._staging_lock:
            return self._run_bucketed(tower, list(pictures), pack=self._pack_naflex,
                                      part=NAFLEX_PART)

    def _pack_naflex(self, pictures: Sequence[np.ndarray], replica: int, slot) -> torch.Tensor:
        """One part's pictures and grids into its staging buffer (one a
        ``slot`` and size, so that no buffer is written while its copy may
        be pending), laid out as :func:`naflex_views` reads it: row b of
        the pixels picture b's in C order, zero past them
        (``siglip.naflex_patchify`` takes it on the card), then the (B, 2)
        int32 grids. The copies run on ``PACK_THREADS`` host threads, a run
        of pictures each. Counts on ``engine.pack``: ``images``, ``grids``
        (distinct), ``patches`` (valid), ``rows`` (the padded rows the
        tower runs), ``bytes``."""
        p, rows = self.cfg.patch_size, self.cfg.max_num_patches
        b, width = len(pictures), rows * p * p * 3
        buf = self._staging.get((b, slot))
        if buf is None:
            pin = self.devices[replica].type == "cuda"
            buf = self._staging[(b, slot)] = torch.empty(b * (width + 8), dtype=torch.uint8,
                                                          pin_memory=pin)
        views = naflex_views(buf, width)
        out, grids = views[0].numpy(), views[1].numpy()
        pics = [np.asarray(pic) for pic in pictures]
        for j, pic in enumerate(pics):
            h, w = (pic.shape[0] // p, pic.shape[1] // p) if pic.ndim == 3 else (0, 0)
            if (pic.dtype != np.uint8 or pic.shape != (p * h, p * w, 3)
                    or not 0 < h * w <= rows):
                raise ValueError(f"picture {j}: {pic.dtype} {pic.shape}; a NaFlex picture is uint8 "
                                 f"(P h, P w, 3), P = {p}, 0 < h w <= {rows}")
            grids[j] = (h, w)

        def fill(lo: int) -> None:
            for j in range(lo, min(lo + step, b)):
                n = pics[j].size
                out[j, :n] = pics[j].reshape(-1)
                out[j, n:] = 0

        step = -(-b // PACK_THREADS)
        if step < b:
            if self._pack_pool is None:
                self._pack_pool = ThreadPoolExecutor(PACK_THREADS, thread_name_prefix="naflex-pack")
            list(self._pack_pool.map(fill, range(0, b, step)))
        else:
            fill(0)
        if profiling.is_recording():
            profiling.count("images", b)
            profiling.count("grids", len(np.unique(grids, axis=0)))
            profiling.count("patches", int(grids[:, 0].astype(np.int64) @ grids[:, 1]))
            profiling.count("rows", b * ((rows + 15) // 16) * 16)
            profiling.count("bytes", buf.numel())
        return buf

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Strings -> (N, d_emb) fp32 unit-norm embeddings."""
        return self.embed_tokens(self.tokenizer(list(texts)))

    def embed_tokens(self, tokens: np.ndarray) -> np.ndarray:
        """Token ids (N, text_len) -> (N, d_emb) fp32 unit-norm embeddings."""
        return self._run_bucketed(
            lambda p, x: siglip.encode_text(p, x, self.cfg), tokens.astype(np.int32)
        )
