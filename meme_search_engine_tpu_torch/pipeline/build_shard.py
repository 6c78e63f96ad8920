"""Per-shard Vamana build (generate-index-shard equivalent).

Counterpart of ``meme_search_engine_tpu/pipeline/build_shard.py``
(src/generate_index_shard.rs:43-168): read a shard input file
(ShardInputHeader + ShardedRecords), append OOD query vectors after the
base data (query_breakpoint = n_base, :71-94), random-fill, run the build
passes, RobustStitch, and write raw adjacency + ShardHeader with per-node
offsets and the local->global id mapping.

The build from arrays is :func:`build_shard_graph`; :func:`build_shard`
reads the file, calls it and writes the result. The file formats need
``msgpack``; the build does not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..index import vamana
from .formats import ShardHeader, read_shard_input, write_shard_output

__all__ = ["build_shard", "build_shard_graph", "DEFAULT_R", "DEFAULT_L", "DEFAULT_MAXC"]

# reference defaults (generate_index_shard.rs:22-37)
DEFAULT_R = 64
DEFAULT_L = 192
DEFAULT_MAXC = 750


def build_shard_graph(
    base: np.ndarray,
    query_vectors: Optional[np.ndarray] = None,
    *,
    r: int = DEFAULT_R,
    l: int = DEFAULT_L,
    maxc: int = DEFAULT_MAXC,
    alpha: float = 1.0,
    query_alpha: float = 0.9,
    n_build_passes: int = 1,
    batch_size: int = 512,
    build_expand: int = 2,
    corpus_dtype: str = "bf16",
    seed: int = 0,
    pad_to: int = 0,
    verbose: bool = False,
    device="cuda",
) -> Tuple[np.ndarray, int]:
    """Build one shard's graph over ``base`` (n_base, D) fp32 with the OOD
    ``query_vectors`` appended; returns (graph (n_total, r) int32, -1
    padded and stitched, medioid < n_base)."""
    n_base = len(base)
    vectors = np.asarray(base, np.float32)
    if query_vectors is not None and len(query_vectors):
        vectors = np.concatenate([vectors, np.asarray(query_vectors, np.float32)])
    if pad_to:
        # Round the node count up to a multiple of pad_to with extra random
        # OOD query vectors (the JAX package buckets shard sizes so its
        # jitted kernels compile a handful of times). They ride the OOD
        # machinery, so the base adjacency is unaffected beyond normal
        # OOD-query side effects.
        short = -len(vectors) % pad_to
        if short:
            prng = np.random.default_rng(seed ^ 0x5EED)
            pad = prng.standard_normal((short, vectors.shape[1])).astype(np.float32)
            pad /= np.linalg.norm(pad, axis=1, keepdims=True)
            vectors = np.concatenate([vectors, pad])

    cfg = vamana.VamanaConfig(
        r=r, l=l, maxc=maxc, alpha=alpha, query_alpha=query_alpha,
        query_breakpoint=n_base, batch_size=batch_size,
        build_expand=build_expand, corpus_dtype=corpus_dtype,
    )
    # one device corpus for every pass, the stitch and the medioid
    corpus_dev = vamana._corpus_on_device(vectors, corpus_dtype, device)
    graph = vamana.random_fill(len(vectors), r, seed)
    for p in range(n_build_passes):
        graph = vamana.build_graph(
            vectors, cfg, seed=seed + p, graph=graph, verbose=verbose, corpus_dev=corpus_dev,
        )
    if len(vectors) > n_base:
        graph = vamana.robust_stitch(vectors, graph, cfg, corpus_dev=corpus_dev)
    return graph, vamana.medioid_dev(corpus_dev, n_base)


def build_shard(input_path: str, output_path: str, *, query_vectors: Optional[np.ndarray] = None,
                **build) -> ShardHeader:
    """Build the shard in ``input_path`` and write its graph file to
    ``output_path``; ``build`` takes :func:`build_shard_graph`'s keywords
    (the reference's defaults: R 64, L 192, maxc 750)."""
    header_in, records = read_shard_input(input_path)
    mapping = [rid for rid, _vec in records]
    base = np.stack([vec for _rid, vec in records]).astype(np.float32)
    graph, med = build_shard_graph(base, query_vectors, **build)
    n_base = len(base)
    adjacency = [row[row >= 0].astype(np.uint32) for row in graph[:n_base]]
    header = ShardHeader(
        id=header_in.id,
        max=n_base,
        centroid=header_in.centroid,
        medioid=int(med),
        offsets=[],  # filled by write_shard_output
        mapping=mapping,
    )
    write_shard_output(output_path, header, adjacency)
    return header
