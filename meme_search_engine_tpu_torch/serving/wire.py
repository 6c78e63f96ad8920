"""Wire contracts shared by all services.

Two API surfaces, kept byte-compatible with the reference so that the
reference's frontend (clipfront2) and clients interoperate:

1. Embedding service (msgpack over HTTP):
   - POST /        {"images": [bytes...]} | {"text": [str...]}
                   -> [fp16 LE bytes, ...]           (clip_server.py:151-170)
   - GET  /config  {"model", "batch", "image_size", "embedding_size"}
                                                     (clip_server.py:176-183);
                   a NaFlex server adds "patch_size" and
                   "max_num_patches", with "image_size" null
   - GET  /        204 health                        (clip_server.py:185-187)
   - GET  /metrics Prometheus text                   (clip_server.py:189-191)

2. Query service (JSON over HTTP):
   - POST /  QueryRequest {terms: [QueryTerm], k, include_video,
             debug_enabled}                          (common.rs:192-209)
     QueryTerm {embedding?, image?(base64), text?, predefined_embedding?,
             weight?}
     -> QueryResult {matches: [(score, file, thumb_hash_key,
             format_bitmask, (w,h)?, debug?)], formats, extensions}
                                                     (common.rs:185-190)
   - GET  /  FrontendInit {n_total, predefined_embedding_names, d_emb}
                                                     (common.rs:176-181)

A copy of ``meme_search_engine_tpu/serving/wire.py``, which the port keeps rather
than imports.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.fp16 import decode_fp16_buffer, encode_fp16_buffer

__all__ = [
    "InferenceServerConfig",
    "QueryTerm",
    "QueryRequest",
    "QueryResult",
    "FrontendInit",
    "parse_query_request",
    "query_result_to_json",
    "frontend_init_to_json",
    "decode_fp16_buffer",
    "encode_fp16_buffer",
]


@dataclass
class InferenceServerConfig:
    """GET /config payload of the embedding server (common.rs:24-29).

    A SigLIP 2 NaFlex server takes pictures at their own sizes: it sends
    ``patch_size`` and ``max_num_patches`` as well, and ``image_size``
    None, since there is no one size to resize to (a client shrinks each
    picture by ``preprocess.shrink_for_naflex``). Other servers send the
    reference's four keys only."""

    batch: int
    image_size: Optional[Tuple[int, int]]
    embedding_size: int
    model: Any = None
    patch_size: int = 0
    max_num_patches: int = 0

    def to_msgpack_dict(self) -> dict:
        d = {
            "model": self.model,
            "batch": self.batch,
            "image_size": None if self.image_size is None else tuple(self.image_size),
            "embedding_size": self.embedding_size,
        }
        if self.max_num_patches:
            d.update(patch_size=self.patch_size, max_num_patches=self.max_num_patches)
        return d

    @classmethod
    def from_msgpack_dict(cls, d: dict) -> "InferenceServerConfig":
        size = d["image_size"]
        return cls(
            batch=d["batch"],
            image_size=None if size is None else tuple(size),
            embedding_size=d["embedding_size"],
            model=d.get("model"),
            patch_size=int(d.get("patch_size", 0)),
            max_num_patches=int(d.get("max_num_patches", 0)),
        )


@dataclass
class QueryTerm:
    """One weighted query term (common.rs:192-199)."""

    embedding: Optional[List[float]] = None
    image: Optional[str] = None  # base64-encoded image bytes
    text: Optional[str] = None
    predefined_embedding: Optional[str] = None
    weight: Optional[float] = None


@dataclass
class QueryRequest:
    """POST / body of both search backends (common.rs:201-209)."""

    terms: List[QueryTerm]
    k: Optional[int] = None
    include_video: bool = False
    debug_enabled: bool = False


@dataclass
class QueryResult:
    """Search response (common.rs:185-190).

    matches: (score, file, thumb_hash_key, format_bitmask, (w,h)?, debug?)
    """

    matches: List[Tuple]
    formats: List[str] = field(default_factory=list)
    extensions: Dict[str, str] = field(default_factory=dict)


@dataclass
class FrontendInit:
    """GET / response of search backends (common.rs:176-181)."""

    n_total: int
    predefined_embedding_names: List[str]
    d_emb: int


def parse_query_request(body: dict) -> QueryRequest:
    terms = [
        QueryTerm(
            embedding=t.get("embedding"),
            image=t.get("image"),
            text=t.get("text"),
            predefined_embedding=t.get("predefined_embedding"),
            weight=t.get("weight"),
        )
        for t in body.get("terms", [])
    ]
    return QueryRequest(
        terms=terms,
        k=body.get("k"),
        include_video=bool(body.get("include_video", False)),
        debug_enabled=bool(body.get("debug_enabled", False)),
    )


def query_result_to_json(result: QueryResult) -> dict:
    return {
        "matches": [list(m) for m in result.matches],
        "formats": result.formats,
        "extensions": result.extensions,
    }


def frontend_init_to_json(init: FrontendInit) -> dict:
    return {
        "n_total": init.n_total,
        "predefined_embedding_names": init.predefined_embedding_names,
        "d_emb": init.d_emb,
    }


def fuse_terms(
    terms: Sequence[QueryTerm],
    d_emb: int,
    *,
    embed_text,
    embed_images,
    predefined_embeddings: Optional[Dict[str, np.ndarray]] = None,
    decode_image=None,
) -> np.ndarray:
    """Weighted multi-term query fusion (common.rs:215-274 get_total_embedding).

    Sums weight x embedding over all terms. ``embed_text(list[str])`` and
    ``embed_images(list[bytes])`` return arrays of shape (n, d_emb); raw
    embedding terms and predefined (named) embeddings are added directly.
    Negative weights are supported (sign x slider value in the frontend,
    App.svelte:273).
    """
    import base64

    predefined_embeddings = predefined_embeddings or {}
    total = np.zeros((d_emb,), dtype=np.float32)

    image_batch: List[bytes] = []
    image_weights: List[float] = []
    text_batch: List[str] = []
    text_weights: List[float] = []

    for term in terms:
        w = 1.0 if term.weight is None else float(term.weight)
        if term.image is not None:
            raw = base64.b64decode(term.image)
            if decode_image is not None:
                raw = decode_image(raw)
            image_batch.append(raw)
            image_weights.append(w)
        if term.text is not None:
            text_batch.append(term.text)
            text_weights.append(w)
        if term.embedding is not None:
            total += np.asarray(term.embedding, dtype=np.float32) * w
        if term.predefined_embedding is not None:
            emb = predefined_embeddings.get(term.predefined_embedding)
            if emb is not None:
                total += np.asarray(emb, dtype=np.float32) * w

    if image_batch:
        embs = np.asarray(embed_images(image_batch), dtype=np.float32)
        total += np.einsum("nd,n->d", embs, np.asarray(image_weights, np.float32))
    if text_batch:
        embs = np.asarray(embed_text(text_batch), dtype=np.float32)
        total += np.einsum("nd,n->d", embs, np.asarray(text_weights, np.float32))

    return total
