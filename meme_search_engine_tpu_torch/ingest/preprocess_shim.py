"""Ingest-side resize helper (client-resize semantics, common.rs:31-54).

The reference's ingest resizes to the exact model input before shipping
BMPs to the embedding server (Hamming down / Lanczos up). Thin re-export
so ingest code doesn't import the serving package directly.

A copy of ``meme_search_engine_tpu/ingest/preprocess_shim.py``, over the
port's ``serving/preprocess.py``.
"""

from ..serving.preprocess import resize_for_embed as _resize


def resize_for_embed(image, image_size):
    return _resize(image, tuple(image_size))
