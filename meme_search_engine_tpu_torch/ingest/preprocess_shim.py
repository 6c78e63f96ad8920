"""Ingest-side resize helper (client-resize semantics, common.rs:31-54).

The reference's ingest resizes to the exact model input before shipping
BMPs to the embedding server (Hamming down / Lanczos up). Thin re-export
so ingest code doesn't import the serving package directly;
``prepare_for_embed`` picks the resize by the server's config.

A copy of ``meme_search_engine_tpu/ingest/preprocess_shim.py``, over the
port's ``serving/preprocess.py``.
"""

from ..serving.preprocess import resize_for_embed as _resize
from ..serving.preprocess import shrink_for_naflex


def resize_for_embed(image, image_size):
    return _resize(image, tuple(image_size))


def prepare_for_embed(image, config):
    """A decoded picture as the embedding server described by ``config``
    (``InferenceServerConfig``) takes it: at ``image_size``, or for a
    SigLIP 2 NaFlex server at its own aspect ratio, shrunk to its grid
    where that is fewer pixels (``shrink_for_naflex``)."""
    if config.max_num_patches:
        return shrink_for_naflex(image, config.patch_size, config.max_num_patches)
    return resize_for_embed(image, config.image_size)
