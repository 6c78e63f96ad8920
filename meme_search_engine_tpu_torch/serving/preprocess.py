"""Host-side image decode + resize for the embedding service.

Copy of ``meme_search_engine_tpu/serving/preprocess.py``. Decode runs on
host CPU threads (PIL, imported where it is used); the resize filter
matches the reference client: Hamming for downscale, Lanczos for upscale.

SigLIP 2 NaFlex takes each picture at its own aspect ratio: the grid rule
of ``transformers``' ``Siglip2ImageProcessor``
(:func:`image_size_for_max_num_patches`, :func:`naflex_grid`) picks the
size, and :func:`decode_and_resize_naflex` resizes to it with the
processor's filter, PIL bilinear. A client that resizes before it sends
(ingest) takes :func:`shrink_for_naflex`.
"""

from __future__ import annotations

import io
import math
from functools import lru_cache
from typing import Tuple

import numpy as np

__all__ = ["decode_and_resize", "resize_for_embed", "image_size_for_max_num_patches",
           "naflex_grid", "decode_and_resize_naflex", "shrink_for_naflex"]


@lru_cache(maxsize=4096)
def image_size_for_max_num_patches(height: int, width: int, patch_size: int, max_num_patches: int,
                                   eps: float = 1e-5) -> Tuple[int, int]:
    """(height, width) in pixels, multiples of ``patch_size``, that a
    picture of ``height`` x ``width`` is resized to: the largest scale (a
    binary search to ``eps``) at which ceil(h s / P) * ceil(w s / P) <=
    ``max_num_patches``, each side at least one patch. As
    ``Siglip2ImageProcessor``'s ``get_image_size_for_max_num_patches``."""

    def scaled(scale: float, size: int) -> int:
        return int(max(patch_size, math.ceil(size * scale / patch_size) * patch_size))

    lo, hi = eps / 10, 100.0
    while hi - lo >= eps:
        scale = (lo + hi) / 2
        if (scaled(scale, height) / patch_size) * (scaled(scale, width) / patch_size) <= max_num_patches:
            lo = scale
        else:
            hi = scale
    return scaled(lo, height), scaled(lo, width)


def naflex_grid(height: int, width: int, patch_size: int, max_num_patches: int) -> Tuple[int, int]:
    """The picture's patch grid (h, w) by the processor's rule."""
    th, tw = image_size_for_max_num_patches(height, width, patch_size, max_num_patches)
    return th // patch_size, tw // patch_size


def decode_and_resize_naflex(data: bytes, patch_size: int, max_num_patches: int) -> np.ndarray:
    """Image bytes -> uint8 (P h, P w, 3) at the picture's NaFlex grid."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        return _resize_naflex(img.convert("RGB"), patch_size, max_num_patches)


def shrink_for_naflex(image: np.ndarray, patch_size: int, max_num_patches: int) -> np.ndarray:
    """uint8 (H, W, 3) array -> what a client sends a NaFlex server: the
    picture at its grid's size where that is fewer pixels, else the
    picture as it is. Either way the server's :func:`decode_and_resize_naflex`
    then gives the grid and the pixels the picture itself would get: a
    shrunk picture's scale is under 1, so the grid rule gives it its own
    size back, while a small picture would not come back from its grid
    (the rule's scale is capped at 100)."""
    from PIL import Image

    th, tw = image_size_for_max_num_patches(image.shape[0], image.shape[1], patch_size,
                                            max_num_patches)
    if th * tw >= image.shape[0] * image.shape[1]:
        return image
    return _resize_naflex(Image.fromarray(image), patch_size, max_num_patches)


def _resize_naflex(img, patch_size: int, max_num_patches: int) -> np.ndarray:
    """An RGB PIL image at its grid's size, resized as
    ``Siglip2ImageProcessor`` resizes (PIL bilinear); a picture at that
    size already is left as it is (the grid rule gives it its own size)."""
    from PIL import Image

    th, tw = image_size_for_max_num_patches(img.size[1], img.size[0], patch_size, max_num_patches)
    if img.size != (tw, th):
        img = img.resize((tw, th), Image.Resampling.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def decode_and_resize(data: bytes, size: Tuple[int, int]) -> np.ndarray:
    """Image bytes (any PIL-supported format) -> uint8 (H, W, 3)."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        img = img.convert("RGB")
        if img.size != (size[0], size[1]):
            img = _resize(img, size)
        return np.asarray(img, dtype=np.uint8)


def resize_for_embed(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 (H,W,3) array -> uint8 (size,size,3), reference filter rules."""
    from PIL import Image

    img = Image.fromarray(image)
    return np.asarray(_resize(img, size), dtype=np.uint8)


def _resize(img, size):
    from PIL import Image

    w, h = img.size
    filt = (
        Image.Resampling.HAMMING
        if (w > size[0] and h > size[1])
        else Image.Resampling.LANCZOS
    )
    return img.resize((size[0], size[1]), filt)
