"""Host-side image decode + resize for the embedding service.

Copy of ``meme_search_engine_tpu/serving/preprocess.py``. Decode runs on
host CPU threads (PIL, imported where it is used); the resize filter
matches the reference client: Hamming for downscale, Lanczos for upscale.
"""

from __future__ import annotations

import io
from typing import Tuple

import numpy as np

__all__ = ["decode_and_resize", "resize_for_embed"]


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
