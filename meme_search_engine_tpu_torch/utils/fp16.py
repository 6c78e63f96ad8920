"""fp16 little-endian wire codecs.

The reference exchanges embeddings as raw little-endian float16 buffers
everywhere (reference: src/common.rs:98-108 decode_fp16_buffer,
clip_server.py:163 ``.astype(np.float16).tobytes()``). We keep that wire
format exactly.
"""

from __future__ import annotations

import numpy as np


def decode_fp16_buffer(buf: bytes) -> np.ndarray:
    """Raw LE fp16 bytes -> float32 ndarray (reference: common.rs:98-102)."""
    return np.frombuffer(buf, dtype="<f2").astype(np.float32)


def encode_fp16_buffer(vec: np.ndarray) -> bytes:
    """float array -> raw LE fp16 bytes (reference: clip_server.py:163)."""
    return np.asarray(vec).astype("<f2").tobytes()
