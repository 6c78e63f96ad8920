"""Item identity codec: plain files and synthetic video frames.

The reference models item identity as ``Filename::Actual(String) |
VideoFrame(String, u64)`` and encodes it into the SQLite key as raw
UTF-8, or msgpack prefixed with a 0x00 byte for video frames
(src/main.rs:167-199). We keep the same encoded representation so
databases are interchangeable.

A copy of ``meme_search_engine_tpu/ingest/filename.py``, which the port
keeps rather than imports. ``msgpack`` is imported in the video-frame
branches only, so plain file names encode on a host without it; the
bytes are the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

__all__ = ["Actual", "VideoFrame", "encode_filename", "decode_filename", "container_of"]


@dataclass(frozen=True)
class Actual:
    path: str


@dataclass(frozen=True)
class VideoFrame:
    container: str
    frame: int


Filename = Union[Actual, VideoFrame]


def encode_filename(f: Filename) -> bytes:
    if isinstance(f, Actual):
        encoded = f.path.encode("utf-8")
        if encoded[:1] == b"\x00":
            raise ValueError("filename may not start with NUL")
        return encoded
    import msgpack

    return b"\x00" + msgpack.packb({"VideoFrame": [f.container, f.frame]})


def decode_filename(raw: bytes) -> Filename:
    if raw[:1] == b"\x00":
        import msgpack

        obj = msgpack.unpackb(raw[1:], raw=False)
        container, frame = obj["VideoFrame"]
        return VideoFrame(container, int(frame))
    return Actual(raw.decode("utf-8"))


def container_of(f: Filename) -> str:
    """Grouping key for video-frame dedup (main.rs:906-917)."""
    return f.container if isinstance(f, VideoFrame) else f.path
