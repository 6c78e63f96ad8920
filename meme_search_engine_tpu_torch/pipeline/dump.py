"""Scrape-dump files: zstd streams of msgpack-encoded ProcessedEntry.

Format parity with the reference dump files (src/common.rs:118-129
ProcessedEntry, reddit_dump.rs:252-260 writer): each entry is a msgpack
map {url, id, title, subreddit, author, timestamp, embedding (fp16 LE
bytes), metadata {mime_type, original_file_size, dimension, final_url}}
in one continuous zstd stream per output file.

Resume support mirrors reddit_dump.rs:269-301: readback of the highest-
sequence-number dump finds the newest timestamp already processed.

A copy of ``meme_search_engine_tpu/pipeline/dump.py``, which the port
keeps rather than imports, with one change: the writer stores its blocks
uncompressed, so it needs no ``zstandard``. The reader reads those, and
compressed dumps (the JAX package's, the reference's) through
``zstandard``; ``msgpack`` and ``zstandard`` are imported where they are
used.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Iterator, Optional, Tuple

import numpy as np

from ..utils.fp16 import decode_fp16_buffer, encode_fp16_buffer


@dataclasses.dataclass
class OriginalImageMetadata:
    mime_type: str
    original_file_size: int
    dimension: Tuple[int, int]
    final_url: str


@dataclasses.dataclass
class ProcessedEntry:
    url: str
    id: str
    title: str
    subreddit: str
    author: str
    timestamp: int
    embedding: np.ndarray  # (D,) f32 (fp16 on the wire)
    metadata: OriginalImageMetadata

    def to_dict(self) -> dict:
        return {
            "url": self.url,
            "id": self.id,
            "title": self.title,
            "subreddit": self.subreddit,
            "author": self.author,
            "timestamp": self.timestamp,
            "embedding": encode_fp16_buffer(self.embedding),
            "metadata": {
                "mime_type": self.metadata.mime_type,
                "original_file_size": self.metadata.original_file_size,
                "dimension": list(self.metadata.dimension),
                "final_url": self.metadata.final_url,
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ProcessedEntry":
        m = d["metadata"]
        return cls(
            url=d["url"],
            id=d["id"],
            title=d["title"],
            subreddit=d["subreddit"],
            author=d["author"],
            timestamp=d["timestamp"],
            embedding=decode_fp16_buffer(d["embedding"]),
            metadata=OriginalImageMetadata(
                mime_type=m["mime_type"],
                original_file_size=m["original_file_size"],
                dimension=tuple(m["dimension"]),
                final_url=m["final_url"],
            ),
        )


# zstd frame format (RFC 8878) for frames of stored blocks: the port writes
# them without the ``zstandard`` package, and any zstd decoder reads them
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_BLOCK = 1 << 17  # the largest block a 128 KiB window allows
# frame header: no content size, no checksum, no dictionary, not single
# segment; then the window descriptor, 2^(10 + 7) = 128 KiB
_STORED_FRAME_HEADER = _ZSTD_MAGIC + bytes([0x00, 7 << 3])
_RAW, _RLE = 0, 1


class _StoredFrameWriter:
    """One zstd frame of raw (uncompressed) blocks."""

    def __init__(self, f):
        self._f = f
        self._buf = bytearray()
        f.write(_STORED_FRAME_HEADER)

    def _block(self, data, last: bool):
        self._f.write((int(last) | _RAW << 1 | len(data) << 3).to_bytes(3, "little"))
        self._f.write(data)

    def write(self, data: bytes):
        self._buf += data
        if len(self._buf) >= _BLOCK:
            whole = len(self._buf) - len(self._buf) % _BLOCK
            view = memoryview(self._buf)
            for s in range(0, whole, _BLOCK):
                self._block(view[s : s + _BLOCK], False)
            view.release()
            del self._buf[:whole]

    def close(self):
        self._block(bytes(self._buf), True)
        self._buf = bytearray()


def _stored_frames(f) -> Optional[Iterator[bytes]]:
    """The payload of a file of zstd frames whose blocks are all raw or
    RLE, block by block; None if any block is compressed (that needs a zstd
    decoder). The first pass reads only the headers."""

    def blocks(decode: bool):
        f.seek(0)
        while True:
            magic = f.read(4)
            if not magic:
                return
            if len(magic) == 4 and 0x184D2A50 <= int.from_bytes(magic, "little") <= 0x184D2A5F:
                f.seek(int.from_bytes(f.read(4), "little"), 1)  # skippable frame
                continue
            if magic != _ZSTD_MAGIC:
                raise ValueError(f"{getattr(f, 'name', 'dump')}: not a zstd frame")
            desc = f.read(1)[0]
            fcs_flag, single, checksum, dict_flag = desc >> 6, desc >> 5 & 1, desc >> 2 & 1, desc & 3
            skip = (0 if single else 1) + (0, 1, 2, 4)[dict_flag] + (single, 2, 4, 8)[fcs_flag]
            f.seek(skip, 1)
            while True:
                head = int.from_bytes(f.read(3), "little")
                last, kind, size = head & 1, head >> 1 & 3, head >> 3
                if kind == _RAW:
                    if decode:
                        yield f.read(size)
                    else:
                        f.seek(size, 1)
                elif kind == _RLE:
                    byte = f.read(1)
                    if decode:
                        yield byte * size
                else:
                    yield None
                    return
                if last:
                    break
            if checksum:
                f.seek(4, 1)

    if any(b is None for b in blocks(False)):
        return None
    return blocks(True)


class DumpWriter:
    """Entries as one zstd frame of stored (uncompressed) blocks of msgpack
    maps: it needs no ``zstandard`` package, any zstd reader reads it, and
    the fp16 embeddings that fill a dump barely compress (the JAX package
    writes level 8)."""

    def __init__(self, path: str):
        import msgpack

        self._packb = msgpack.packb
        self._f = open(path, "wb")
        self._out = _StoredFrameWriter(self._f)

    def write(self, entry: ProcessedEntry):
        self._out.write(self._packb(entry.to_dict()))

    def close(self):
        self._out.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_dump(path: str) -> Iterator[ProcessedEntry]:
    """Stream entries until EOF (dump_processor.rs:118-131 reader). Frames
    of stored blocks are read here; compressed ones need ``zstandard``."""
    import msgpack

    with open(path, "rb") as f:
        stored = _stored_frames(f)
        unpacker = msgpack.Unpacker(raw=False)
        if stored is None:
            import zstandard

            f.seek(0)
            unpacker = msgpack.Unpacker(zstandard.ZstdDecompressor().stream_reader(f), raw=False)
            for obj in unpacker:
                yield ProcessedEntry.from_dict(obj)
            return
        for data in stored:
            unpacker.feed(data)
            for obj in unpacker:
                yield ProcessedEntry.from_dict(obj)


_SEQ_RE = re.compile(r"(\d+)\.dump\.zst$")


def latest_timestamp(dump_dir: str) -> Optional[int]:
    """Max timestamp in the highest-seqnum dump (scraper resume,
    reddit_dump.rs:269-301)."""
    best_seq, best_path = -1, None
    for name in os.listdir(dump_dir):
        m = _SEQ_RE.search(name)
        if m and int(m.group(1)) > best_seq:
            best_seq, best_path = int(m.group(1)), os.path.join(dump_dir, name)
    if best_path is None:
        return None
    ts = None
    for entry in read_dump(best_path):
        ts = max(ts or 0, entry.timestamp)
    return ts
