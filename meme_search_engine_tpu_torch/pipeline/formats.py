"""On-disk index formats for the large-scale (1e8+) pipeline.

A copy of ``meme_search_engine_tpu/pipeline/formats.py``, which the port
keeps rather than imports; ``msgpack`` is imported inside the functions
that use it, so the module imports on a host without it.

Structural parity with the reference's artifact set
(src/common.rs:131-174, src/dump_processor.rs:463-569):

  index.msgpack            IndexHeader {shards: [(centroid, global
                           medioid id)...], count, dead_count,
                           record_pad_size, quantizer, descriptor_cdfs}
                           (dump_processor.rs:262,558-569 — the u32 per
                           shard is the shard medioid's global id, used
                           as the beam-search entry point)
  index.bin                fixed-size records, one per node, padded to
                           record_pad_size (4096 B = one NVMe sector,
                           dump_processor.rs:135) so a node read is one
                           aligned IO
  index.pq-codes.bin       N x n_chunks u8 OPQ codes, mmap-able
  index.descriptor-codes.bin  N x n_descriptors u8 CDF buckets

Record payloads are msgpack maps (the reference uses Rust ``bitcode``,
a Rust-only format; msgpack keeps every field readable from any
language) with the same fields as PackedIndexEntry (common.rs:154-164):
vector (fp16 LE bytes), vertices, id, timestamp, dimensions, scores,
url, shards. A record whose payload exceeds the pad size loses its URL
but keeps its graph role ("dead" nodes, dump_processor.rs:510-517).

Shard intermediates (common.rs:131-152): ShardInputHeader, ShardedRecord
(id + fp16 vector), ShardHeader {id, max, centroid, medioid, offsets,
mapping}.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterator, List, Tuple

import numpy as np

from ..utils.fp16 import decode_fp16_buffer, encode_fp16_buffer

RECORD_PAD_SIZE = 4096  # dump_processor.rs:135


@dataclasses.dataclass
class PackedIndexEntry:
    id: int
    vector: np.ndarray  # (D,) f32 (stored fp16)
    vertices: List[int]  # merged out-edges
    timestamp: int
    dimensions: Tuple[int, int]
    scores: List[float]  # quality-model channels
    url: str
    shards: List[int]

    def pack(self, pad_size: int = RECORD_PAD_SIZE) -> bytes:
        return self.pack_ex(pad_size)[0]

    def pack_ex(self, pad_size: int = RECORD_PAD_SIZE) -> Tuple[bytes, bool]:
        """-> (record bytes, dead) where dead means the URL was dropped
        to fit the pad size (dump_processor.rs:510-517). Returning the
        flag avoids an unpack round-trip per record at pack time (the
        1e7 pack writes 1e7 records on one core)."""
        import msgpack

        body = {
            "id": self.id,
            "vector": encode_fp16_buffer(self.vector),
            "vertices": [int(v) for v in self.vertices],
            "timestamp": int(self.timestamp),
            "dimensions": list(self.dimensions),
            "scores": [float(s) for s in self.scores],
            "url": self.url,
            "shards": [int(s) for s in self.shards],
        }
        raw = msgpack.packb(body)
        dead = False
        if len(raw) + 4 > pad_size:
            # oversize: keep graph role, drop the payload URL ("dead",
            # dump_processor.rs:510-517)
            body["url"] = ""
            raw = msgpack.packb(body)
            dead = bool(self.url)
            if len(raw) + 4 > pad_size:
                raise ValueError("record exceeds pad size even without URL")
        return (
            struct.pack("<I", len(raw))
            + raw
            + b"\0" * (pad_size - 4 - len(raw)),
            dead,
        )

    @classmethod
    def unpack(cls, record: bytes) -> "PackedIndexEntry":
        import msgpack

        (length,) = struct.unpack_from("<I", record, 0)
        body = msgpack.unpackb(record[4 : 4 + length], raw=False)
        return cls(
            id=body["id"],
            vector=decode_fp16_buffer(body["vector"]),
            vertices=body["vertices"],
            timestamp=body["timestamp"],
            dimensions=tuple(body["dimensions"]),
            scores=body["scores"],
            url=body["url"],
            shards=body["shards"],
        )


@dataclasses.dataclass
class IndexHeader:
    shards: List[Tuple[List[float], int]]  # (centroid, global medioid id)
    count: int
    dead_count: int
    record_pad_size: int
    quantizer: dict  # ProductQuantizer msgpack dict
    descriptor_cdfs: List[List[float]]

    def save(self, path: str):
        import msgpack

        with open(path, "wb") as f:
            f.write(
                msgpack.packb(
                    {
                        "shards": [
                            [list(map(float, c)), int(n)] for c, n in self.shards
                        ],
                        "count": self.count,
                        "dead_count": self.dead_count,
                        "record_pad_size": self.record_pad_size,
                        "quantizer": self.quantizer,
                        "descriptor_cdfs": self.descriptor_cdfs,
                    }
                )
            )

    @classmethod
    def load(cls, path: str) -> "IndexHeader":
        import msgpack

        with open(path, "rb") as f:
            d = msgpack.unpackb(f.read(), raw=False)
        return cls(
            shards=[(c, n) for c, n in d["shards"]],
            count=d["count"],
            dead_count=d["dead_count"],
            record_pad_size=d["record_pad_size"],
            quantizer=d["quantizer"],
            descriptor_cdfs=d["descriptor_cdfs"],
        )


# -- shard build intermediates ---------------------------------------------


@dataclasses.dataclass
class ShardInputHeader:
    id: int
    centroid: List[float]


@dataclasses.dataclass
class ShardHeader:
    """Per-shard build output (common.rs:144-152): ``mapping`` maps
    shard-local ids back to global ids; ``offsets`` index the adjacency
    blob."""

    id: int
    max: int
    centroid: List[float]
    medioid: int
    offsets: List[int]
    mapping: List[int]


def write_shard_input(
    path: str, header: ShardInputHeader, records: Iterator[Tuple[int, np.ndarray]]
):
    """Stream ShardedRecords (id + fp16 vector) to a shard input file."""
    import msgpack

    with open(path, "wb") as f:
        f.write(
            msgpack.packb(
                {"id": header.id, "centroid": [float(x) for x in header.centroid]}
            )
        )
        for rid, vec in records:
            f.write(
                msgpack.packb(
                    {"id": int(rid), "vector": encode_fp16_buffer(vec)}
                )
            )


def read_shard_input(path: str):
    """-> (ShardInputHeader, [(id, vector f32)...])."""
    import msgpack

    with open(path, "rb") as f:
        unpacker = msgpack.Unpacker(f, raw=False)
        head = next(unpacker)
        header = ShardInputHeader(id=head["id"], centroid=head["centroid"])
        records = [
            (r["id"], decode_fp16_buffer(r["vector"])) for r in unpacker
        ]
    return header, records


def write_shard_output(
    path: str, header: ShardHeader, adjacency: List[np.ndarray]
):
    """Adjacency u32 blob + trailing msgpack header with offsets
    (generate_index_shard.rs:139-163 layout: raw vertices then header)."""
    import msgpack

    with open(path, "wb") as f:
        offsets = []
        pos = 0
        for row in adjacency:
            row = np.asarray(row, np.uint32)
            offsets.append(pos)
            f.write(row.tobytes())
            pos += row.nbytes
        offsets.append(pos)
        header_bytes = msgpack.packb(
            {
                "id": header.id,
                "max": header.max,
                "centroid": [float(x) for x in header.centroid],
                "medioid": int(header.medioid),
                "offsets": offsets,
                "mapping": [int(m) for m in header.mapping],
            }
        )
        f.write(header_bytes)
        f.write(struct.pack("<Q", len(header_bytes)))


def read_shard_output(path: str):
    """-> (ShardHeader, adjacency list of np.uint32 arrays)."""
    import msgpack

    with open(path, "rb") as f:
        data = f.read()
    (hlen,) = struct.unpack_from("<Q", data, len(data) - 8)
    head = msgpack.unpackb(data[len(data) - 8 - hlen : len(data) - 8], raw=False)
    header = ShardHeader(
        id=head["id"],
        max=head["max"],
        centroid=head["centroid"],
        medioid=head["medioid"],
        offsets=head["offsets"],
        mapping=head["mapping"],
    )
    adjacency = []
    offs = header.offsets
    for i in range(len(offs) - 1):
        adjacency.append(
            np.frombuffer(data[offs[i] : offs[i + 1]], np.uint32)
        )
    return header, adjacency
