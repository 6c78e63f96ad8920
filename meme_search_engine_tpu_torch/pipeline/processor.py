"""Batch dump processor: the swiss-army tool over scrape dumps.

Capability parity with src/dump_processor.rs: sampling, SimHash + URL
dedup over 2^20-entry rings (:376-391, binarize :109-115), embedding-
threshold filtering with histogram output (:163-183), balanced 2-way
spill shard split (:438-461), and the final index pack — merged <=2-shard
adjacency, OPQ codes, quality-model scores, CDF descriptor bucketing,
4096-byte records (:463-569).

Counterpart of ``meme_search_engine_tpu/pipeline/processor.py``: numpy
over the port's ``ProductQuantizer`` and file formats. The pack's OPQ
encode runs on the card (``device``, "cuda" unless the caller asks for
the CPU), one batch ahead of the host's record loop; the split's centroid
dots, the dedup and the file IO stay on the host, as in the JAX package.
Records are packed by the shared native packer (native/pack.cpp), which
writes ``PackedIndexEntry.pack_ex``'s bytes; the pack takes the adjacency
padded (:class:`PaddedAdjacency`, the merge's output) and manifest rows of
two dimensions.

One difference from the JAX package: a replayed shard assignment that no
built graph verified is never persisted or used unless the caller passes
``allow_unverified=True``, whatever ``verify_built`` says (the JAX
function takes ``verify_built=False`` as leave to skip that check).
"""

from __future__ import annotations

import collections
import hashlib
import os
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..index.opq import ProductQuantizer
from .dump import ProcessedEntry, read_dump
from .formats import RECORD_PAD_SIZE, IndexHeader

DEDUP_RING_SIZE = 1 << 20  # dump_processor.rs ring capacity
SHARD_SPILL = 2  # dump_processor.rs:134


def simhash(embedding: np.ndarray) -> int:
    """1-bit-per-dimension sign signature hashed to u64
    (dump_processor.rs:109-115 binarize; hash function differs — the
    reference uses seahash, we use blake2 — the dedup semantics only
    need a stable 64-bit digest of the sign pattern)."""
    bits = np.packbits((np.asarray(embedding) > 0).astype(np.uint8))
    return int.from_bytes(
        hashlib.blake2b(bits.tobytes(), digest_size=8).digest(), "little"
    )


def url_hash(url: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(url.encode(), digest_size=8).digest(), "little"
    )


def simhash_batch(embeddings: np.ndarray) -> List[int]:
    """Vectorised :func:`simhash` over a (B, D) batch: one packbits pass
    for the whole batch, then a short digest per row. The per-record
    variant costs ~2 numpy allocations per call — at 1e7 stream scale
    that is the difference between minutes and hours."""
    bits = np.packbits(np.asarray(embeddings) > 0, axis=1)
    return [
        int.from_bytes(
            hashlib.blake2b(row.tobytes(), digest_size=8).digest(), "little"
        )
        for row in bits
    ]


class DedupRing:
    """Sliding-window duplicate filter: embedding SimHash + final-URL
    hash, each over a 2^20 ring (dump_processor.rs:376-391)."""

    def __init__(self, capacity: int = DEDUP_RING_SIZE):
        self.capacity = capacity
        self._ring: collections.deque = collections.deque()
        self._url_ring: collections.deque = collections.deque()
        self._set: set = set()
        self._url_set: set = set()
        self.deduped = 0

    def admit(self, entry: ProcessedEntry) -> bool:
        return self.admit_codes(
            simhash(entry.embedding), url_hash(entry.metadata.final_url)
        )

    def admit_codes(self, code: int, ucode: int) -> bool:
        if len(self._ring) == self.capacity:
            self._set.discard(self._ring.popleft())
            self._url_set.discard(self._url_ring.popleft())
        self._ring.append(code)
        self._url_ring.append(ucode)
        dup = code in self._set or ucode in self._url_set
        self._set.add(code)
        self._url_set.add(ucode)
        if dup:
            self.deduped += 1
        return not dup


@dataclass
class ShardSplitter:
    """Write each record to its top-SHARD_SPILL centroids, greedily
    balance-corrected (dot - balance_fudge * count/total,
    dump_processor.rs:443-449)."""

    centroids: np.ndarray  # (K, D)
    out_dir: Optional[str]
    balance_fudge: float = 0.2
    only_shards: Optional[set] = None  # write just these ids (resplit)
    collect_assignment: bool = False
    files: List = field(default_factory=list)
    counts: Optional[np.ndarray] = None
    total: int = 0
    assignment_batches: List[np.ndarray] = field(default_factory=list)

    def __post_init__(self):
        import msgpack

        k = self.centroids.shape[0]
        self.counts = np.zeros(k, np.int64)
        if self.out_dir is None:
            self.files = [None] * k
            return
        os.makedirs(self.out_dir, exist_ok=True)
        for i in range(k):
            if self.only_shards is not None and i not in self.only_shards:
                self.files.append(None)
                continue
            path = os.path.join(self.out_dir, f"shard_{i}.msgpack")
            f = open(path, "wb")
            f.write(
                msgpack.packb(
                    {
                        "id": i,
                        "centroid": [float(x) for x in self.centroids[i]],
                    }
                )
            )
            self.files.append(f)

    def assign_batch(self, embeddings: np.ndarray) -> np.ndarray:
        """Top-SHARD_SPILL assignment for one batch, updating the
        running balance counts. Deterministic in the (stream order,
        batch boundaries, centroids, fudge) tuple — resplit replay
        (regenerate_shard_inputs) depends on that."""
        dots = embeddings.astype(np.float32) @ self.centroids.T  # (B, K)
        # balance correction frozen at batch start: within one batch the
        # count term moves by <= fudge * (2B/K)/total (~4e-6 at 1e6+
        # records) — unmeasurable vs the dot spread, and it makes the
        # assignment one argpartition over the batch instead of a
        # per-record argsort (the 1e7 split's former hot loop).
        adj = dots - self.balance_fudge * (
            self.counts / max(1, self.total)
        ).astype(np.float32)
        top = np.argpartition(-adj, SHARD_SPILL - 1, axis=1)[
            :, :SHARD_SPILL
        ]
        np.add.at(self.counts, top.ravel(), 1)
        self.total += len(embeddings)
        if self.collect_assignment:
            self.assignment_batches.append(top.astype(np.int32))
        return top

    def write_batch(
        self, ids: Sequence[int], embeddings: np.ndarray, top: np.ndarray
    ):
        import msgpack

        from ..utils.fp16 import encode_fp16_buffer

        for j, rid in enumerate(ids):
            outs = [f for f in (self.files[s] for s in top[j]) if f]
            if not outs:
                continue
            data = msgpack.packb(
                {
                    "id": int(rid),
                    "vector": encode_fp16_buffer(embeddings[j]),
                }
            )
            for f in outs:
                f.write(data)

    def add_batch(self, ids: Sequence[int], embeddings: np.ndarray):
        self.write_batch(ids, embeddings, self.assign_batch(embeddings))

    def assignment(self) -> np.ndarray:
        """(n, SHARD_SPILL) int32 shard ids in stream order (requires
        collect_assignment=True)."""
        if not self.assignment_batches:
            return np.zeros((0, SHARD_SPILL), np.int32)
        return np.concatenate(self.assignment_batches)

    def close(self):
        for f in self.files:
            if f is not None:
                f.close()


def iter_dumps(paths: Sequence[str]) -> Iterator[ProcessedEntry]:
    for p in paths:
        yield from read_dump(p)


def sample_embeddings(
    paths: Sequence[str], fraction: float, seed: int = 0
) -> np.ndarray:
    """Random embedding sample for k-means/OPQ training (-s mode)."""
    rng = np.random.default_rng(seed)
    out = []
    for entry in iter_dumps(paths):
        if rng.random() < fraction:
            out.append(entry.embedding.astype(np.float16))
    return np.stack(out) if out else np.zeros((0, 0), np.float16)


def split_to_shards(
    paths: Sequence[str],
    centroids: np.ndarray,
    out_dir: str,
    *,
    deduplicate: bool = True,
    balance_fudge: float = 0.2,
    batch_size: int = 4096,
    threshold: Optional[float] = None,
    threshold_query: Optional[np.ndarray] = None,
    save_assignment: Optional[str] = None,
) -> Tuple[int, List[dict]]:
    """Dumps -> per-shard ShardedRecord files + a record manifest.

    Returns (count, manifest) where manifest[i] holds the metadata
    needed at pack time (url, timestamp, dimensions) for global id i.
    ``save_assignment`` persists the (n, SHARD_SPILL) record->shard
    table as .npy — 8 bytes/record that make deleted shard inputs
    exactly regenerable from the flat fp16 corpus
    (:func:`regenerate_shard_inputs`).
    """
    splitter = ShardSplitter(
        centroids,
        out_dir,
        balance_fudge,
        collect_assignment=save_assignment is not None,
    )
    dedup = DedupRing() if deduplicate else None
    manifest: List[dict] = []
    count = 0
    pending: List[ProcessedEntry] = []

    def flush():
        nonlocal count
        if not pending:
            return
        embs = np.stack([e.embedding for e in pending])
        codes = (
            simhash_batch(embs) if dedup is not None else [0] * len(pending)
        )
        tdots = (
            embs.astype(np.float32) @ threshold_query
            if threshold is not None and threshold_query is not None
            else None
        )
        keep_rows: List[int] = []
        keep_ids: List[int] = []
        for j, entry in enumerate(pending):
            if dedup is not None and not dedup.admit_codes(
                codes[j], url_hash(entry.metadata.final_url)
            ):
                continue
            if tdots is not None and float(tdots[j]) < threshold:
                continue
            manifest.append(
                {
                    "url": entry.metadata.final_url or entry.url,
                    "timestamp": entry.timestamp,
                    "dimensions": list(entry.metadata.dimension),
                }
            )
            keep_rows.append(j)
            keep_ids.append(count)
            count += 1
        if keep_rows:
            splitter.add_batch(keep_ids, embs[keep_rows])
        pending.clear()

    for entry in iter_dumps(paths):
        pending.append(entry)
        if len(pending) >= batch_size:
            flush()
    flush()
    splitter.close()
    if save_assignment is not None:
        np.save(save_assignment, splitter.assignment())
    return count, manifest


def regenerate_shard_inputs(
    flat_path: str,
    n_total: int,
    centroids: np.ndarray,
    out_dir: str,
    *,
    balance_fudge: float = 0.2,
    batch_size: int = 4096,
    assignment_path: Optional[str] = None,
    verify_built: bool = True,
    allow_unverified: bool = False,
) -> dict:
    """Rebuild missing shard input files from the flat fp16 corpus.

    The --frugal-disk pipeline deletes shard inputs once ``vectors.f16``
    exists (they are redundant: inputs store the same fp16 vectors the
    flat file collects, in global-id order). This inverts the deletion
    so an interrupted many-shard build can resume: for every
    ``shard_s.msgpack`` absent from ``out_dir``, regenerate it with
    byte-identical content.

    The record->shard assignment comes from ``assignment_path`` when the
    split persisted it (save_assignment); otherwise the split is
    *replayed* — same batch boundaries, same frozen-count balance
    correction, same fp16->f32 dots — which is bit-exact provided the
    original split deduplicated nothing (kept stream == raw stream; true
    for the synthetic corpora, and detectable: len(manifest) == n).
    When ``verify_built``, the recovered assignment is checked against
    every existing ``shard_s.graph``'s base-record mapping — a mismatch
    means the replay preconditions were violated and nothing is written.

    Returns a summary dict {regenerated, verified_shards, records}.
    """
    k = centroids.shape[0]
    d = centroids.shape[1]
    vectors = np.memmap(flat_path, np.float16, "r", shape=(n_total, d))
    missing = [
        s
        for s in range(k)
        if not os.path.exists(os.path.join(out_dir, f"shard_{s}.msgpack"))
    ]
    assignment = None
    if assignment_path and os.path.exists(assignment_path):
        assignment = np.load(assignment_path)
        if len(assignment) != n_total:
            raise ValueError(
                f"assignment rows {len(assignment)} != corpus {n_total}"
            )
    replayed = assignment is None
    if assignment is None:
        # replay the split's assignment pass (no file writes)
        replayer = ShardSplitter(
            centroids,
            None,
            balance_fudge,
            collect_assignment=True,
        )
        for start in range(0, n_total, batch_size):
            replayer.assign_batch(np.asarray(vectors[start : start + batch_size]))
        assignment = replayer.assignment()

    verified = 0
    if verify_built:
        from .formats import read_shard_output

        member_of = [
            np.nonzero((assignment == s).any(axis=1))[0] for s in range(k)
        ]
        for s in range(k):
            graph = os.path.join(out_dir, f"shard_{s}.graph")
            if not os.path.exists(graph):
                continue
            header, _adj = read_shard_output(graph)
            built_members = np.unique(np.asarray(header.mapping, np.int64))
            if not np.array_equal(built_members, member_of[s]):
                raise RuntimeError(
                    f"shard {s}: recovered assignment disagrees with the "
                    f"built graph ({len(member_of[s])} vs "
                    f"{len(built_members)} members) — refusing to "
                    "regenerate inputs from a divergent replay"
                )
            verified += 1

    # persist the replayed assignment only AFTER it verifies against
    # AT LEAST ONE built graph: saving first would poison later resumes
    # with a divergent replay (e.g. a forgotten non-default
    # --balance-fudge), which the loader takes on trust. With zero
    # built graphs, or with verification switched off, nothing checked
    # the replay, so a divergent one would pass silently: refuse unless
    # the caller says allow_unverified (resplit only makes sense
    # mid-build, when graphs exist; a fresh split goes through
    # split_to_shards)
    if replayed and verified == 0 and not allow_unverified:
        raise RuntimeError(
            "replayed shard assignment was verified against no built "
            "graph; refusing to persist it or regenerate inputs "
            "(pass allow_unverified=True to override, or run the "
            "normal split stage instead)"
        )
    if replayed and assignment_path:
        np.save(assignment_path, assignment)

    records = 0
    if missing:
        # one sequential pass over the corpus, appending to every
        # missing shard (same IO shape as the original split); write to
        # a tmp dir and rename into place so a crash leaves no partials
        tmp_dir = os.path.join(out_dir, ".resplit_tmp")
        writer = ShardSplitter(
            centroids,
            tmp_dir,
            balance_fudge,
            only_shards=set(missing),
        )
        for start in range(0, n_total, batch_size):
            top = assignment[start : start + batch_size]
            writer.write_batch(
                range(start, start + len(top)),
                np.asarray(vectors[start : start + batch_size]),
                top,
            )
            records += int(np.isin(top, missing).any(axis=1).sum())
        writer.close()
        for s in missing:
            os.replace(
                os.path.join(tmp_dir, f"shard_{s}.msgpack"),
                os.path.join(out_dir, f"shard_{s}.msgpack"),
            )
        os.rmdir(tmp_dir)
    return {
        "regenerated": len(missing),
        "verified_shards": verified,
        "records": records,
    }


def coverage_build_order(
    assignment: np.ndarray,
    built: Sequence[int],
    n_clusters: int,
    fixed_cost_s: float = 15.0,
    per_record_s: float = 0.0018,
) -> List[int]:
    """Order unbuilt shards to maximise record coverage per build-second.

    Each record spills to ``assignment.shape[1]`` shards
    (dump_processor.rs:438-461 SHARD_SPILL semantics) and is *covered*
    — reachable at serve time — once any of them has a built graph.
    When a build runs under a chip-time budget (the normal case at 1e8:
    ~118 chip-hours all-in, BENCHMARKS.md projection), the sequential
    shard order wastes the redundancy: late shards mostly re-cover
    records an earlier spill copy already covered.  Greedy
    cost-normalised set cover fixes that: repeatedly pick the shard
    with the most still-uncovered records per estimated build second
    (cost model: fixed per-shard overhead + the measured per-spill-
    record build rate).  Marginal coverage is submodular, so lazy
    re-evaluation (re-score only the current heap head) is exact.

    Measured on the round-5 1e7 run (420 shards, 81 built): +180 shards
    sequential = 0.853 coverage vs greedy = 0.922; full coverage needs
    only 356/420 shards.  Shards with zero marginal coverage are
    appended in index order (they still densify adjacency for records
    whose other spill copy is built).
    """
    import heapq

    built_mask = np.zeros(n_clusters, bool)
    if len(built):
        built_mask[np.asarray(list(built), np.int64)] = True
    covered = built_mask[assignment].any(axis=1)
    sizes = np.bincount(assignment.ravel(), minlength=n_clusters)
    cost = fixed_cost_s + per_record_s * sizes

    # per-shard id lists of initially-uncovered incident records
    unc = np.where(~covered)[0]
    lists: List[np.ndarray] = [np.empty(0, np.int64)] * n_clusters
    if len(unc):
        parts: List[List[np.ndarray]] = [[] for _ in range(n_clusters)]
        for col in range(assignment.shape[1]):
            sh = assignment[unc, col]
            srt = np.argsort(sh, kind="stable")
            sh_s, r_s = sh[srt], unc[srt]
            bounds = np.searchsorted(sh_s, np.arange(n_clusters + 1))
            for s in range(n_clusters):
                if bounds[s + 1] > bounds[s]:
                    parts[s].append(r_s[bounds[s] : bounds[s + 1]])
        lists = [
            np.concatenate(p) if p else np.empty(0, np.int64) for p in parts
        ]

    still = ~covered
    heap = [
        (-len(lists[s]) / cost[s], s)
        for s in range(n_clusters)
        if not built_mask[s]
    ]
    heapq.heapify(heap)
    order: List[int] = []
    exhausted: List[int] = []
    while heap:
        _stale, s = heapq.heappop(heap)
        cur = int(still[lists[s]].sum())
        if cur == 0:
            exhausted.append(s)
            continue
        val = cur / cost[s]
        if heap and -heap[0][0] > val:
            heapq.heappush(heap, (-val, s))
            continue
        order.append(s)
        still[lists[s]] = False
    order.extend(sorted(exhausted))
    return order


class PaddedAdjacency:
    """Row-indexable adjacency over one padded int32 matrix.

    ``adj[i]`` -> the node's merged row (a view, no copy). Replaces the
    list-of-lists merge output: at 1e7 nodes x 420 shards the Python
    representation held ~25 GB of int objects; this holds
    ``n x cap x 4`` bytes (~2.6 GB at cap 64) — the difference between
    the full-coverage 1e7 pack tail fitting in host RAM or not, and a
    hard requirement for the 1e8 design point.
    """

    __slots__ = ("rows", "counts")

    def __init__(self, rows: np.ndarray, counts: np.ndarray):
        self.rows = rows
        self.counts = counts

    def __len__(self) -> int:
        return len(self.counts)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.rows[i, : self.counts[i]]


def merge_shard_adjacency(
    shard_outputs: Sequence[Tuple["object", List[np.ndarray]]],
    n_total: int,
    max_degree_per_shard: Optional[int] = None,
) -> Tuple[PaddedAdjacency, PaddedAdjacency]:
    """Merge per-shard out-edges into global adjacency; each node appears
    in <=SHARD_SPILL shards (dump_processor.rs:218-304 read_out_vertices).

    Returns (vertices per node, shard ids per node), both as
    :class:`PaddedAdjacency`. Semantics (checked against a naive
    list-of-lists oracle in test_disk_pipeline): per shard in input
    order — map local edge ids to global via the shard's mapping,
    drop local ids beyond the base mapping (OOD query rows), truncate
    to ``max_degree_per_shard``, then append edges not already present
    in the node's merged row from EARLIER shards (self-edges dropped;
    duplicates within one shard's row pass through — shard rows are
    unique post-prune). Vectorised per shard: rows are unpadded from
    the blob by offset arithmetic, deduped against the existing merged
    prefix with one broadcast compare, and scatter-appended at each
    node's fill cursor.
    """
    # pass 1: per-node capacity = sum of its (truncated) shard row
    # lengths; dedup only shrinks, so this bounds the merged row
    cap_per_node = np.zeros(n_total, np.int64)
    for header, _adjacency in shard_outputs:
        m = len(header.mapping)
        offs = np.asarray(header.offsets, np.int64)
        lens = (offs[1 : m + 1] - offs[:m]) // 4
        if max_degree_per_shard:
            lens = np.minimum(lens, max_degree_per_shard)
        # a node appears at most once per shard's mapping, so fancy
        # add is safe (and np.add.at-equivalent)
        cap_per_node[np.asarray(header.mapping[:m], np.int64)] += lens
    cap = int(cap_per_node.max()) if n_total else 0
    del cap_per_node

    rows = np.full((n_total, cap), -1, np.int32)
    counts = np.zeros(n_total, np.int32)
    shard_rows = np.full((n_total, SHARD_SPILL), -1, np.int32)
    shard_counts = np.zeros(n_total, np.int32)

    for header, adjacency in shard_outputs:
        m = len(header.mapping)
        if m == 0:
            continue
        mapping = np.asarray(header.mapping, np.int64)
        base_rows = adjacency[:m]
        lens = np.asarray([len(r) for r in base_rows], np.int64)
        lmax = int(lens.max()) if m else 0
        # unpad: local edge matrix with sentinel m (== "beyond mapping")
        local = np.full((m, lmax), m, np.int64)
        col_ok = np.arange(lmax)[None, :] < lens[:, None]
        if lmax:
            local[col_ok] = np.concatenate(base_rows).astype(np.int64)
        # map to global ids; invalid locals (>= m, incl. sentinel) -> -1
        valid = local < m
        glob = np.where(valid, mapping[np.minimum(local, m - 1)], -1)
        # compact mapping-valid edges to the left (preserving order),
        # truncate, and only THEN drop self-edges — the list merge
        # applies its row cap before the self/seen screening, so a
        # self-edge inside the cap window consumes cap budget
        keep = glob != -1
        pos = keep.cumsum(1) - 1
        packed = np.full((m, lmax), -1, np.int64)
        rix = np.broadcast_to(np.arange(m)[:, None], keep.shape)
        packed[rix[keep], pos[keep]] = glob[keep]
        if max_degree_per_shard:
            packed = packed[:, :max_degree_per_shard]
        packed[packed == mapping[:, None]] = -1  # self-edges
        fresh = packed != -1
        if packed.shape[1]:
            # dedup against each node's already-merged prefix only —
            # duplicates INSIDE one shard row pass through, exactly as
            # in the list merge (its seen-set is snapshotted before the
            # row extends; shard rows are unique post-prune anyway)
            existing = rows[mapping]  # (m, cap) gather
            dup_prior = (
                packed[:, :, None] == existing[:, None, :].astype(np.int64)
            ).any(2)
            fresh &= ~dup_prior
        # scatter-append at each node's cursor
        dst = counts[mapping].astype(np.int64)[:, None] + (
            fresh.cumsum(1) - 1
        )
        # pass 1 sized cap from header.offsets; this pass scatters by
        # the decoded rows' actual lengths — any disagreement (a
        # malformed shard file) would silently corrupt the next node's
        # merged row via the flat reshape below, so fail loudly instead
        if fresh.any() and int(dst[fresh].max()) >= cap:
            raise ValueError(
                f"shard {header.id}: decoded adjacency rows exceed the "
                "offset-derived capacity — malformed shard output"
            )
        flat = mapping[:, None] * cap + dst
        rows.reshape(-1)[flat[fresh]] = packed[fresh].astype(np.int32)
        counts[mapping] += fresh.sum(1).astype(np.int32)
        shard_rows[mapping, shard_counts[mapping]] = header.id
        shard_counts[mapping] += 1

    return (
        PaddedAdjacency(rows, counts),
        PaddedAdjacency(shard_rows, shard_counts),
    )


def pack_index(
    out_dir: str,
    vectors: np.ndarray,  # (N, D) fp16/f32, global id order
    vertices: PaddedAdjacency,
    node_shards: PaddedAdjacency,
    manifest: List[dict],
    quantizer: ProductQuantizer,
    shard_centroids: np.ndarray,
    shard_medioids: Sequence[int],  # global medioid id per shard
    *,
    scores: Optional[np.ndarray] = None,  # (N, n_channels) quality scores
    descriptor_cdfs: Optional[List[np.ndarray]] = None,
    batch_size: int = 8192,
    device="cuda",
    pause_point: Optional[Callable[[], None]] = None,
) -> IndexHeader:
    """Write index.bin / index.pq-codes.bin / index.descriptor-codes.bin /
    index.msgpack (dump_processor.rs:463-569). The OPQ codes are encoded
    on ``device``; the records are packed natively, one GIL-free C call a
    batch, and a manifest row whose dimensions are not a pair raises.
    ``pause_point`` is called before every batch: the chip lease's safe
    point (``utils/tpu_lease.py``), as in the JAX package."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(vectors)
    dead = 0

    from ..index.native_io import native_pack_records
    from .descriptors import bucketize_scores

    def read_batch(start: int) -> np.ndarray:
        # rows in the corpus' own dtype: the fp16 tail memmap moves
        # half the bytes to the device (quantize widens there,
        # bit-identical codes) and its raw rows serve the record
        # vector field directly (encode_fp16_buffer on fp16 is a copy)
        return np.ascontiguousarray(vectors[start : min(n, start + batch_size)])

    with open(os.path.join(out_dir, "index.bin"), "wb") as recf, open(
        os.path.join(out_dir, "index.pq-codes.bin"), "wb"
    ) as pqf, open(
        os.path.join(out_dir, "index.descriptor-codes.bin"), "wb"
    ) as descf:
        next_batch = read_batch(0) if n else None
        pending = quantizer.quantize_async(next_batch, device) if n else None
        for start in range(0, n, batch_size):
            if pause_point is not None:
                pause_point()
            end = min(n, start + batch_size)
            batch, codes_dev = next_batch, pending
            next_batch = read_batch(end) if end < n else None
            if next_batch is not None:
                # dispatch the next upload+quantize before the host
                # packs this batch: the device works behind the
                # CPU-bound record loop
                pending = quantizer.quantize_async(next_batch, device)
            codes = codes_dev.cpu().numpy()
            pqf.write(np.ascontiguousarray(codes).tobytes())

            if scores is not None and descriptor_cdfs is not None:
                desc = bucketize_scores(
                    scores[start:end],
                    [m["timestamp"] for m in manifest[start:end]],
                    descriptor_cdfs,
                )
            else:
                desc = np.zeros((end - start, 4), np.uint8)
            descf.write(desc.tobytes())

            ms = manifest[start:end]
            raw, dead_flags = native_pack_records(
                batch.astype("<f2", copy=False),
                vertices.rows[start:end],
                vertices.counts[start:end],
                start,
                np.asarray([m["timestamp"] for m in ms], np.int64),
                np.asarray([m.get("dimensions", (0, 0)) for m in ms], np.int64),
                scores[start:end].astype(np.float64) if scores is not None else None,
                [m["url"] for m in ms],
                node_shards.rows[start:end],
                node_shards.counts[start:end],
                RECORD_PAD_SIZE,
            )
            dead += int(dead_flags.sum())
            recf.write(raw)

    header = IndexHeader(
        shards=[
            (list(map(float, c)), int(m))
            for c, m in zip(shard_centroids, shard_medioids)
        ],
        count=n,
        dead_count=dead,
        record_pad_size=RECORD_PAD_SIZE,
        quantizer={
            "centroids": quantizer.centroids.astype(np.float32)
            .flatten()
            .tolist(),
            "transform": quantizer.transform.astype(np.float32)
            .flatten()
            .tolist(),
            "n_dims_per_code": quantizer.n_dims_per_code,
            "n_dims": quantizer.n_dims,
        },
        descriptor_cdfs=(
            [list(map(float, c)) for c in descriptor_cdfs]
            if descriptor_cdfs
            else []
        ),
    )
    header.save(os.path.join(out_dir, "index.msgpack"))
    return header
