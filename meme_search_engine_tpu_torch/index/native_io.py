"""Record IO over the shared C++ host runtime (``native/``).

Counterpart of ``meme_search_engine_tpu/index/native_io.py``, which the
port keeps rather than imports. ``open_reader(path, record_size)`` returns
an object with ``read_batch(ids) -> list[bytes]``: the native backend
(native/diskio.cpp) fans pread(2) calls across a worker pool, the portable
equivalent of the reference's io_uring beam reads
(query_disk_index.rs:73-81,159-167). ``PythonReader`` is the parity
oracle, taken only where a caller builds it by name.

The library is built at first use from ``native/diskio.cpp`` and
``native/pack.cpp`` with the flags of ``native/Makefile`` into
``build/native/`` at the repository root (listed in ``.gitignore``). Its
file name carries a hash of the compiler, the flags, the sources and the
host CPU (``-march=native``), so an edit or another machine forces a
rebuild, and the build runs under an exclusive file lock, so two
processes starting at once never race on a half-written library. A build
or load that fails raises with the compiler's output; nothing falls back
to the Python reader.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence

import numpy as np

__all__ = [
    "NativeReader", "NativeNav", "PythonReader", "open_reader", "load_native",
    "native_stitch_refill", "native_pack_records", "BUILD_DIR",
]

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "native"
SOURCES = ("diskio.cpp", "pack.cpp")
# native/Makefile's CXXFLAGS and LDFLAGS for libdiskio.so
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall"]
LDFLAGS = ["-shared", "-pthread"]
ABI_VERSION = 2

_lock = threading.Lock()
_lib = None


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def _digest() -> str:
    h = hashlib.sha256(" ".join([_cxx(), *CXXFLAGS, *LDFLAGS]).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    try:  # -march=native: a library built on one CPU may not run on another
        with open("/proc/cpuinfo") as f:
            h.update("".join(sorted({ln for ln in f if ln.startswith(("model name", "flags"))})).encode())
    except OSError:
        h.update(os.uname().machine.encode())
    return h.hexdigest()[:16]


def _build() -> Path:
    """Compile libdiskio.so into BUILD_DIR unless this digest's library is
    there already; returns its path. Raises with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libdiskio-{_digest()}.so"
    with open(BUILD_DIR / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if not so.exists():
                tmp = BUILD_DIR / f".libdiskio.{os.getpid()}.so"
                cmd = [_cxx(), *CXXFLAGS, *LDFLAGS, "-o", str(tmp),
                       *(str(NATIVE_DIR / s) for s in SOURCES)]
                try:
                    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
                except (OSError, subprocess.SubprocessError) as e:
                    raise RuntimeError(f"building libdiskio.so: {' '.join(cmd)}: {e}") from e
                if out.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"building libdiskio.so failed ({' '.join(cmd)}):\n{out.stdout}{out.stderr}")
                os.replace(tmp, so)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return so


def load_native() -> ctypes.CDLL:
    """Build (if stale) and load libdiskio.so with every prototype set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        lib.diskio_abi_version.restype = ctypes.c_int64
        abi = int(lib.diskio_abi_version())
        if abi != ABI_VERSION:
            raise RuntimeError(f"libdiskio.so ABI {abi} != expected {ABI_VERSION}")
        i64, i32p, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
        fp = ctypes.POINTER(ctypes.c_float)
        lib.diskio_open.restype = ctypes.c_void_p
        lib.diskio_open.argtypes = [ctypes.c_char_p, i64, ctypes.c_int]
        lib.diskio_read_batch.restype = i64
        lib.diskio_read_batch.argtypes = [ctypes.c_void_p, i64p, i64, ctypes.c_char_p]
        lib.diskio_close.restype = None
        lib.diskio_close.argtypes = [ctypes.c_void_p]
        lib.disknav_open.restype = ctypes.c_void_p
        lib.disknav_open.argtypes = [
            ctypes.c_void_p,  # reader handle
            i64,              # count
            i64,              # d
            ctypes.c_void_p,  # pq_codes
            i64,              # n_chunks
            i64,              # n_centroids
            ctypes.c_void_p,  # descriptors
            i64,              # n_desc
        ]
        lib.disknav_search.restype = i64
        lib.disknav_search.argtypes = [
            ctypes.c_void_p,  # nav
            fp,               # lut
            fp,               # query
            fp,               # desc_scales
            ctypes.c_int,     # use_desc
            i64,              # start_id
            i64,              # beamwidth
            i64,              # search_list
            i64p,             # out_ids
            fp,               # out_scores
            i64,              # max_out
            i64p,             # counters
            i64,              # spec (speculative reads a hop)
        ]
        lib.disknav_close.restype = None
        lib.disknav_close.argtypes = [ctypes.c_void_p]
        lib.pack_records.restype = i64
        lib.pack_records.argtypes = [
            ctypes.c_char_p,                  # vec_bytes
            i64,                              # vec_nbytes per record
            i32p,                             # verts (nrec, vcap)
            i32p,                             # vcounts
            i64,                              # vcap
            i64,                              # id0
            i64p,                             # timestamps
            i64p,                             # dims (nrec, 2)
            ctypes.POINTER(ctypes.c_double),  # scores (nrec, nscores)
            i64,                              # nscores
            ctypes.c_char_p,                  # urls (concatenated utf8)
            i64p,                             # url_offs (nrec+1)
            i32p,                             # shards (nrec, scap)
            i32p,                             # shard_counts
            i64,                              # scap
            i64,                              # nrec
            i64,                              # pad_size
            ctypes.c_char_p,                  # out (nrec * pad_size)
            ctypes.c_char_p,                  # dead (nrec)
        ]
        lib.stitch_refill.restype = None
        lib.stitch_refill.argtypes = [
            i32p,  # graph (n, r)
            i32p,  # degrees (n,)
            i64,   # n
            i32p,  # in_ns (P,)
            i64,   # n_pairs
            i32p,  # cands (P, r)
            i64,   # bp
            i64,   # max_add
            i64,   # r
        ]
        _lib = lib
        return lib


class NativeReader:
    def __init__(self, path: str, record_size: int, n_threads: int = 0):
        self._handle = None
        self._lib = load_native()
        self.record_size = record_size
        self._handle = self._lib.diskio_open(path.encode(), record_size, n_threads)
        if not self._handle:
            raise OSError(f"diskio_open failed for {path}")

    def read_batch(self, ids: Sequence[int]) -> List[bytes]:
        n = len(ids)
        ids_arr = (ctypes.c_int64 * n)(*ids)
        buf = ctypes.create_string_buffer(n * self.record_size)
        ok = self._lib.diskio_read_batch(self._handle, ids_arr, n, buf)
        if ok != n:
            raise OSError(f"short batch read: {ok}/{n}")
        raw = buf.raw
        return [raw[i * self.record_size : (i + 1) * self.record_size] for i in range(n)]

    def close(self):
        if self._handle:
            self._lib.diskio_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class NativeNav:
    """The beam-search hot loop, native (native/diskio.cpp disknav_*).

    The whole per-query loop (beam pop, pread fan-out, record parse,
    seen-bitmap admission, PQ LUT-sum, descriptor add, frontier
    truncation, final ranking) runs behind one GIL-releasing ctypes call,
    the portable equivalent of the reference's compiled thread-per-core
    search (query_disk_index.rs:144-212, 711-742).

    ``pq_codes`` / ``descriptors`` are borrowed: the Nav keeps references
    to them, and to the reader, for its lifetime.
    """

    def __init__(self, reader: NativeReader, count: int, d: int, pq_codes, n_centroids: int,
                 descriptors):
        self._handle = None
        if not isinstance(reader, NativeReader):
            raise TypeError(f"NativeNav needs a NativeReader, got {type(reader).__name__}")
        for name, a in (("pq_codes", pq_codes), ("descriptors", descriptors)):
            if a.dtype != np.uint8 or not a.flags.c_contiguous or a.ndim != 2 or len(a) != count:
                raise ValueError(f"{name}: need C-contiguous uint8 ({count}, m), got {a.dtype} {a.shape}")
        self._lib = load_native()
        self._reader = reader
        self._pq = pq_codes
        self._desc = descriptors
        self.count = count
        self.n_desc = int(descriptors.shape[1])
        self._handle = self._lib.disknav_open(
            reader._handle, count, d, pq_codes.ctypes.data_as(ctypes.c_void_p),
            int(pq_codes.shape[1]), n_centroids, descriptors.ctypes.data_as(ctypes.c_void_p),
            self.n_desc,
        )
        if not self._handle:
            raise OSError("disknav_open failed")

    def search(self, lut, query, desc_scales, use_desc: bool, start_id: int, beamwidth: int,
               search_list: int, spec: int = 0):
        """Returns (ids int64[n], scores f32[n], node_reads, pq_cmps): the
        visited nodes ranked by exact score, best first. spec > 0 also
        fetches the next-best ``spec`` frontier candidates a hop in the
        same IO fan-out (same results, a deeper IO schedule)."""
        lut = np.ascontiguousarray(lut, np.float32)
        query = np.ascontiguousarray(query, np.float32)
        desc_scales = np.ascontiguousarray(desc_scales, np.float32)
        max_out = search_list + beamwidth + 1
        out_ids = np.empty(max_out, np.int64)
        out_scores = np.empty(max_out, np.float32)
        counters = np.zeros(2, np.int64)
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int64)
        n = self._lib.disknav_search(
            self._handle, lut.ctypes.data_as(fp), query.ctypes.data_as(fp),
            desc_scales.ctypes.data_as(fp), 1 if use_desc else 0, start_id, beamwidth,
            search_list, out_ids.ctypes.data_as(ip), out_scores.ctypes.data_as(fp), max_out,
            counters.ctypes.data_as(ip), int(spec),
        )
        if n < 0:
            raise OSError("disknav_search failed (corrupt record?)")
        return out_ids[:n], out_scores[:n], int(counters[0]), int(counters[1])

    def close(self):
        if self._handle:
            self._lib.disknav_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class PythonReader:
    """os.pread reader (functionally identical, serial): the parity oracle."""

    def __init__(self, path: str, record_size: int):
        self._fd = os.open(path, os.O_RDONLY)
        self.record_size = record_size

    def read_batch(self, ids: Sequence[int]) -> List[bytes]:
        return [os.pread(self._fd, self.record_size, i * self.record_size) for i in ids]

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


def native_stitch_refill(graph, degrees, in_ns, cands, bp: int, max_add: int, r: int) -> None:
    """Run the RobustStitch slot-refill loop natively (exact sequential
    semantics, native/diskio.cpp stitch_refill); mutates ``graph``, a
    C-contiguous (n, r) int32 array, in place. ``cands`` is (P, r) int32,
    rank-ordered."""
    if not (graph.dtype == np.int32 and graph.flags.c_contiguous and graph.ndim == 2
            and graph.shape[1] == r and graph.flags.writeable):
        raise ValueError(f"graph: need a writable C-contiguous (n, {r}) int32 array")
    cands = np.ascontiguousarray(cands, np.int32)
    in_ns = np.ascontiguousarray(in_ns, np.int32)
    if cands.shape != (len(in_ns), r):
        raise ValueError(f"cands {cands.shape}, expected ({len(in_ns)}, {r})")
    if len(in_ns) and (in_ns.min() < 0 or in_ns.max() >= graph.shape[0]):
        raise ValueError("in-neighbour ids out of range")
    degrees32 = np.ascontiguousarray(degrees, np.int32)
    if degrees32.shape != (graph.shape[0],):
        raise ValueError(f"degrees {degrees32.shape}, expected ({graph.shape[0]},)")
    i32p = ctypes.POINTER(ctypes.c_int32)
    load_native().stitch_refill(
        graph.ctypes.data_as(i32p), degrees32.ctypes.data_as(i32p), graph.shape[0],
        in_ns.ctypes.data_as(i32p), len(in_ns), cands.ctypes.data_as(i32p), bp, max_add, r,
    )


def native_pack_records(
    vec_bytes,        # (nrec, d) fp16 C-contiguous: raw record payload
    verts_rows,       # (nrec, vcap) int32 padded
    vert_counts,      # (nrec,) int32
    id0: int,
    timestamps,       # (nrec,) int64
    dims,             # (nrec, 2) int64
    scores,           # (nrec, nscores) float64 or None
    urls,             # sequence of str
    shard_rows,       # (nrec, scap) int32 padded
    shard_counts,     # (nrec,) int32
    pad_size: int,
):
    """Pack a batch of index records natively (native/pack.cpp).

    Returns ``(records_bytes, dead_bool_array)``, byte-identical to a loop
    of ``PackedIndexEntry.pack_ex``. Raises ValueError when a record
    exceeds the pad even with its URL dropped, as the Python packer does,
    and when ``dims`` is not (nrec, 2): the native packer encodes two
    dimensions only.
    """
    nrec = len(vert_counts)
    vec_bytes = np.ascontiguousarray(vec_bytes)
    if vec_bytes.ndim != 2 or len(vec_bytes) != nrec:
        raise ValueError(f"vectors {vec_bytes.shape} for {nrec} records")
    verts_rows = np.ascontiguousarray(verts_rows, np.int32)
    vert_counts = np.ascontiguousarray(vert_counts, np.int32)
    shard_rows = np.ascontiguousarray(shard_rows, np.int32)
    shard_counts = np.ascontiguousarray(shard_counts, np.int32)
    timestamps = np.ascontiguousarray(timestamps, np.int64)
    dims = np.ascontiguousarray(dims, np.int64)
    if dims.shape != (nrec, 2):
        raise ValueError(f"dims {dims.shape}: the native packer needs ({nrec}, 2)")
    for name, rows, counts in (("vertices", verts_rows, vert_counts),
                               ("shards", shard_rows, shard_counts)):
        if len(rows) != nrec or (nrec and (counts.min() < 0 or counts.max() > rows.shape[1])):
            raise ValueError(f"{name}: counts outside the padded rows")
    if scores is None:
        scores_arr = np.zeros((nrec, 0), np.float64)
    else:
        scores_arr = np.ascontiguousarray(scores, np.float64)
    encoded = [u.encode("utf-8") for u in urls]
    url_blob = b"".join(encoded)
    url_offs = np.zeros(nrec + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=url_offs[1:])
    out = ctypes.create_string_buffer(nrec * pad_size)
    dead = np.zeros(nrec, np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    ndead = load_native().pack_records(
        vec_bytes.ctypes.data_as(ctypes.c_char_p), vec_bytes.strides[0],
        verts_rows.ctypes.data_as(i32p), vert_counts.ctypes.data_as(i32p), verts_rows.shape[1],
        id0, timestamps.ctypes.data_as(i64p), dims.ctypes.data_as(i64p),
        scores_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), scores_arr.shape[1],
        url_blob, url_offs.ctypes.data_as(i64p), shard_rows.ctypes.data_as(i32p),
        shard_counts.ctypes.data_as(i32p), shard_rows.shape[1], nrec, pad_size, out,
        dead.ctypes.data_as(ctypes.c_char_p),
    )
    if ndead < 0:
        raise ValueError(f"record {id0 + (-1 - ndead)} exceeds pad size even without URL")
    return out.raw, dead.astype(bool)


def open_reader(path: str, record_size: int):
    """The native reader. A native library that does not build or load
    raises; a caller that wants the parity oracle builds ``PythonReader``."""
    return NativeReader(path, record_size)
