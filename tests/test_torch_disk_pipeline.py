"""Port parity: the large-scale disk pipeline of meme_search_engine_tpu_torch
(pipeline/{dump,processor,descriptors}.py, index/{native_io,disk_index}.py)
against the JAX package's, on the same numpy inputs, at the size of the JAX
package's ``built_index`` fixture (tests/test_disk_pipeline.py:55): N = 600
records of D = 64 in 3 shards. The JAX package writes the dump, draws the
centroids, builds the shard graphs and trains the quantizer; both packages
then split, merge and pack the same inputs, and both search one index.
"""

import os
import shutil

import numpy as np
import pytest

from meme_search_engine_tpu.index import disk_index as jdi
from meme_search_engine_tpu.index import native_io as jnio
from meme_search_engine_tpu.index.kmeans import balanced_kmeans
from meme_search_engine_tpu.index.opq import train_opq
from meme_search_engine_tpu.pipeline import descriptors as jdesc
from meme_search_engine_tpu.pipeline import dump as jdump
from meme_search_engine_tpu.pipeline import formats as jformats
from meme_search_engine_tpu.pipeline import processor as jproc
from meme_search_engine_tpu.pipeline.build_shard import build_shard
from meme_search_engine_tpu_torch.index import disk_index as tdi
from meme_search_engine_tpu_torch.index import native_io as tnio
from meme_search_engine_tpu_torch.index.opq import ProductQuantizer
from meme_search_engine_tpu_torch.pipeline import descriptors as tdesc
from meme_search_engine_tpu_torch.pipeline import dump as tdump
from meme_search_engine_tpu_torch.pipeline import formats as tformats
from meme_search_engine_tpu_torch.pipeline import processor as tproc

N, D, SHARDS = 600, 64, 3
CPU = "cpu"
SCORE_TOL = 1e-5  # the searches' exact fp32 scores


def _entries(mod, rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    for i in range(n):
        yield mod.ProcessedEntry(
            url=f"https://example.com/{i}", id=f"id{i}", title=f"meme {i}", subreddit="memes",
            author="a", timestamp=1700000000 + i, embedding=x[i],
            metadata=mod.OriginalImageMetadata(
                mime_type="image/png", original_file_size=1000 + i, dimension=(64, 48),
                final_url=f"https://cdn.example.com/{i}.png",
            ),
        )


def _files(d):
    return {p: open(os.path.join(d, p), "rb").read() for p in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("disk")
    rng = np.random.default_rng(0)
    dump_path = str(tmp / "000000001.dump.zst")
    with jdump.DumpWriter(dump_path) as w:
        for e in _entries(jdump, rng, N):
            w.write(e)
    sample = jproc.sample_embeddings([dump_path], 1.0, seed=0)
    centroids = balanced_kmeans(sample.astype(np.float32), SHARDS, max_iter=60, seed=0, target_frac=0.5)
    split = {}
    for name, proc in (("jax", jproc), ("port", tproc)):
        shard_dir = str(tmp / f"shards_{name}")
        count, manifest = proc.split_to_shards(
            [dump_path], centroids, shard_dir, deduplicate=True,
            save_assignment=str(tmp / f"assignment_{name}.npy"),
        )
        split[name] = (shard_dir, count, manifest, np.load(str(tmp / f"assignment_{name}.npy")))

    # the JAX package builds every shard from its own split
    shard_dir, _count, manifest, _a = split["jax"]
    queries = rng.standard_normal((32, D)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    vectors = np.zeros((N, D), np.float32)
    for s in range(SHARDS):
        in_path = os.path.join(shard_dir, f"shard_{s}.msgpack")
        build_shard(in_path, os.path.join(shard_dir, f"shard_{s}.graph"), query_vectors=queries,
                    r=12, l=32, maxc=64, batch_size=128, seed=s)
        for rid, vec in jformats.read_shard_input(in_path)[1]:
            vectors[rid] = vec
    graphs = [os.path.join(shard_dir, f"shard_{s}.graph") for s in range(SHARDS)]
    merged = {
        "jax": jproc.merge_shard_adjacency([jformats.read_shard_output(g) for g in graphs], N),
        "port": tproc.merge_shard_adjacency([tformats.read_shard_output(g) for g in graphs], N),
    }
    pq = train_opq(vectors, queries, n_chunks=8, n_centroids=32, outer_iters=1, adam_iters=30,
                   batch_size=N, query_batch_size=32)
    tpq = ProductQuantizer.from_msgpack(pq.to_msgpack())
    scores = rng.standard_normal((N, 3)).astype(np.float32)
    timestamps = [m["timestamp"] for m in manifest]
    cdfs = {"jax": jdesc.compute_cdfs(scores, timestamps), "port": tdesc.compute_cdfs(scores, timestamps)}
    medioids = []
    for g in graphs:
        h, _adj = jformats.read_shard_output(g)
        medioids.append(h.mapping[h.medioid])
    index = {}
    for name, proc, quant, kw in (("jax", jproc, pq, {}), ("port", tproc, tpq, {"device": CPU})):
        v, ns = merged[name]
        out_dir = str(tmp / f"index_{name}")
        proc.pack_index(out_dir, vectors, v, ns, manifest, quant, centroids, medioids, scores=scores,
                        descriptor_cdfs=cdfs[name], batch_size=256, **kw)
        index[name] = out_dir
    return {
        "tmp": tmp, "dump": dump_path, "centroids": centroids, "split": split, "merged": merged,
        "vectors": vectors, "queries": queries, "pq": tpq, "cdfs": cdfs, "index": index,
        "graphs": graphs,
    }


def test_dumps_cross_read_both_ways(pipeline, tmp_path):
    """A dump the JAX package wrote (zstd level 8) reads in the port, and the
    port's dump (a zstd frame of stored blocks) reads in the JAX package."""
    want = [e.to_dict() for e in jdump.read_dump(pipeline["dump"])]
    assert len(want) == N
    assert [e.to_dict() for e in tdump.read_dump(pipeline["dump"])] == want
    path = str(tmp_path / "000000002.dump.zst")
    with tdump.DumpWriter(path) as w:
        for e in _entries(tdump, np.random.default_rng(0), N):
            w.write(e)
    assert [e.to_dict() for e in jdump.read_dump(path)] == want
    assert [e.to_dict() for e in tdump.read_dump(path)] == want
    # the empty dump, and the scraper's resume over the highest sequence
    with tdump.DumpWriter(str(tmp_path / "000000009.dump.zst")):
        pass
    assert list(jdump.read_dump(str(tmp_path / "000000009.dump.zst"))) == []
    shutil.copy(pipeline["dump"], tmp_path / "000000010.dump.zst")
    assert tdump.latest_timestamp(str(tmp_path)) == jdump.latest_timestamp(str(tmp_path)) == 1700000000 + N - 1


def test_split_matches_jax(pipeline):
    """The same centroids give byte-equal shard inputs, the same manifest
    and the same record->shard table."""
    (jd, jc, jm, ja), (td, tc, tm, ta) = pipeline["split"]["jax"], pipeline["split"]["port"]
    assert jc == tc == N and tm == jm
    np.testing.assert_array_equal(ta, ja)
    jf = {p: b for p, b in _files(jd).items() if p.endswith(".msgpack")}
    assert len(jf) == SHARDS and _files(td) == jf


def test_merge_matches_jax(pipeline):
    (jv, js), (tv, ts) = pipeline["merged"]["jax"], pipeline["merged"]["port"]
    for j, t in ((jv, tv), (js, ts)):
        np.testing.assert_array_equal(t.rows, j.rows)
        np.testing.assert_array_equal(t.counts, j.counts)


@pytest.mark.parametrize("max_degree", [None, 3])
def test_merge_matches_jax_on_ragged_rows(max_degree):
    """tests/test_disk_pipeline.py:795's shard outputs: self-edges,
    duplicates inside a row, out-of-mapping local ids, trailing OOD rows."""
    rng = np.random.default_rng(42)
    n = 400
    assign = np.stack([rng.permutation(6)[:2] for _ in range(n)])
    outputs = {"jax": [], "port": []}
    for s in range(6):
        mapping = np.nonzero((assign == s).any(axis=1))[0].tolist()
        rng.shuffle(mapping)
        m = len(mapping)
        adjacency = []
        for li in range(m):
            deg = int(rng.integers(0, 7))
            row = rng.integers(0, m + 3, deg)
            if deg >= 2 and rng.random() < 0.5:
                row[1] = row[0]
            if deg >= 1 and rng.random() < 0.3:
                row[0] = li
            adjacency.append(row.astype(np.uint32))
        for _ in range(2):
            adjacency.append(rng.integers(0, m, 4).astype(np.uint32))
        offsets = np.concatenate([[0], np.cumsum([4 * len(r) for r in adjacency])]).tolist()
        for name, fmt in (("jax", jformats), ("port", tformats)):
            outputs[name].append((fmt.ShardHeader(id=s, max=m, centroid=[0.0], medioid=0, offsets=offsets,
                                                  mapping=mapping), adjacency))
    jv, js = jproc.merge_shard_adjacency(outputs["jax"], n, max_degree)
    tv, ts = tproc.merge_shard_adjacency(outputs["port"], n, max_degree)
    for j, t in ((jv, tv), (js, ts)):
        np.testing.assert_array_equal(t.rows, j.rows)
        np.testing.assert_array_equal(t.counts, j.counts)


def test_pack_matches_jax(pipeline):
    """The JAX package's trained OPQ carried across: byte-equal records,
    descriptor codes and header; PQ codes equal but at near ties (within
    1e-4 of the best sim)."""
    jf, tf = _files(pipeline["index"]["jax"]), _files(pipeline["index"]["port"])
    assert sorted(tf) == sorted(jf)
    for name in ("index.bin", "index.descriptor-codes.bin", "index.msgpack"):
        assert tf[name] == jf[name], name
    pq = pipeline["pq"]
    jc = np.frombuffer(jf["index.pq-codes.bin"], np.uint8).reshape(N, pq.n_chunks)
    tc = np.frombuffer(tf["index.pq-codes.bin"], np.uint8).reshape(N, pq.n_chunks)
    r_i, k_i = np.nonzero(jc != tc)
    xt = pipeline["vectors"] @ pq.transform.T
    sims = np.einsum("rd,crd->rc", xt.reshape(N, pq.n_chunks, -1)[r_i, k_i],
                     pq.centroids.reshape(pq.n_centroids, pq.n_chunks, -1)[:, k_i])
    gap = sims.max(1, initial=-np.inf) - sims[np.arange(len(r_i)), tc[r_i, k_i]]
    assert (gap <= 1e-4).all(), gap
    for a, b in zip(pipeline["cdfs"]["port"], pipeline["cdfs"]["jax"]):
        np.testing.assert_array_equal(a, b)


def _ids_scores(res):
    return [r.id for r in res[0]], np.asarray([r.score for r in res[0]]), (
        res[1].node_reads, res[1].pq_comparisons)


@pytest.mark.parametrize("reader", ["native", "python"])
def test_disk_index_matches_jax(pipeline, reader):
    """The port's DiskIndex over the JAX-built index returns the JAX
    package's ids, scores within 1e-5 and counters, sliders on and off,
    one shard and every shard; with the native reader it runs NativeNav."""
    out_dir = pipeline["index"]["jax"]
    path = os.path.join(out_dir, "index.bin")
    if reader == "native":
        t, j = tdi.DiskIndex(out_dir), jdi.DiskIndex(out_dir)
        assert t._nav is not None and j._nav is not None
    else:
        t = tdi.DiskIndex(out_dir, io_backend=tnio.PythonReader(path, 4096))
        j = jdi.DiskIndex(out_dir, io_backend=jnio.PythonReader(path, 4096))
        assert t._nav is None
    vectors = pipeline["vectors"]
    rng = np.random.default_rng(11)
    for qi in rng.integers(0, N, 4):
        for scales in (None, np.array([1 / 512, 0, -1 / 512, 0], np.float32)):
            for dedup in (False, True):
                kw = dict(beamwidth=3, search_list=150, descriptor_scales=scales, dedup=dedup)
                ti, ts, tcn = _ids_scores(t.search(vectors[qi], 10, **kw))
                ji, js, jcn = _ids_scores(j.search(vectors[qi], 10, **kw))
                assert ti == ji and tcn == jcn
                np.testing.assert_allclose(ts, js, rtol=0, atol=SCORE_TOL)
        ti, ts, tcn = _ids_scores(t.search_all_shards(vectors[qi], 10, search_list=150))
        ji, js, jcn = _ids_scores(j.search_all_shards(vectors[qi], 10, search_list=150))
        assert ti == ji and tcn == jcn
        np.testing.assert_allclose(ts, js, rtol=0, atol=SCORE_TOL)
    for tn, jn in zip(t.read_nodes([0, 5, N - 1]), j.read_nodes([0, 5, N - 1])):
        assert (tn.id, list(tn.vertices), tn.url, list(tn.shards), tn.timestamp, tuple(tn.dimensions)) == (
            jn.id, list(jn.vertices), jn.url, list(jn.shards), jn.timestamp, tuple(jn.dimensions))
        np.testing.assert_array_equal(tn.vector, jn.vector)


def test_evaluate_matches_jax(pipeline):
    out_dir, vectors = pipeline["index"]["jax"], pipeline["vectors"]
    qs = vectors[np.random.default_rng(5).integers(0, N, 8)]
    got = tdi.DiskIndex(out_dir).evaluate(qs, k=10, beamwidth=3, search_list=300, device=CPU)
    want = jdi.DiskIndex(out_dir).evaluate(qs, k=10, beamwidth=3, search_list=300)
    assert got == want
    assert got["recall"] > 0.7
    flat = tdi.DiskIndex(out_dir).evaluate(qs, k=10, beamwidth=3, search_list=300,
                                           corpus=vectors.astype(np.float16), device=CPU)
    assert flat == got


def test_native_stitch_refill_matches_python_loop():
    """The native refill runs the reference's sequential loop (the JAX
    package's Python fallback, here) to the same graph and degrees."""
    rng = np.random.default_rng(3)
    n, r, bp, max_add = 300, 16, 250, 5
    graph = np.full((n, r), -1, np.int32)
    for i in range(n):
        deg = int(rng.integers(0, r + 1))
        graph[i, :deg] = rng.choice(n, deg, replace=False)
    degrees = (graph >= 0).sum(axis=1).astype(np.int32)
    in_ns = rng.integers(0, bp, 400).astype(np.int32)
    cands = rng.integers(-1, n, (400, r)).astype(np.int32)
    want, want_deg = graph.copy(), degrees.copy()
    for p_idx, in_n in enumerate(in_ns):
        added, deg = 0, want_deg[in_n]
        existing = set(want[in_n, :deg].tolist())
        for cand in cands[p_idx].tolist():
            if added >= max_add or deg >= r:
                break
            if cand < 0 or cand >= bp or cand in existing:
                continue
            want[in_n, deg] = cand
            existing.add(cand)
            deg += 1
            added += 1
        want_deg[in_n] = deg
    got = graph.copy()
    tnio.native_stitch_refill(got, degrees, in_ns, cands, bp, max_add, r)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tnio.native_stitch_refill(got.astype(np.int64), degrees, in_ns, cands, bp, max_add, r)


def _copy_split(pipeline, dst):
    """The port's split (inputs and assignment) and the flat fp16 corpus in
    ``dst``: what --frugal-disk leaves before it deletes the inputs."""
    shard_dir = os.path.join(dst, "shards")
    shutil.copytree(pipeline["split"]["port"][0], shard_dir)
    flat = os.path.join(dst, "vectors.f16")
    pipeline["vectors"].astype(np.float16).tofile(flat)
    return shard_dir, flat, _files(shard_dir)


def test_resplit_refuses_an_unverified_replay(pipeline, tmp_path):
    """A replayed assignment that no built graph verified is neither
    persisted nor used unless ``allow_unverified=True``: the JAX package
    takes ``verify_built=False`` as leave (processor.py:386), the port does
    not. With leave, or against a built graph, the inputs come back
    byte-exactly."""
    cents = pipeline["centroids"]
    shard_dir, flat, originals = _copy_split(pipeline, tmp_path / "port")
    apath = str(tmp_path / "assignment.npy")
    os.remove(os.path.join(shard_dir, "shard_1.msgpack"))
    for verify in (True, False):
        with pytest.raises(RuntimeError, match="verified against no built graph"):
            tproc.regenerate_shard_inputs(flat, N, cents, shard_dir, assignment_path=apath,
                                          verify_built=verify)
        assert not os.path.exists(apath)
        assert not os.path.exists(os.path.join(shard_dir, "shard_1.msgpack"))
    # the JAX package persists the same unverified replay
    jdir, jflat, _ = _copy_split(pipeline, tmp_path / "jax")
    os.remove(os.path.join(jdir, "shard_1.msgpack"))
    jproc.regenerate_shard_inputs(jflat, N, cents, jdir, assignment_path=str(tmp_path / "j.npy"),
                                  verify_built=False)
    assert os.path.exists(tmp_path / "j.npy")

    summary = tproc.regenerate_shard_inputs(flat, N, cents, shard_dir, assignment_path=apath,
                                            verify_built=False, allow_unverified=True)
    assert summary == {"regenerated": 1, "verified_shards": 0, "records": int(
        (pipeline["split"]["port"][3] == 1).any(axis=1).sum())}
    assert _files(shard_dir) == originals
    np.testing.assert_array_equal(np.load(apath), pipeline["split"]["port"][3])

    # against a built graph: from the saved assignment, from a replay, and
    # a divergent replay refused with nothing written
    shutil.copy(pipeline["graphs"][0], os.path.join(shard_dir, "shard_0.graph"))
    originals = _files(shard_dir)
    for saved in (True, False):
        if not saved:
            os.remove(apath)
        os.remove(os.path.join(shard_dir, "shard_2.msgpack"))
        summary = tproc.regenerate_shard_inputs(flat, N, cents, shard_dir, assignment_path=apath)
        assert summary["regenerated"] == 1 and summary["verified_shards"] == 1
        assert _files(shard_dir) == originals
    os.remove(apath)
    os.remove(os.path.join(shard_dir, "shard_2.msgpack"))
    with pytest.raises(RuntimeError, match="divergent"):
        tproc.regenerate_shard_inputs(flat, N, cents[::-1].copy(), shard_dir, assignment_path=apath)
    assert not os.path.exists(apath)
    assert not os.path.exists(os.path.join(shard_dir, ".resplit_tmp"))


def test_failed_native_build_raises(pipeline, tmp_path, monkeypatch):
    """A libdiskio.so that does not build raises with the compiler's output,
    from the reader, the index, the stitch and the packer: nothing falls
    back to the Python reader. Naming the Python reader still works."""
    src = tmp_path / "native"
    src.mkdir()
    for name in tnio.SOURCES:
        shutil.copy(os.path.join(tnio.NATIVE_DIR, name), src / name)
    (src / "diskio.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(tnio, "NATIVE_DIR", src)
    monkeypatch.setattr(tnio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnio, "_lib", None)
    out_dir = pipeline["index"]["jax"]
    with pytest.raises(RuntimeError, match="building libdiskio.so failed") as e:
        tnio.open_reader(os.path.join(out_dir, "index.bin"), 4096)
    assert "diskio.cpp" in str(e.value)
    with pytest.raises(RuntimeError, match="building libdiskio.so failed"):
        tdi.DiskIndex(out_dir)
    graph = np.zeros((4, 2), np.int32)
    with pytest.raises(RuntimeError, match="building libdiskio.so failed"):
        tnio.native_stitch_refill(graph, np.zeros(4, np.int32), np.zeros(1, np.int32),
                                  np.zeros((1, 2), np.int32), 2, 1, 2)
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())
    idx = tdi.DiskIndex(out_dir, io_backend=tnio.PythonReader(os.path.join(out_dir, "index.bin"), 4096))
    assert idx._nav is None and len(idx.search(pipeline["vectors"][3], 5)[0]) == 5


def test_native_library_builds_once_under_a_lock(tmp_path, monkeypatch):
    """A fresh build directory gets one library named by its digest, which
    later loads reuse; the Makefile's flags are the build's."""
    monkeypatch.setattr(tnio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnio, "_lib", None)
    lib = tnio.load_native()
    assert tnio.load_native() is lib
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert built == [".lock", f"libdiskio-{tnio._digest()}.so"]
    make = open(os.path.join(tnio.NATIVE_DIR, "Makefile")).read()
    assert f"CXXFLAGS ?= {' '.join(tnio.CXXFLAGS)}" in make
    assert f"LDFLAGS ?= {' '.join(tnio.LDFLAGS)}" in make


def test_native_pack_records_byte_parity():
    """native/pack.cpp through the port's binding equals the port's
    PackedIndexEntry.pack_ex across the msgpack width breakpoints and the
    oversize-URL dead path (tests/test_disk_pipeline.py:875)."""
    rng = np.random.default_rng(0)
    n, d, pad, ids0 = 300, 96, 1024, 120
    verts = np.full((n, 70), -1, np.int32)
    vcounts = np.zeros(n, np.int32)
    shards = np.full((n, 2), -1, np.int32)
    scounts = np.zeros(n, np.int32)
    urls, ts, dims = [], [], []
    scores = rng.standard_normal((n, 3)).astype(np.float32)
    breakvals = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**31 - 1]
    for i in range(n):
        nv = int(rng.integers(0, 70))
        verts[i, :nv] = np.asarray(rng.choice(breakvals + list(rng.integers(0, 10**7, 20)), nv),
                                   np.int64).astype(np.int32)
        vcounts[i] = nv
        ns = int(rng.integers(1, 3))
        shards[i, :ns] = rng.integers(0, 4200, ns)
        scounts[i] = ns
        ts.append(int(rng.choice(breakvals + [2**32, 2**34])))
        dims.append([int(rng.integers(0, 70000)), int(rng.integers(0, 70000))])
        urls.append("u" * int(rng.choice([0, 5, 31, 32, 255, 256, 700])))
    vecs = rng.standard_normal((n, d)).astype(np.float16)
    want = [tformats.PackedIndexEntry(
        id=ids0 + i, vector=vecs[i], vertices=verts[i, : vcounts[i]], timestamp=ts[i],
        dimensions=tuple(dims[i]), scores=[float(s) for s in scores[i]], url=urls[i],
        shards=shards[i, : scounts[i]]).pack_ex(pad) for i in range(n)]
    got, got_dead = tnio.native_pack_records(
        vecs, verts, vcounts, ids0, np.asarray(ts, np.int64), np.asarray(dims, np.int64),
        scores.astype(np.float64), urls, shards, scounts, pad)
    assert got == b"".join(w for w, _ in want)
    assert list(got_dead) == [dead for _, dead in want] and any(got_dead)
    with pytest.raises(ValueError):
        tnio.native_pack_records(vecs, verts, vcounts, ids0, np.asarray(ts, np.int64),
                                 np.zeros((n, 3), np.int64), None, urls, shards, scounts, pad)


def test_pack_index_padded_equals_lists(tmp_path):
    """pack_index over padded adjacency (the native packer) writes the bytes
    of pack_ex over each record's lists, and counts the dead record; a
    manifest whose dimensions are not pairs raises."""
    rng = np.random.default_rng(7)
    n, d = 257, 64
    vectors = rng.standard_normal((n, d)).astype(np.float16)
    rows = np.full((n, 8), -1, np.int32)
    counts = rng.integers(0, 8, n).astype(np.int32)
    for i in range(n):
        rows[i, : counts[i]] = rng.integers(0, n, counts[i])
    srows = np.full((n, 2), -1, np.int32)
    srows[:, 0] = rng.integers(0, 3, n)
    scounts = np.ones(n, np.int32)
    manifest = [{"timestamp": 1700000000 + i, "dimensions": (64, 48),
                 "url": ("https://x.test/" + "a" * 4096) if i == 5 else f"https://x.test/{i}"}
                for i in range(n)]
    pq = ProductQuantizer(centroids=rng.standard_normal((16, d)).astype(np.float32),
                          transform=np.eye(d, dtype=np.float32), n_dims_per_code=8, n_dims=d)
    cents = rng.standard_normal((3, d)).astype(np.float32)
    padded = (tproc.PaddedAdjacency(rows, counts), tproc.PaddedAdjacency(srows, scounts))
    hdr = tproc.pack_index(str(tmp_path / "padded"), vectors, *padded, manifest, pq, cents, [0, 1, 2],
                           batch_size=100, device=CPU)
    want = [tformats.PackedIndexEntry(
        id=i, vector=vectors[i], vertices=rows[i, : counts[i]].tolist(), timestamp=manifest[i]["timestamp"],
        dimensions=(64, 48), scores=[], url=manifest[i]["url"], shards=srows[i, :1].tolist()).pack_ex()
        for i in range(n)]
    assert _files(str(tmp_path / "padded"))["index.bin"] == b"".join(r for r, _dead in want)
    assert hdr.dead_count == sum(dead for _r, dead in want) == 1  # the oversize URL at i = 5
    odd = [dict(m, dimensions=(64, 48, 3)) for m in manifest]
    with pytest.raises(ValueError, match="dims"):
        tproc.pack_index(str(tmp_path / "odd"), vectors, *padded, odd, pq, cents, [0, 1, 2],
                         batch_size=100, device=CPU)


def test_coverage_build_order_matches_jax():
    rng = np.random.default_rng(0)
    n, c = 5000, 6
    a = np.stack([rng.integers(0, c, n), rng.integers(0, c, n)], axis=1).astype(np.int32)
    for built in ([], [2], [0, 5]):
        got = tproc.coverage_build_order(a, built, c)
        assert got == jproc.coverage_build_order(a, built, c)
        assert sorted(got + built) == list(range(c))


def test_dedup_and_simhash_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, D)).astype(np.float32)
    assert tproc.simhash_batch(x) == jproc.simhash_batch(x) == [jproc.simhash(r) for r in x]
    codes = tproc.simhash_batch(np.concatenate([x, x[:5]]))
    ring_t, ring_j = tproc.DedupRing(capacity=60), jproc.DedupRing(capacity=60)
    got = [ring_t.admit_codes(c_, tproc.url_hash(str(i % 50))) for i, c_ in enumerate(codes)]
    want = [ring_j.admit_codes(c_, jproc.url_hash(str(i % 50))) for i, c_ in enumerate(codes)]
    assert got == want and ring_t.deduped == ring_j.deduped > 0


def test_numpy_loop_equals_native_beyond_near_ties(tmp_path):
    """The port's numpy loop sums the ADC chunk by chunk and breaks score
    ties by id, as the native loop does, so the two agree exactly on a
    30,000-record index where the JAX package's loop (pairwise sums,
    argpartition's tie order) leaves its native loop on query 2 (the quirk
    the port does not copy)."""
    from meme_search_engine_tpu_torch.tools import synth_disk_index

    out = str(tmp_path / "index")
    synth_disk_index.main(["--out", out, "--n", "30000", "--d", "64", "--r", "16", "--shards", "3",
                           "--chunks", "32", "--device", CPU])
    path = os.path.join(out, "index.bin")
    native, numpy_loop = tdi.DiskIndex(out), tdi.DiskIndex(out, io_backend=tnio.PythonReader(path, 4096))
    jax_loop = jdi.DiskIndex(out, io_backend=jnio.PythonReader(path, 4096))
    rng = np.random.default_rng(0)
    jax_differs = []
    for qi in range(12):
        q = rng.standard_normal(64).astype(np.float32)
        kw = dict(beamwidth=4, search_list=300, dedup=bool(qi % 2),
                  descriptor_scales=np.array([1 / 512, 0, -3 / 512, 0], np.float32) if qi % 3 == 0 else None)
        ni, ns, nc = _ids_scores(native.search(q, 20, **kw))
        pi, ps, pc = _ids_scores(numpy_loop.search(q, 20, **kw))
        assert (pi, pc) == (ni, nc), qi
        np.testing.assert_allclose(ps, ns, rtol=0, atol=SCORE_TOL)
        ji, _js, jc = _ids_scores(jax_loop.search(q, 20, **kw))
        if (ji, jc) != (ni, nc):
            jax_differs.append(qi)
    assert jax_differs == [2]
