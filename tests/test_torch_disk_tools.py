"""The port's disk tools (meme_search_engine_tpu_torch/tools/{scale_bench,
ann_bench,synth_disk_index,recall_sweep,disk_serve_bench,
generate_queries_bin}.py) on the CPU at miniature sizes, against the JAX
package's tools where both produce the same artifact from the same seed.
"""

import http.server
import json
import os
import shutil
import threading

import numpy as np
import pytest

from meme_search_engine_tpu.pipeline import dump as jdump
from meme_search_engine_tpu.tools import generate_queries_bin as jgen
from meme_search_engine_tpu.tools import recall_sweep as jsweep
from meme_search_engine_tpu.tools import scale_bench as jscale
from meme_search_engine_tpu.tools import synth_disk_index as jsynth
from meme_search_engine_tpu_torch.pipeline import dump as tdump
from meme_search_engine_tpu_torch.tools import ann_bench, disk_serve_bench, scale_bench, synth_disk_index
from meme_search_engine_tpu_torch.tools import generate_queries_bin as tgen
from meme_search_engine_tpu_torch.tools import recall_sweep as tsweep

# tests/test_disk_pipeline.py:398's miniature geometry, on the CPU
MINI = [
    "--n", "400", "--clusters", "3", "--r", "8", "--l", "16", "--maxc", "32",
    "--build-batch", "128", "--serve-queries", "8", "--eval-queries", "8",
    "--search-list", "64", "--beamwidth", "2", "--pq-chunks", "8",
    "--pq-centroids", "16", "--ood-queries", "16", "--device", "cpu",
]


@pytest.fixture(autouse=True)
def _isolate_port_lease(tmp_path, monkeypatch):
    """The port's scale_bench advertises the chip lease: point its busy
    file at a per-test path, as conftest.py does for the JAX package's."""
    from meme_search_engine_tpu_torch.utils import tpu_lease

    monkeypatch.setattr(tpu_lease, "BUSY_PATH", str(tmp_path / "tpu_busy.json"))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_scale_bench_end_to_end_and_resumed(tmp_path, capsys):
    """The whole staged pipeline, then a second run that reuses every
    artifact, the host-only recall sweep over its oracle, and the resplit
    stage after a --frugal-disk style deletion."""
    wd = str(tmp_path / "scale")
    scale_bench.main(["--workdir", wd, *MINI])
    report = json.load(open(f"{wd}/report.json"))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert report["n"] == 400 and report["shards_built"] == 3
    assert set(report["qps_vs_threads"]) == {"1", "2", "4"}
    assert report["eval"]["recall_at_20"] > 0.3 and report["eval"]["median_rank"] <= 20
    assert report["eval"]["allshards_queries"] == 8
    for stage in ("kmeans", "shard_split", "shard_builds", "collect_vectors", "opq_train", "pack", "eval"):
        assert stage in report["stages_s"]
    graphs = {p: os.path.getmtime(os.path.join(wd, "shards", p))
              for p in os.listdir(os.path.join(wd, "shards")) if p.endswith(".graph")}
    assert len(graphs) == 3

    scale_bench.main(["--workdir", wd, *MINI])
    report2 = json.load(open(f"{wd}/report.json"))
    assert report2["stages_s"]["shard_builds"] == report["stages_s"]["shard_builds"]
    assert "shards_built" not in report2
    assert report2["eval"]["recall_at_20"] == report["eval"]["recall_at_20"]
    for p, mt in graphs.items():
        assert os.path.getmtime(os.path.join(wd, "shards", p)) == mt

    rows = tsweep.main(["--index", os.path.join(wd, "index"), "--oracle", os.path.join(wd, "eval_oracle.npz"),
                        "--search-lists", "64", "--beamwidth", "2", "--queries", "8"])
    assert rows[0]["recall_at_20"] == report["eval"]["recall_at_20"]

    inputs = {s: _read(os.path.join(wd, "shards", f"shard_{s}.msgpack")) for s in range(3)}
    for s in range(3):
        os.remove(os.path.join(wd, "shards", f"shard_{s}.msgpack"))
    scale_bench.main(["--workdir", wd, "--n", "400", "--clusters", "3", "--stage", "resplit"])
    for s in range(3):
        assert _read(os.path.join(wd, "shards", f"shard_{s}.msgpack")) == inputs[s]
    assert "resplit" in json.load(open(f"{wd}/report.json"))["stages_s"]


def test_scale_bench_matches_jax(tmp_path):
    """The JAX tool and the port's from the same seeds: the same dump
    records and k-means sample; given the JAX run's centroids the same split
    (manifest, assignment, shard inputs); given its graphs and OPQ as well,
    the same flat corpus, index files, eval oracle and eval. The k-means'
    annealing noise, the graph builds and the OPQ training are the port's
    own draws and are held against the JAX package in their own tests
    (tests/test_torch_{kmeans,quantizers,build_shard,vamana_build}.py)."""
    jw, tw = str(tmp_path / "jax"), str(tmp_path / "port")
    jscale.main(["--workdir", jw, *MINI[:-2]])
    # the JAX tail once more with its OPQ reloaded, as the port's runs it: a
    # reload skips the OPQ sample's draw from the run's generator, which
    # moves the synthetic quality scores drawn after it
    shutil.rmtree(os.path.join(jw, "index"))
    jscale.main(["--workdir", jw, *MINI[:-2]])
    os.makedirs(os.path.join(tw, "shards"))
    for name in ["centroids.npy", "opq.msgpack"] + [f"shards/shard_{s}.graph" for s in range(3)]:
        shutil.copy(os.path.join(jw, name), os.path.join(tw, name))
    scale_bench.main(["--workdir", tw, *MINI])

    dump = "000000001.dump.zst"
    want = [e.to_dict() for e in jdump.read_dump(os.path.join(jw, dump))]
    assert len(want) == 400
    assert [e.to_dict() for e in jdump.read_dump(os.path.join(tw, dump))] == want
    assert [e.to_dict() for e in tdump.read_dump(os.path.join(tw, dump))] == want
    for name in ["sample.npy", "assignment.npy", "vectors.f16"] + [f"shards/shard_{s}.msgpack" for s in range(3)]:
        assert _read(os.path.join(tw, name)) == _read(os.path.join(jw, name)), name
    manifests = [list(np.load(os.path.join(w, "manifest.npy"), allow_pickle=True)) for w in (tw, jw)]
    assert manifests[0] == manifests[1]
    for name in ["index.bin", "index.descriptor-codes.bin", "index.msgpack", "index.pq-codes.bin"]:
        assert _read(os.path.join(tw, "index", name)) == _read(os.path.join(jw, "index", name)), name
    oracles = [np.load(os.path.join(w, "eval_oracle.npz")) for w in (tw, jw)]
    np.testing.assert_array_equal(oracles[0]["queries"], oracles[1]["queries"])
    np.testing.assert_array_equal(oracles[0]["gt"], oracles[1]["gt"])
    reports = [json.load(open(os.path.join(w, "report.json"))) for w in (tw, jw)]
    assert reports[0]["eval"] == reports[1]["eval"]


def test_scale_bench_max_build_records_resume_loop(tmp_path):
    """With --max-build-records each pass exits 3 once its budget is spent,
    after the builds once more, and the last pass runs the tail; --frugal-
    disk deletes the dump and the shard inputs on the way."""
    wd = str(tmp_path / "scale")
    argv = ["--workdir", wd, *MINI, "--eval-queries-allshards", "0", "--max-build-records", "1",
            "--frugal-disk"]
    exits = 0
    for _pass in range(10):
        try:
            scale_bench.main(argv)
            break
        except SystemExit as e:
            assert e.code == 3
            exits += 1
    else:
        pytest.fail("the resume loop did not converge in 10 passes")
    assert exits >= 3
    report = json.load(open(f"{wd}/report.json"))
    assert report["eval"]["recall_at_20"] > 0.3 and report["stages_s"]["shard_builds"] > 0
    assert not os.path.exists(os.path.join(wd, "000000001.dump.zst"))
    assert not any(p.endswith(".msgpack") for p in os.listdir(os.path.join(wd, "shards")))


def test_scale_bench_prep_stage(tmp_path):
    wd = str(tmp_path / "scale")
    scale_bench.main(["--workdir", wd, *MINI, "--stage", "prep"])
    assert sorted(os.listdir(os.path.join(wd, "shards"))) == [f"shard_{s}.msgpack" for s in range(3)]
    assert not os.path.exists(os.path.join(wd, "index"))


def test_ann_bench_small(capsys):
    ann_bench.main(["--n", "400", "--d", "32", "--r", "8", "--l", "24", "--maxc", "48",
                    "--batch-size", "128", "--eval-queries", "32", "--device", "cpu"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["n"] == 400 and stats["recall@10"] > 0.7 and stats["self_recall@1"] > 0.9
    assert stats["qps"] > 0


@pytest.mark.parametrize("stream", [False, True])
def test_synth_disk_index_matches_jax_and_serves(tmp_path, capsys, stream):
    """From the same seed the port writes the JAX tool's records,
    descriptor codes and header byte for byte, and PQ codes equal but at
    near ties; the serve bench and the recall sweep then run over it, the
    sweep's rows equal to the JAX tool's over the same index and oracle."""
    n, d, chunks = 3000, 64, 8
    args = ["--n", str(n), "--d", str(d), "--r", "8", "--shards", "3", "--chunks", str(chunks)]
    if stream:
        args.append("--stream")
    else:
        args.append("--save-flat")
    port, jax_ = str(tmp_path / "port"), str(tmp_path / "jax")
    synth_disk_index.main(["--out", port, *args, "--device", "cpu"])
    jsynth.main(["--out", jax_, *args])
    names = ["index.bin", "index.descriptor-codes.bin", "index.msgpack"] + ([] if stream else ["vectors.f16"])
    for name in names:
        assert _read(os.path.join(port, name)) == _read(os.path.join(jax_, name)), name
    tc = np.frombuffer(_read(os.path.join(port, "index.pq-codes.bin")), np.uint8)
    jc = np.frombuffer(_read(os.path.join(jax_, "index.pq-codes.bin")), np.uint8)
    assert tc.shape == jc.shape == (n * chunks,) and (tc == jc).mean() > 0.999
    capsys.readouterr()

    report = disk_serve_bench.main(["--index", port, "--queries", "16", "--threads", "1,2",
                                    "--warmup", "4", "--search-list", "64"])
    assert set(report["qps_vs_threads"]) == {1, 2} and report["node_reads_per_query"] > 0
    assert report["p99_ms"] >= report["p50_ms"] > 0
    if stream:
        return
    flat = np.fromfile(os.path.join(port, "vectors.f16"), np.float16).reshape(n, d).astype(np.float32)
    qs = np.random.default_rng(3).standard_normal((8, d)).astype(np.float32)
    gt = np.argsort(-(qs @ flat.T), axis=1, kind="stable")[:, :1000]
    np.savez(str(tmp_path / "oracle.npz"), queries=qs, gt=gt)
    sweep = ["--index", jax_, "--oracle", str(tmp_path / "oracle.npz"), "--search-lists", "32,64",
             "--beamwidth", "2,3", "--queries", "8"]
    drop = ("qps", "mean_ms")
    got = [{k: v for k, v in r.items() if k not in drop} for r in tsweep.main(sweep)]
    want = [{k: v for k, v in r.items() if k not in drop} for r in jsweep.main(sweep)]
    assert got == want and len(got) == 4


class _Stub(http.server.BaseHTTPRequestHandler):
    """A clip server's text endpoint: msgpack {"text": [...]} in, a list of
    fp16 embeddings out, each drawn from its text."""

    def do_POST(self):
        import msgpack

        body = msgpack.unpackb(self.rfile.read(int(self.headers["Content-Length"])), raw=False)
        out = [np.random.default_rng(sum(t.encode())).standard_normal(16).astype("<f2").tobytes()
               for t in body["text"]]
        data = msgpack.packb(out)
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


def test_generate_queries_bin_against_a_local_stub(tmp_path):
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        lines = [f"query number {i}" for i in range(7)] + ["", "last one"]
        (tmp_path / "q.txt").write_text("\n".join(lines) + "\n")
        for name, mod in (("port", tgen), ("jax", jgen)):
            mod.main(["--server", url, "--input", str(tmp_path / "q.txt"),
                      "--output", str(tmp_path / f"{name}.bin"), "--batch", "3"])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    got = _read(tmp_path / "port.bin")
    assert got == _read(tmp_path / "jax.bin")
    want = b"".join(np.random.default_rng(sum(t.encode())).standard_normal(16).astype("<f2").tobytes()
                    for t in lines if t)
    assert got == want
