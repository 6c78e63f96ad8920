"""Each cell's path end to end on the CPU, cut to the tiny model: the
harness, the system driver, the metric readers and the comparison with
the reference; and the import checks."""

import ast
import json
import os
import subprocess
import sys

import pytest

from port_bench import harness

from conftest import ROOT, tiny_overrides

CELLS = [w["name"] for w in harness._load("..", "BENCHMARK.json")["workloads"]]


def dry_run(cell, capsys, trace=0, seed=4294967311):
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "1.5",
                       "--trace", str(trace)], cpu=True, overrides=tiny_overrides(cell))
    out, err = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_dry_run(cell, trace, capsys):
    result, err = dry_run(cell, capsys, trace)
    assert result["correct"] is True and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
    bench = harness._load("..", "BENCHMARK.json")
    key = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.selected(bench, key, cell)}
    device_only = {m["name"] for m in bench[key] if m["source"] == "device_trace"}
    # the CPU has no device trace: those readers find nothing and stay out
    assert set(result["metrics"]) == want - device_only
    for m in result["metrics"].values():
        assert m["value"] > 0
    last = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") for line in last)


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = harness._load("..", "BENCHMARK.json")
    here = os.path.join(ROOT, "port_bench")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(here, "metrics", m["name"] + ".py")), m["name"]
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        for path in (("workloads", w["name"] + ".json"), ("traffic", w["traffic"] + ".json"),
                     ("configs", w["config"] + ".json")):
            assert os.path.isfile(os.path.join(here, *path))
        system = harness._load("workloads", w["name"] + ".json")["system"]
        assert os.path.isfile(os.path.join(here, "systems", system + ".py"))
        for t in harness._load("traffic", w["traffic"] + ".json")["terms"]:
            assert os.path.isfile(os.path.join(here, "terms", t["kind"] + ".py"))


def test_a_cell_not_in_the_benchmark_is_refused():
    with pytest.raises(SystemExit, match="BENCHMARK.json"):
        harness.setup(["--workload", "query-text", "--seed", "1", "--seconds", "1"])


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "meme_search_engine_tpu_torch_x", sys)
    assert "meme_search_engine_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "meme_search_engine_tpu.serving", sys)
    assert harness.forbidden_modules() == ["meme_search_engine_tpu"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    """In a fresh process: a whole dry run, then no loaded module's
    top-level name is jax, jaxlib, flax or the JAX package."""
    code = (
        "import sys, json, io, contextlib; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from conftest import tiny_overrides\n"
        "from port_bench import harness\n"
        "with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):\n"
        "    rc = harness.main(['--workload', %r, '--seed', '3', '--seconds', '1', '--trace', '1'],"
        " cpu=True, overrides=tiny_overrides(%r))\n"
        "print(json.dumps({'rc': rc, 'bad': harness.forbidden_modules(),"
        " 'port': 'meme_search_engine_tpu_torch' in sys.modules}))\n"
    ) % (ROOT, os.path.dirname(__file__), cell, cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"rc": 0, "bad": [], "port": True}


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(ROOT, "port_bench", "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "flax", "meme_search_engine_tpu",
                                               "meme_search_engine_tpu_torch"), (name, m)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.reference.siglip, port_bench.data, port_bench.judge\n"
            "from port_bench import generate\n"
            "generate.term('image_array')\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('meme_search')"
            " or m.split('.')[0] in ('jax', 'jaxlib', 'flax')))") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_no_result_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        harness.main(["--workload", "ingest-img128", "--seed", "1", "--seconds", "1"])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card):
    """A short run of the cell as committed, on the card."""
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
