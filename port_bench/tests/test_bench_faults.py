"""A run with its timed path broken underneath comes out not correct, and
so does the control: the comparison with the reference has been seen to
fail. Each run is a whole dry run of the cell on the CPU at the tiny size
(the harness, the engine, the reference), with the look for a card skipped."""

import json

import numpy as np
import pytest

from port_bench import control, generate, harness

from conftest import tiny_overrides

CELLS = [w["name"] for w in harness._load("..", "BENCHMARK.json")["workloads"]]


def run_cell(cell, capsys, seed=2147483659):
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "1.5"],
                      cpu=True, overrides=tiny_overrides(cell))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def engine_calls(cell):
    mix = harness._load("traffic", harness.setup(
        ["--workload", cell, "--seed", "1", "--seconds", "1"]).cell["traffic"] + ".json")
    return sorted({generate.term(t["kind"]).ENGINE_CALL for t in mix["terms"]})


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(cell, capsys):
    assert run_cell(cell, capsys)["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["half_batch_left_out", "answers_altered"])
def test_engine_faults(cell, fault, capsys, monkeypatch):
    from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine

    for name in engine_calls(cell):
        orig = getattr(EmbeddingEngine, name)

        def broken(self, inputs, orig=orig):
            out = orig(self, inputs)
            if fault == "half_batch_left_out":
                out[len(out) // 2:] = 0.0
            else:  # each input gets its neighbour's embedding
                out = np.roll(out, 1, axis=0)
            return out

        monkeypatch.setattr(EmbeddingEngine, name, broken)
    result = run_cell(cell, capsys)
    assert result["correct"] is False
    assert result["checks"]["emb_err"]["value"] > result["checks"]["emb_err"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    """The reference one precision below the configuration's (fp8 towers),
    in the program's place, fails the limit."""
    ctx = harness.setup(["--workload", cell, "--seed", "7", "--seconds", "1.5"], cpu=True,
                        overrides=tiny_overrides(cell))
    ctx.device = harness.card_device(ctx)
    got = control.readings(ctx)
    limits = ctx.workload["limits"]
    assert any(got[k] > limits[k] for k in got), (got, limits)
