"""The generator: mixes made of term and arrival files found by name,
fixed multisets across seeds, the closed loop's order."""

import json
import os
import types

import numpy as np
import pytest

from port_bench import data, generate

from conftest import ROOT, TINY

PICS = {"kind": "image_array", "weight": 1, "batch": 2, "cells": 6, "noise": 24.0}


def test_an_open_mix_of_two_terms_takes_its_parts_by_name(monkeypatch):
    """Two kinds of request 3 : 1 at due times from an arrival process
    found by name: every seed gets the same due times and kinds, and
    inputs of its own."""
    every = types.SimpleNamespace(due=lambda spec, rate, seconds: np.arange(
        int(rate * seconds)) / rate)
    monkeypatch.setitem(generate._loaded, ("arrivals", "every"), every)
    mix = {"loop": "open", "arrivals": {"process": "every"}, "order_seed": 9,
           "terms": [{**PICS, "weight": 3}, {**PICS, "batch": 1, "noise": 0.0}]}
    a = generate.make(mix, 11, model=TINY, device="cpu", rate=8.0, seconds=2.0)
    b = generate.make(mix, 2**32 + 12, model=TINY, device="cpu", rate=8.0, seconds=2.0)
    np.testing.assert_array_equal(a.due, b.due)
    assert len(a.due) == 16
    sizes = [len(x) for x in a.inputs]
    assert sizes == [len(x) for x in b.inputs] and sizes.count(2) == 12 and sizes.count(1) == 4
    assert not all(np.array_equal(x, y) for x, y in zip(a.inputs, b.inputs))


def test_a_closed_mix_is_a_pool_in_a_seeded_order():
    mix = {"loop": "closed", "pool": 3, "order_seed": 1, "terms": [PICS]}
    t = generate.make(mix, 5, model=TINY, device="cpu")
    assert t.due is None and t.kinds == ["image_array"] * 3
    pics = np.concatenate(t.inputs)
    assert pics.shape == (6, TINY["image_size"], TINY["image_size"], 3)
    assert pics.dtype == np.uint8
    assert len({p.tobytes() for p in pics}) == 6  # no two alike
    a, b = generate.closed_order(4, 1), generate.closed_order(4, 2**33)
    assert sorted(a) == sorted(b) == [0, 1, 2, 3]


def test_every_mix_file_reads():
    here = os.path.join(ROOT, "port_bench", "traffic")
    for name in os.listdir(here):
        with open(os.path.join(here, name)) as f:
            mix = json.load(f)
        mix["terms"] = [{**t, "batch": 2} for t in mix["terms"]]
        t = generate.make({**mix, "pool": 2}, 3, model=TINY, device="cpu")
        assert len(t.inputs) == 2 and all(len(x) == 2 for x in t.inputs)


def test_allot_is_a_fixed_multiset():
    out = generate.allot({"1": 1, "2": 2, "3": 1}, 10)
    assert sorted(out.tolist()) == [1.0] * 3 + [2.0] * 5 + [3.0] * 2 or \
        sorted(out.tolist()) == [1.0] * 2 + [2.0] * 5 + [3.0] * 3
    assert len(generate.allot({"1": 14, "12": 1}, 733)) == 733


def test_a_missing_kind_is_named():
    with pytest.raises(SystemExit, match="terms"):
        generate.term("no-such-kind")


def test_sub_seeds_take_large_seeds():
    s = data.sub_seed(2**33 + 5, "weights")
    assert 0 <= s < 2**63 and s != data.sub_seed(5, "weights")
