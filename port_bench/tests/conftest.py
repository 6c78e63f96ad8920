"""Tests of the benchmark harness (``port_bench/``), apart from the
repository's ``tests/``: nothing here imports JAX. Run from the root:

    python -m pytest -q port_bench/tests

Tests marked ``cuda`` need a card and skip without one (decided in a
fixture, never at import).
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(image_size=28, patch_size=14, width=64, depth=2, mlp_dim=128, num_heads=4,
            text_width=64, text_depth=2, text_mlp_dim=128, text_num_heads=4, vocab_size=128,
            text_len=16, d_emb=64)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU and nvcc (skips without them)")


def tiny_overrides(cell: str) -> dict:
    """A cell cut to the CPU: the tiny two-tower model, requests of 8
    inputs, a pool of 2, a sample of 4."""
    import json

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        mix = {w["name"]: w["traffic"] for w in json.load(f)["workloads"]}[cell]
    with open(os.path.join(ROOT, "port_bench", "traffic", mix + ".json")) as f:
        terms = [{**t, "batch": 8} for t in json.load(f)["terms"]]
    return {"model": TINY, "config": {"max_batch": 8}, "workload": {"sample": 4},
            "traffic": {"pool": 2, "terms": terms}}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
