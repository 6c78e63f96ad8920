"""The port's copy of the chip-handoff protocol (utils/tpu_lease.py) and
its holder's safe points.

- The six cases of tests/test_tpu_lease.py, run on the port's module.
- ``pipeline/processor.pack_index`` calls its ``pause_point`` before
  every batch, as the JAX package's does.
- ``tools/scale_bench.py`` advertises the lease, holds it through every
  safe point of the JAX tool and clears it at the end.
"""

import json
import os

import numpy as np
import pytest
import test_tpu_lease as jax_cases
import torch

from meme_search_engine_tpu_torch.index.opq import ProductQuantizer
from meme_search_engine_tpu_torch.pipeline import processor
from meme_search_engine_tpu_torch.tools import scale_bench
from meme_search_engine_tpu_torch.utils import tpu_lease

CASES = sorted(n for n in dir(jax_cases) if n.startswith("test_"))


def test_the_jax_cases_are_six():
    assert len(CASES) == 6


@pytest.mark.parametrize("case", CASES)
def test_jax_case_on_the_port_copy(case, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_cases, "tpu_lease", tpu_lease)
    getattr(jax_cases, case)(tmp_path, monkeypatch)


def test_busy_path_is_the_jax_packages():
    from meme_search_engine_tpu.utils import tpu_lease as jax_lease

    # (the JAX module's own BUSY_PATH is moved per test by conftest.py)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(jax_lease.__file__))))
    assert tpu_lease.BUSY_PATH == os.path.join(root, ".tpu_busy.json")


def test_pack_index_pauses_before_every_batch(tmp_path):
    rng = np.random.default_rng(7)
    n, d = 257, 64
    vectors = rng.standard_normal((n, d)).astype(np.float16)
    rows = rng.integers(0, n, (n, 4)).astype(np.int32)
    srows = np.zeros((n, 1), np.int32)
    adjacency = (processor.PaddedAdjacency(rows, np.full(n, 4, np.int32)),
                 processor.PaddedAdjacency(srows, np.ones(n, np.int32)))
    manifest = [{"timestamp": 1700000000 + i, "dimensions": (64, 48), "url": f"https://x.test/{i}"}
                for i in range(n)]
    pq = ProductQuantizer(centroids=rng.standard_normal((16, d)).astype(np.float32),
                          transform=np.eye(d, dtype=np.float32), n_dims_per_code=8, n_dims=d)
    calls = []
    processor.pack_index(str(tmp_path), vectors, *adjacency, manifest, pq,
                         rng.standard_normal((1, d)).astype(np.float32), [0], batch_size=100,
                         device=torch.device("cpu"), pause_point=lambda: calls.append(len(calls)))
    assert len(calls) == 3  # batches of 100, 100 and 57


def test_scale_bench_holds_the_lease(tmp_path, monkeypatch):
    """Advertised before the first safe point (the busy file names this
    process and the workdir), a safe point at each of the JAX tool's
    sites, cleared at the end."""
    busy = tmp_path / "busy.json"
    monkeypatch.setattr(tpu_lease, "BUSY_PATH", str(busy))
    wd = str(tmp_path / "scale")
    seen = []

    def pause_point(log=None):
        seen.append(json.loads(busy.read_text()))

    monkeypatch.setattr(tpu_lease, "pause_point", pause_point)
    scale_bench.main([
        "--workdir", wd, "--n", "400", "--clusters", "3", "--r", "8", "--l", "16", "--maxc", "32",
        "--build-batch", "128", "--serve-queries", "8", "--eval-queries", "8", "--search-list", "64",
        "--beamwidth", "2", "--pq-chunks", "8", "--pq-centroids", "16", "--ood-queries", "16",
        "--device", "cpu",
    ])
    assert not busy.exists()
    assert all(s == {"pid": os.getpid(), "workdir": os.path.abspath(wd)} for s in seen)
    # 3 shard builds, 3 collected shards, OPQ's start, its 2 x 120 Adam
    # steps every 16th (16), 1 pack batch, the warm-up, 1 eval slab of 64
    # queries: the JAX tool's 26 on these arguments
    assert len(seen) == 3 + 3 + 1 + 16 + 1 + 1 + 1
