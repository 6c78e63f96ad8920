"""Multi-process dry run of the dp x tp train step and the sharded search.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``,
which forces a virtual CPU mesh of n devices: here n CPU processes on
the ``gloo`` backend form the mesh (data x model, model = 2 when n is
even), run one train step of ``tiny_test_config`` on a batch of 2 x data,
then search a (4,103 x 128) fp16 corpus sharded over ``data`` at k = 16
and hold it against the exact oracle. It runs on the CPU by design; the
caller asks for that by calling it.

    python -c "from meme_search_engine_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["dryrun_multichip", "spawn_gloo"]


def _init_and_run(rank: int, n: int, store_path: str, fn, args) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, n)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_gloo(fn, n: int, *args) -> None:
    """Run ``fn(rank, *args)`` in ``n`` spawned CPU processes joined by a
    ``gloo`` process group (a ``FileStore`` in a temporary directory);
    ``fn`` must be importable by name. Raises if any rank fails."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_init_and_run, args=(n, os.path.join(tmp, "store"), fn, args),
                 nprocs=n, join=True)


def _rank_main(rank: int, n: int) -> None:
    from ..models import siglip
    from .mesh import make_mesh
    from .sharded import ShardedFlatIndex
    from .train import make_train_state, make_train_step

    model_parallel = 2 if n % 2 == 0 else 1
    mesh = make_mesh(n // model_parallel, model_parallel, device="cpu")
    cfg = siglip.tiny_test_config()
    params, optimizer, opt_state = make_train_state(0, cfg, mesh)
    step = make_train_step(cfg, mesh, optimizer)

    batch = mesh.data * 2
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (batch, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (batch, cfg.text_len)).astype(np.int32)
    mine = slice(mesh.data_rank * 2, mesh.data_rank * 2 + 2)
    _, _, loss = step(params, opt_state, torch.from_numpy(images[mine]),
                      torch.from_numpy(tokens[mine]))
    loss_val = float(loss)
    if not np.isfinite(loss_val):
        raise RuntimeError(f"dryrun_multichip: loss {loss_val}")

    n_rows, d, k, nq = 4096 + 7, 128, 16, 8  # +7: the pad sentinels
    corpus = rng.standard_normal((n_rows, d)).astype(np.float16)
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    s, i = ShardedFlatIndex(corpus, mesh).search(queries, k)
    oracle = queries @ corpus.astype(np.float32).T
    oracle_i = np.argsort(-oracle, axis=1)[:, :k]
    oracle_s = np.take_along_axis(oracle, oracle_i, axis=1)
    if not np.allclose(s, oracle_s, atol=2e-2):
        raise RuntimeError(f"sharded scores off by {np.abs(s - oracle_s).max()}")
    recall = np.mean([len(set(i[b]) & set(oracle_i[b])) / k for b in range(nq)])
    if recall != 1.0:
        raise RuntimeError(f"sharded search recall {recall} != 1.0")
    if rank == 0:
        print(f"dryrun_multichip ok: mesh={mesh.shape} loss={loss_val:.4f}", flush=True)
        print(f"dryrun_multichip search ok: corpus ({n_rows},{d}) sharded over "
              f"{mesh.data} ranks, k={k} merged top-k equals the exact oracle", flush=True)


def dryrun_multichip(n_processes: int) -> None:
    """Spawn ``n_processes`` gloo ranks on the CPU and run the dry run;
    raises if any rank fails."""
    spawn_gloo(_rank_main, n_processes, n_processes)
