"""Port parity for the parallel layer, as tests/test_parallel.py runs the
JAX one on its 8-device virtual CPU mesh: here four gloo processes on
the CPU, spawned once for the file (``_four_ranks``), against the JAX
package in this process.

- ``shard_params``: each rank's slices equal the JAX ``NamedSharding``'s
  on a 4 x 2 mesh (every device's shard, bit for bit).
- A 2 x 2 dp x tp train step on a batch of 8 equals the single-process
  JAX step on the global batch: the loss rtol 1e-5, every gradient atol
  1e-5 (fp32), ``fc1.w`` held split over ``model``.
- ``sharded_mips_topk`` on a data-4 mesh against JAX's: ids as sets a
  query, scores rtol 1e-4; the wrapper drops its pad sentinels.
- A checkpoint round trip on 2 x 2 keeps each rank's slices; restored
  onto 4 x 1 and 1 x 4 it is bit-equal to the global tree (params and
  AdamW's moments); another logical shape or dtype is refused.
- ``dryrun_multichip(4)``, and the engine's device list equal to one
  device on every route of both towers (tests/test_parallel.py's rtol
  2e-2, atol 2e-3); rows of devices are refused.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meme_search_engine_tpu.models import siglip as js
from meme_search_engine_tpu.ops.mips import mips_topk as jax_mips_topk
from meme_search_engine_tpu.parallel import mesh as jmesh
from meme_search_engine_tpu.parallel.sharded import ShardedFlatIndex as JaxShardedFlatIndex
from meme_search_engine_tpu.parallel.sharded import sharded_mips_topk as jax_sharded_mips_topk
from meme_search_engine_tpu_torch.models import convert
from meme_search_engine_tpu_torch.models import siglip as ts
from meme_search_engine_tpu_torch.parallel import mesh as tmesh
from meme_search_engine_tpu_torch.parallel.dryrun import dryrun_multichip, spawn_gloo
from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine

LR = 1e-4


def _configs():
    jcfg = dataclasses.replace(js.tiny_test_config(), param_dtype=jnp.float32)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["param_dtype"] = torch.float32
    return jcfg, ts.SigLIPConfig(**fields)


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        *head, last = key.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _ranks4(rank, out_dir):
    """The four ranks' program: a 2 x 2 train step and checkpoint, then a
    4 x 1 sharded search; each rank writes its results to ``out_dir``."""
    from meme_search_engine_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
    from meme_search_engine_tpu_torch.parallel.sharded import ShardedFlatIndex, sharded_mips_topk
    from meme_search_engine_tpu_torch.parallel.train import make_train_state, make_train_step

    inputs = np.load(os.path.join(out_dir, "inputs.npz"))
    _, tcfg = _configs()
    whole = _unflat({k[2:]: torch.from_numpy(inputs[k]) for k in inputs.files if k.startswith("p:")})
    out = {}

    mesh = tmesh.make_mesh(2, 2, device="cpu")
    params, optimizer, opt_state = make_train_state(0, tcfg, mesh, LR, params=whole)
    step = make_train_step(tcfg, mesh, optimizer)
    mine = slice(4 * mesh.data_rank, 4 * mesh.data_rank + 4)
    images, tokens = torch.from_numpy(inputs["images"]), torch.from_numpy(inputs["tokens"])
    params, opt_state, loss = step(params, opt_state, images[mine], tokens[mine])
    out["loss"] = loss.numpy()
    for k, t in tmesh.tree_flat(params).items():
        out[f"grad:{k}"] = t.grad.numpy()
        out[f"param:{k}"] = t.detach().numpy()
    for k, t in tmesh.tree_flat(opt_state.mu).items():
        out[f"mu:{k}"] = t.numpy()

    ckpt = os.path.join(out_dir, "ckpt")
    save_train_state(ckpt, params, opt_state, step=50)
    fresh, _, fresh_state = make_train_state(0, tcfg, mesh, LR, params=whole)
    fresh, fresh_state, restored_step = restore_train_state(ckpt, fresh, fresh_state)
    out["restored_step"] = np.asarray(restored_step)
    out["restored_equal"] = np.asarray(all(
        torch.equal(a, b) for a, b in zip(tmesh.tree_leaves(fresh), tmesh.tree_leaves(params))
    ) and all(
        torch.equal(a, b) for a, b in zip(tmesh.tree_leaves(fresh_state.nu), tmesh.tree_leaves(opt_state.nu))
    ))

    # onto meshes of other shapes: 4 x 1 (each rank whole) and 1 x 4
    mesh4 = tmesh.make_mesh(4, 1, device="cpu")
    mesh14 = tmesh.make_mesh(1, 4, device="cpu")
    for name, m in (("4x1", mesh4), ("1x4", mesh14)):
        other, _, other_state = make_train_state(0, tcfg, m, LR, params=whole)
        other, other_state, _ = restore_train_state(ckpt, other, other_state)
        for k, t in tmesh.tree_flat(other).items():
            out[f"{name}:param:{k}"] = t.detach().numpy()
        for k, t in tmesh.tree_flat(other_state.mu).items():
            out[f"{name}:mu:{k}"] = t.numpy()
        out[f"{name}:count"] = np.asarray([float(t) for t in tmesh.tree_leaves(other_state.count)])

    corpus = inputs["corpus"]
    rows = corpus.shape[0] // 4
    shard = torch.from_numpy(corpus[rows * mesh4.data_rank : rows * (mesh4.data_rank + 1)])
    s, i = sharded_mips_topk(shard, torch.from_numpy(inputs["queries"]), 20, mesh4, tile=128)
    out["mips_s"], out["mips_i"] = s.numpy(), i.numpy()
    s, i = ShardedFlatIndex(inputs["corpus_1k"], mesh4, tile=128).search(inputs["corpus_1k"][42:43], 5)
    out["index_s"], out["index_i"] = s, i
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, corpus_1k):
    out_dir = str(tmp_path_factory.mktemp("four_ranks"))
    jcfg, _ = _configs()
    params = jax.tree.map(np.asarray, js.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (8, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab_size, (8, jcfg.text_len)).astype(np.int32)
    corpus = np.concatenate([corpus_1k, np.zeros((24, 128), np.float16)])
    queries = np.random.default_rng(5).standard_normal((3, 128)).astype(np.float32)
    np.savez(os.path.join(out_dir, "inputs.npz"), images=images, tokens=tokens, corpus=corpus,
             queries=queries, corpus_1k=corpus_1k, **{f"p:{k}": v for k, v in tmesh.tree_flat(params).items()})
    spawn_gloo(_ranks4, 4, out_dir)
    results = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(4)]
    return {"params": params, "images": images, "tokens": tokens, "corpus": corpus,
            "queries": queries, "ranks": results}


def _spec_slice(x, spec, model_rank, model):
    dim = tmesh.split_dim(spec)
    if dim is None:
        return x
    part = x.shape[dim] // model
    return np.take(x, np.arange(model_rank * part, (model_rank + 1) * part), axis=dim)


def test_shard_params_match_jax_named_sharding():
    """Every leaf on every device of a 4 x 2 mesh: the JAX shard equals the
    port's slice for the rank at that mesh position."""
    jcfg, _ = _configs()
    params = js.init_params(jax.random.PRNGKey(1), jcfg)
    mesh42 = jmesh.make_mesh(8, model_parallel=2)
    sharded = tmesh.tree_flat(jmesh.shard_params(params, mesh42))
    whole = convert.tree_from_numpy(jax.tree.map(np.asarray, params))
    assert set(tmesh.tree_flat(tmesh.siglip_param_specs())) == set(sharded)
    for rank in range(8):
        mesh = tmesh.Mesh(4, 2, rank, torch.device("cpu"), None, None)
        local = tmesh.tree_flat(tmesh.shard_params(whole, mesh))
        for key, arr in sharded.items():
            shard = next(s for s in arr.addressable_shards if s.device.id == rank)
            assert tuple(local[key].shape) == shard.data.shape, key
            np.testing.assert_array_equal(local[key].numpy(), np.asarray(shard.data), err_msg=key)


def test_dp_tp_step_equals_single_process_jax_on_global_batch(four_ranks):
    jcfg, _ = _configs()
    params = jax.tree.map(jnp.asarray, four_ranks["params"])
    loss, grads = jax.value_and_grad(js.siglip_loss)(
        params, jnp.asarray(four_ranks["images"]), jnp.asarray(four_ranks["tokens"]), jcfg)
    grads = {k: np.asarray(v) for k, v in tmesh.tree_flat(grads).items()}
    specs = tmesh.tree_flat(tmesh.siglip_param_specs())
    for rank, res in enumerate(four_ranks["ranks"]):
        np.testing.assert_allclose(res["loss"], float(loss), rtol=1e-5)
        for key, want in grads.items():
            got = res[f"grad:{key}"]
            np.testing.assert_allclose(got, _spec_slice(want, specs[key], rank % 2, 2), atol=1e-5,
                                       rtol=0, err_msg=f"rank {rank} {key}")
        fc1 = res["param:img/blocks/mlp/fc1/w"]
        assert fc1.shape == (jcfg.depth, jcfg.width, jcfg.mlp_dim // 2)
        assert not np.array_equal(fc1, _spec_slice(
            four_ranks["params"]["img"]["blocks"]["mlp"]["fc1"]["w"], (None, None, "model"), rank % 2, 2))


def test_sharded_search_matches_jax_data4(four_ranks):
    mesh4 = jmesh.make_mesh(4, model_parallel=1)
    sharding = jax.sharding.NamedSharding(mesh4, jax.sharding.PartitionSpec(jmesh.DATA, None))
    corpus, q = four_ranks["corpus"], four_ranks["queries"]
    s_j, i_j = jax_sharded_mips_topk(jax.device_put(jnp.asarray(corpus), sharding), jnp.asarray(q), 20,
                                     mesh4, tile=128)
    s_ref, i_ref = jax_mips_topk(jnp.asarray(corpus), jnp.asarray(q), 20, tile=256)
    for res in four_ranks["ranks"]:
        for b in range(3):
            assert set(res["mips_i"][b].tolist()) == set(np.asarray(i_j)[b].tolist())
            assert set(res["mips_i"][b].tolist()) == set(np.asarray(i_ref)[b].tolist())
        np.testing.assert_allclose(res["mips_s"], np.asarray(s_j), rtol=1e-4)


def test_sharded_index_wrapper_drops_pad_sentinels(four_ranks, corpus_1k):
    mesh4 = jmesh.make_mesh(4, model_parallel=1)
    s_j, i_j = JaxShardedFlatIndex(corpus_1k, mesh4, tile=128).search(corpus_1k[42:43].astype(np.float32), 5)
    for res in four_ranks["ranks"]:
        assert res["index_i"][0, 0] == 42
        assert res["index_i"].max() < 1000  # pad sentinels excluded
        np.testing.assert_array_equal(res["index_i"], i_j)
        np.testing.assert_allclose(res["index_s"], s_j, rtol=1e-4)


def test_checkpoint_round_trip_keeps_each_rank_slice(four_ranks):
    """On 2 x 2 each rank gets its slices back; restored onto 4 x 1 and
    1 x 4 every rank holds its part of the global tree (the 2 x 2 ranks'
    slices joined), bit for bit, params and moments alike."""
    for res in four_ranks["ranks"]:
        assert int(res["restored_step"]) == 50
        assert bool(res["restored_equal"])
    specs = tmesh.tree_flat(tmesh.siglip_param_specs())
    ranks = four_ranks["ranks"]

    def whole(kind, key):  # ranks 0 and 1 are data row 0's two model columns
        dim = tmesh.split_dim(specs[key])
        parts = [ranks[m][f"{kind}:{key}"] for m in (0, 1)]
        return parts[0] if dim is None else np.concatenate(parts, axis=dim)

    for key in specs:
        for kind in ("param", "mu"):
            want = whole(kind, key)
            for r, res in enumerate(ranks):
                np.testing.assert_array_equal(res[f"4x1:{kind}:{key}"], want, err_msg=key)
                np.testing.assert_array_equal(res[f"1x4:{kind}:{key}"],
                                              _spec_slice(want, specs[key], r, 4), err_msg=key)
    for r, res in enumerate(ranks):
        assert (res["4x1:count"] == 1).all() and (res["1x4:count"] == 1).all()


def test_dryrun_multichip_four_processes(capfd):
    dryrun_multichip(4)
    out = capfd.readouterr().out
    assert "dryrun_multichip ok: mesh={'data': 2, 'model': 2}" in out
    assert "equals the exact oracle" in out


def _fat_text_cfg(attn_impl):
    """tiny_fat_test_config with a fat-capable text tower (16 heads of 7,
    tests/test_siglip.py:116-119), both towers 112 wide into d_emb."""
    return dataclasses.replace(ts.tiny_fat_test_config(attn_impl), text_width=112,
                               text_num_heads=16, text_len=16, d_emb=112)


@pytest.mark.parametrize("attn_impl", ["auto", "xla", "fat_interpret"])
def test_engine_device_list_equals_one_device(attn_impl, monkeypatch):
    """Buckets split over ["cpu", "cpu"] (each bucket that divides by 2)
    give the single device's embeddings on every route of both towers;
    the text tower's fat layout is built once a replica tree."""
    cfg = _fat_text_cfg(attn_impl)
    params = ts.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    single = EmbeddingEngine(params, cfg, max_batch=16, device="cpu")
    multi = EmbeddingEngine(params, cfg, max_batch=16, mesh=["cpu", "cpu"])
    imgs = np.random.default_rng(0).integers(0, 256, (17, cfg.image_size, cfg.image_size, 3),
                                             dtype=np.uint8)
    used = []
    run = multi._run
    multi._run = lambda fn, replica, chunk, *part: (used.append((replica, len(chunk)))
                                                    or run(fn, replica, chunk, *part))
    # tests/test_parallel.py's tolerances: a bucket split in two may round
    # its bf16 products in another order
    np.testing.assert_allclose(multi.embed_image_arrays(imgs), single.embed_image_arrays(imgs),
                               rtol=2e-2, atol=2e-3)
    assert used == [(0, 8), (1, 8), (0, 1)]  # the bucket of 16 split, the bucket of 1 not
    texts = ["a", "b c", "d e f"]  # buckets of 2 (split) and 1
    want = single.embed_texts(texts)
    built = []
    fat_blocks = ts._fat_text_blocks
    monkeypatch.setattr(ts, "_fat_text_blocks", lambda *a: built.append(a) or fat_blocks(*a))
    np.testing.assert_allclose(multi.embed_texts(texts), want, rtol=2e-2, atol=2e-3)
    multi.embed_texts(texts)
    trees = {id(r): r for r in multi._replicas}.values()  # one tree a distinct device
    if attn_impl == "fat_interpret":
        assert all(isinstance(r["txt"]["layouts"]["fat"], dict) for r in trees)
        assert len(built) == len(trees)  # on a tree's first call, then kept
    else:
        assert not built and all(r["txt"]["layouts"] == {} for r in trees)


def test_engine_device_list_packs_each_replica_apart():
    """Over ["cpu", "cpu"] each replica's share of a bucket of square
    pictures is packed apart, into a staging slot of its own on a card,
    (replica, first row), and the embeddings are one device's."""
    cfg = ts.tiny_test_config()
    params = ts.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    single = EmbeddingEngine(params, cfg, max_batch=8, device="cpu")
    multi = EmbeddingEngine(params, cfg, max_batch=8, mesh=["cpu", "cpu"])
    imgs = np.random.default_rng(1).integers(0, 256, (9, cfg.image_size, cfg.image_size, 3),
                                             dtype=np.uint8)  # buckets of 8 and 1
    packed = []
    pack = multi._pack_images
    multi._pack_images = lambda chunk, replica, slot: (packed.append((len(chunk), replica, slot))
                                                       or pack(chunk, replica, slot))
    np.testing.assert_allclose(multi.embed_image_arrays(imgs), single.embed_image_arrays(imgs),
                               rtol=2e-2, atol=2e-3)
    # the bucket of 8 as 4 on each replica, the bucket of 1 on the first
    assert packed == [(4, 0, (0, 0)), (4, 1, (1, 0)), (1, 0, (0, 0))]
    assert multi._staging == single._staging == {}  # a CPU engine stages nothing


def test_engine_refuses_rows_of_devices():
    """The engine's mesh is a list of devices, one data replica each; a
    row of devices (a list inside the list) is refused by name."""
    cfg = ts.tiny_test_config()
    params = ts.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for mesh in ([["cpu", "cpu"]], ["cpu", ("cpu",)]):
        with pytest.raises(ValueError, match="list of devices"):
            EmbeddingEngine(params, cfg, max_batch=4, mesh=mesh)


def test_restore_refuses_another_logical_shape_or_dtype(tmp_path):
    """What orbax refuses, and only that: a leaf of another whole shape or
    dtype; the same tree restores bit for bit (one process, no mesh)."""
    from meme_search_engine_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
    from meme_search_engine_tpu_torch.parallel.train import adamw

    cfg = ts.tiny_test_config()
    params = ts.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, state = adamw(params)
    save_train_state(str(tmp_path), params, state, step=3)
    same = ts.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    same, _, step = restore_train_state(str(tmp_path), same, adamw(same)[1])
    assert step == 3 and all(torch.equal(a, b) for a, b in zip(tmesh.tree_leaves(same), tmesh.tree_leaves(params)))
    for other in (ts.init_params(dataclasses.replace(cfg, mlp_dim=96), torch.Generator().manual_seed(0), "cpu"),
                  ts.init_params(dataclasses.replace(cfg, param_dtype=torch.float32),
                                 torch.Generator().manual_seed(0), "cpu")):
        with pytest.raises(ValueError, match="saved"):
            restore_train_state(str(tmp_path), other, adamw(other)[1])
