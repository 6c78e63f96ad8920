"""Port parity for the training layer: ``siglip_loss`` and its gradients,
the AdamW step and the train step on a 1 x 1 mesh, against the JAX
package on the same numpy params and batch; and the kernel wrappers'
refusal of inputs that require grad.

Both packages start from the JAX ``init_params`` tree, carried across
through numpy by ``models/convert.py``. The JAX loss runs as its train
step runs off a TPU (``_encoder`` and ``mha_xla``; no Pallas kernel has a
backward). Tolerances: fp32, the loss rtol 1e-5 and every gradient atol
1e-5 + rtol 1e-4; bf16, the loss rtol 2e-2 and each gradient's cosine >=
0.99; AdamW against ``optax.adamw(1e-4)`` over three steps in fp32, atol
1e-7 plus one fp32 ulp of the value a step (rtol 3 x 2^-23: torch decays
the param before the Adam update, optax adds the decay to the update, so
the two round in another order; the LN gains sit at 1.0, where an ulp is
1.19e-7); the 1 x 1 step's loss rtol 1e-5 and its params within 2 lr.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from meme_search_engine_tpu.models import siglip as js
from meme_search_engine_tpu.parallel import mesh as jmesh
from meme_search_engine_tpu.parallel import train as jtrain
from meme_search_engine_tpu_torch.models import convert
from meme_search_engine_tpu_torch.models import siglip as ts
from meme_search_engine_tpu_torch.ops import attention, fused
from meme_search_engine_tpu_torch.parallel import mesh as tmesh
from meme_search_engine_tpu_torch.parallel import train as ttrain

LR = 1e-4


def _configs(dtype):
    jcfg = dataclasses.replace(js.tiny_test_config(), param_dtype=dtype)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["param_dtype"] = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    return jcfg, ts.SigLIPConfig(**fields)


def _batch(cfg, n=8, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (n, cfg.text_len)).astype(np.int32)
    return images, tokens


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaf_grads(tree):
    """Every leaf of a port tree requiring grad; returns the leaves."""
    leaves = tmesh.tree_leaves(tree)
    for t in leaves:
        t.requires_grad_(True)
    return leaves


# Both packages return rounding noise for the gradients that are zero in
# exact arithmetic, so those leaves are held at an absolute bound instead
# of a cosine.
ZERO_GRAD = {tuple(k.split("/")) for k in ts.ZERO_GRAD_LEAVES}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_siglip_loss_and_grads_match_jax(dtype):
    jcfg, tcfg = _configs(dtype)
    params = js.init_params(jax.random.PRNGKey(0), jcfg)
    images, tokens = _batch(jcfg)
    jl, jg = jax.value_and_grad(js.siglip_loss)(params, jnp.asarray(images), jnp.asarray(tokens), jcfg)
    tp = convert.tree_from_numpy(jax.tree.map(np.asarray, params))
    _leaf_grads(tp)
    loss = ts.siglip_loss(tp, torch.from_numpy(images), torch.from_numpy(tokens), tcfg)
    loss.backward()
    jgn = jax.tree.map(lambda g: np.asarray(g, np.float32), jg)
    if dtype == jnp.float32:
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
        for path, want in _paths(jgn):
            got = _get(tp, path).grad.float().numpy()
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4, err_msg=str(path))
        return
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-2)
    scale = max(float(np.abs(g).max()) for _, g in _paths(jgn))
    for path, want in _paths(jgn):
        got = _get(tp, path).grad.float().numpy()
        assert np.isfinite(got).all(), path
        if path in ZERO_GRAD:
            assert np.abs(got).max() <= 1e-3 * scale and np.abs(want).max() <= 1e-3 * scale, path
            continue
        cos = float((got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want)))
        assert cos >= 0.99, (path, cos)


def test_loss_takes_the_plain_route_whatever_attn_impl():
    """The loss reads the source tree with mha_xla for every attention;
    a tree prepared for the fat-layout kernels is refused."""
    jcfg, tcfg = _configs(jnp.float32)
    tree = convert.tree_from_numpy(jax.tree.map(np.asarray, js.init_params(jax.random.PRNGKey(1), jcfg)))
    images, tokens = _batch(tcfg, n=2)
    args = (torch.from_numpy(images), torch.from_numpy(tokens))
    auto = ts.siglip_loss(tree, *args, tcfg)
    xla = ts.siglip_loss(tree, *args, dataclasses.replace(tcfg, attn_impl="xla"))
    assert float(auto) == float(xla)
    with pytest.raises(ValueError, match="fat-layout"):
        ts.siglip_loss(ts.prepare_params(tree, tcfg), *args, tcfg)


def test_adamw_matches_optax():
    jcfg, _ = _configs(jnp.float32)
    params = jax.tree.map(np.asarray, js.init_params(jax.random.PRNGKey(2), jcfg))
    tp = convert.tree_from_numpy(params)
    optimizer, state = ttrain.adamw(tp, LR)
    opt = optax.adamw(LR)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = opt.init(jp)
    rng = np.random.default_rng(3)
    for _ in range(3):
        grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
        for path, g in _paths(grads):
            _get(tp, path).grad = torch.from_numpy(g)
        optimizer.step()
        updates, jstate = opt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, updates)
    for path, want in _paths(jax.tree.map(np.asarray, jp)):
        np.testing.assert_allclose(_get(tp, path).numpy(), want, atol=1e-7, rtol=3 * 2**-23,
                                   err_msg=str(path))
    assert float(_get(state.count, ("t",))) == 3.0
    np.testing.assert_allclose(_get(state.mu, ("t",)).numpy(), np.asarray(jstate[0].mu["t"]), atol=1e-7)


@pytest.fixture
def world1(tmp_path):
    """A gloo process group of one rank in this process."""
    store = dist.FileStore(os.path.join(tmp_path, "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_train_step_1x1_matches_jax(world1):
    jcfg, tcfg = _configs(jnp.float32)
    key = jax.random.PRNGKey(4)
    images, tokens = _batch(jcfg)
    jm = jmesh.make_mesh(1)
    jparams, jopt, jstate = jtrain.make_train_state(key, jcfg, jm, learning_rate=LR)
    jstep = jtrain.make_train_step(jcfg, jm, jopt)
    whole = jax.tree.map(np.asarray, js.init_params(key, jcfg))
    jparams2, _, jl = jstep(jparams, jstate, jnp.asarray(images), jnp.asarray(tokens))

    mesh = tmesh.make_mesh(1, 1, device="cpu")
    params, optimizer, opt_state = ttrain.make_train_state(
        0, tcfg, mesh, learning_rate=LR, params=convert.tree_from_numpy(whole))
    step = ttrain.make_train_step(tcfg, mesh, optimizer)
    params, opt_state, loss = step(params, opt_state, torch.from_numpy(images), torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    # AdamW's first update is about +-lr an entry whatever the gradient, so
    # the 2 lr bound alone cannot tell a wrong gradient: the step's own
    # gradients and its update are held against JAX's too.
    jg = jax.tree.map(np.asarray, jax.grad(js.siglip_loss)(
        jax.tree.map(jnp.asarray, whole), jnp.asarray(images), jnp.asarray(tokens), jcfg))
    moved = 0.0
    for path, want in _paths(jax.tree.map(np.asarray, jparams2)):
        leaf, before = _get(params, path), _get(whole, path)
        got = leaf.detach().numpy()
        np.testing.assert_allclose(got, want, atol=2 * LR, rtol=0, err_msg=str(path))
        g = _get(jg, path)
        np.testing.assert_allclose(leaf.grad.numpy(), g, atol=1e-5, rtol=1e-4, err_msg=str(path))
        # the update where the gradient's sign is clear, to rtol 1e-3 plus
        # the one fp32 ulp of the param that each package rounds its new
        # value to (t ~ 2.3 has ulps of 2.4e-7 against updates of 1e-4)
        big = np.abs(g) > 1e-4
        diff = np.abs((got - before) - (want - before))[big]
        bound = 1e-3 * np.abs(want - before)[big] + np.spacing(np.abs(before))[big]
        assert (diff <= bound).all(), (path, float((diff - bound).max()))
        moved += float(np.abs(got - before).sum())
    assert moved > 0
    assert float(_get(opt_state.count, ("img", "patch_embed", "w"))) == 1.0


def _wrappers():
    """Each kernel wrapper of kernels 1-8 with CPU inputs at the tiny
    widths, as (name, call(requires_grad))."""
    def t(*shape, grad=False):
        return torch.randn(*shape, dtype=torch.bfloat16).requires_grad_(grad)

    h, dh = 2, 16
    c = attention.fat_width(dh)
    return {
        "ln_matmul": lambda g: fused.ln_matmul(t(1, 8, 32, grad=g), t(32), t(32), t(32, 16), t(16)),
        "matmul_residual": lambda g: fused.matmul_residual(t(1, 8, 32), t(32, 16, grad=g), t(16), t(1, 8, 16)),
        "ln_mlp_residual": lambda g: fused.ln_mlp_residual(
            t(1, 8, 32), t(32), t(32), t(32, 128), t(128, grad=g), t(128, 32), t(32)),
        "fused_mha": lambda g: attention.fused_mha(t(1, 8, h, dh, grad=g), t(1, 8, h, dh), t(1, 8, h, dh)),
        "fat_vit_mha": lambda g: attention.fat_vit_mha(
            t(1, 16, h * c), t(1, 16, h * c, grad=g), t(1, 16, h * c), h, dh),
        "fat_vit_mha_packed": lambda g: attention.fat_vit_mha_packed(t(1, 16, 3 * h * c, grad=g), h, dh),
        "fat_vit_mha_packed_proj": lambda g: attention.fat_vit_mha_packed_proj(
            t(1, 16, 3 * h * c), t(h * dh, 32), t(32), t(1, 16, 32, grad=g), h, dh),
    }


@pytest.mark.parametrize("name", sorted(_wrappers()))
def test_kernel_wrappers_refuse_inputs_that_require_grad(name):
    """A kernel has no backward: an input that requires grad raises, on the
    CPU too (the check comes before the device dispatch); without grad,
    or under no_grad, the plain version runs."""
    call = _wrappers()[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call(True)
    assert call(False).grad_fn is None
    with torch.no_grad():
        call(True)


def test_mesh_refuses_cuda_without_a_card(world1):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the mesh would live there")
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.make_mesh(1, 1, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.make_mesh(1, 1)  # the default is the card, whatever the backend
    assert tmesh.make_mesh(1, 1, device="cpu").device.type == "cpu"
