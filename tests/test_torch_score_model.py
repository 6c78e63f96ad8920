"""Port parity for the quality model (``models/score_model.py``) and the
profiling helpers (``utils/profiling.py``), against the JAX package's.

The same numpy inputs and the same parameters (the JAX ``init_ensemble``
at seed 0, carried across by ``params_from_jax``) go through both. On the
CPU the JAX package computes in fp32 through XLA and the port in fp32
through torch, so the sums differ in order only: forward, pair
probabilities and wide scores are held at 1e-5; the wide export is index
arithmetic and must be equal. Safetensors files are read across both
packages (the port writes them with numpy alone).
"""

import glob
import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from meme_search_engine_tpu.models import score_model as jsm
from meme_search_engine_tpu_torch.models import score_model as tsm
from meme_search_engine_tpu_torch.utils import profiling

CFG = dict(d_emb=32, n_hidden=1, n_ensemble=4, output_channels=3)
TOL = 1e-5


@pytest.fixture(scope="module")
def both():
    params = jsm.init_ensemble(jax.random.PRNGKey(0), jsm.ScoreModelConfig(**CFG))
    return params, tsm.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("per_member", [False, True], ids=["broadcast", "per_member"])
def test_ensemble_forward_matches_jax(both, per_member):
    jp, tp = both
    shape = (4, 8, 32) if per_member else (8, 32)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jsm.ensemble_forward(jp, x))
    got = _np(tsm.ensemble_forward(tp, x))
    assert got.shape == (4, 8, 3)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # members disagree (independent init)
    assert float(np.var(got, axis=0).mean()) > 0


def test_bradley_terry_prob_matches_jax(both):
    jp, tp = both
    pairs = np.random.default_rng(1).standard_normal((4, 8, 2, 32)).astype(np.float32)
    want = np.asarray(jsm.bradley_terry_prob(jp, pairs))
    got = _np(tsm.bradley_terry_prob(tp, pairs))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.all(got > 0) and np.all(got < 1)
    # antisymmetry: swapping the pair flips the probability
    swapped = _np(tsm.bradley_terry_prob(tp, np.ascontiguousarray(pairs[:, :, ::-1])))
    np.testing.assert_allclose(got + swapped, 1.0, atol=1e-5)


def test_dropout_draws_from_the_generator(both):
    """Dropout masks come from the explicit generator: one seed gives one
    output, another seed another; rate 0 is the plain forward."""
    _, tp = both
    pairs = np.random.default_rng(2).standard_normal((4, 64, 2, 32)).astype(np.float32)

    def run(seed, rate):
        g = torch.Generator().manual_seed(seed)
        return _np(tsm.bradley_terry_prob(tp, pairs, generator=g, dropout_rate=rate))

    plain = _np(tsm.bradley_terry_prob(tp, pairs))
    np.testing.assert_array_equal(run(0, 0.0), plain)
    np.testing.assert_array_equal(run(0, 0.5), run(0, 0.5))
    assert not np.array_equal(run(0, 0.5), run(1, 0.5))
    assert not np.allclose(run(0, 0.5), plain)


def test_export_wide_equals_jax(both):
    jp, tp = both
    cfg = tsm.ScoreModelConfig(**CFG)
    want = jsm.export_wide(jp, jsm.ScoreModelConfig(**CFG))
    got = tsm.export_wide(tp, cfg)  # raises on its self-check
    for name in ("up_proj", "bias", "down_proj"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.up_proj.shape == (4 * 32, 32) and got.down_proj.shape == (3, 4 * 32)
    assert abs(got.scale - 1 / 4) < 1e-9 and got.d_emb == 32


def test_score_batch_matches_jax_in_any_chunking(both, monkeypatch):
    jp, tp = both
    wide = tsm.export_wide(tp, tsm.ScoreModelConfig(**CFG))
    jwide = jsm.WideScoreModel(wide.up_proj, wide.bias, wide.down_proj)
    x = np.random.default_rng(3).standard_normal((37, 32)).astype(np.float32)
    whole = wide.score_batch(x, device="cpu")
    np.testing.assert_allclose(whole, jwide.score_batch(x), rtol=TOL, atol=TOL)
    # a tensor in is the same rows
    np.testing.assert_array_equal(wide.score_batch(torch.from_numpy(x), device="cpu"), whole)
    for chunk in (1, 5, 36):
        monkeypatch.setattr(tsm, "SCORE_CHUNK", chunk)
        np.testing.assert_allclose(wide.score_batch(x, device="cpu"), whole, rtol=1e-6, atol=1e-6)
    # the ensemble mean with output biases zeroed, in float64 numpy
    w = tp.hidden[0].w.detach().double().numpy()
    b = tp.hidden[0].b.detach().double().numpy()
    h = x.astype(np.float64)[None] @ w + b[:, None]
    h = h / (1 + np.exp(-h))
    ref = (h @ tp.output.w.detach().double().numpy()).mean(0)
    np.testing.assert_allclose(whole, ref, atol=1e-5)


def test_wide_safetensors_read_across_packages(both, tmp_path):
    _, tp = both
    wide = tsm.export_wide(tp, tsm.ScoreModelConfig(**CFG))
    x = np.random.default_rng(4).standard_normal((4, 32)).astype(np.float32)
    ours, theirs = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
    wide.save_safetensors(ours)
    jsm.WideScoreModel(wide.up_proj, wide.bias, wide.down_proj).save_safetensors(theirs)
    for path in (ours, theirs):
        for loaded in (jsm.WideScoreModel.load_safetensors(path), tsm.WideScoreModel.load_safetensors(path)):
            for name in ("up_proj", "bias", "down_proj"):
                np.testing.assert_array_equal(getattr(loaded, name), getattr(wide, name))
    np.testing.assert_allclose(tsm.WideScoreModel.load_safetensors(ours).score_batch(x, device="cpu"),
                               wide.score_batch(x, device="cpu"), rtol=1e-6)


def test_wide_model_torch_oracle():
    """tests/test_score_model_sae.py's oracle on the port: the reference
    architecture built in torch per meme-rater/model.py, exported with the
    reference's own formulas (ensemble_to_wide_model.py:44-74), run
    through the port's WideScoreModel."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(0)
    e, d, ch = 16, 64, 3
    hidden_w = [torch.randn(d, d, generator=g) / d**0.5 for _ in range(e)]
    hidden_b = [torch.randn(d, generator=g) * 0.1 for _ in range(e)]
    out_w = [torch.randn(ch, d, generator=g) / d**0.5 for _ in range(e)]
    big_layer = torch.cat(hidden_w)
    big_bias = torch.cat(hidden_b)
    down = torch.cat(out_w, dim=1)
    x = torch.randn(5, d, generator=g)
    truth = torch.stack([F.linear(F.silu(F.linear(x, hidden_w[i], hidden_b[i])), out_w[i])
                         for i in range(e)]).mean(dim=0)
    wide = tsm.WideScoreModel(big_layer.numpy(), big_bias.numpy(), down.numpy())
    assert abs(wide.scale - 1 / e) < 1e-9
    np.testing.assert_allclose(wide.score_batch(x.numpy(), device="cpu"), truth.numpy(), atol=1e-4)


def test_entry_points_refuse_cuda_without_a_card(both, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    _, tp = both
    cfg = tsm.ScoreModelConfig(**CFG)
    with pytest.raises(RuntimeError, match="cuda"):
        tsm.init_ensemble(cfg, torch.Generator(), "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tsm.export_wide(tp, cfg).score_batch(np.zeros((1, 32), np.float32))


def test_profiling_trace_holds_the_annotation(tmp_path):
    """``trace`` writes a Chrome trace on exit that holds an ``annotate``
    span and the ops under it; ``PhaseTimers`` counts its phases."""
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("sae_step"):
            torch.randn(16, 16) @ torch.randn(16, 16)
    assert prof is not None
    (path,) = glob.glob(str(tmp_path / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "sae_step" in names and "aten::mm" in names
    timers = profiling.PhaseTimers()
    for _ in range(2):
        with timers.phase("a"):
            pass
    assert "a: " in timers.report() and "(2 calls)" in timers.report()
    assert set(timers.totals()) == {"a"} and isinstance(profiling.GLOBAL_TIMERS, profiling.PhaseTimers)


def test_aux_modules_import_neither_jax_nor_the_jax_package():
    """In a fresh process where jax, the JAX package and aiohttp cannot be
    imported, every module of this slice imports."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'optax', 'meme_search_engine_tpu', 'aiohttp'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import meme_search_engine_tpu_torch.models.score_model\n"
        "import meme_search_engine_tpu_torch.models.sae\n"
        "import meme_search_engine_tpu_torch.models.sae_tools\n"
        "import meme_search_engine_tpu_torch.models.safetensors_io\n"
        "import meme_search_engine_tpu_torch.rater\n"
        "import meme_search_engine_tpu_torch.rater.data\n"
        "import meme_search_engine_tpu_torch.rater.evaluate\n"
        "import meme_search_engine_tpu_torch.rater.crawler\n"
        "import meme_search_engine_tpu_torch.rater.server\n"
        "import meme_search_engine_tpu_torch.rater.train\n"
        "import meme_search_engine_tpu_torch.rater.active_learning\n"
        "import meme_search_engine_tpu_torch.rater.meme_pipeline\n"
        "import meme_search_engine_tpu_torch.utils.profiling\n"
        "import meme_search_engine_tpu_torch.tools.dump_tool\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'aiohttp')\n"
        "       or m == 'meme_search_engine_tpu' or m.startswith('meme_search_engine_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    root = __file__.rsplit("/tests/", 1)[0]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")
