"""The NaFlex cell's own pieces on the CPU: the term's grids, the
operation count against a hand count, and planted faults in the program
that the comparison with the reference fails (a picture's grid
transposed, each picture given its neighbour's key mask)."""

import json

import numpy as np
import pytest

from port_bench import data, flops, flops_naflex, generate, harness, judge
from port_bench.reference import siglip2

from conftest import tiny_overrides

CELL = "ingest-naflex1024"
SPEC = harness._load("traffic", "ingest-naflex-batch128.json")["terms"][0]
MODEL = harness._load("configs", "siglip2-so400m-naflex-1024.json")["model"]


@pytest.mark.parametrize("seed", [1, 4294967311])
def test_the_terms_grids(seed):
    term = generate.term("image_naflex")
    grids = term.grids(SPEC, 512, seed, MODEL)
    assert grids == term.grids(SPEC, 512, seed, MODEL)  # the seed fixes them
    patches = np.array([h * w for h, w in grids])
    sides = np.array(grids)
    assert patches.max() <= 1024 and patches.min() >= 950
    assert 1000 <= patches.mean() <= 1012
    assert sides.min() >= 18 and sides.max() <= 56
    assert 40 <= len(set(grids)) <= 60
    wide = sum(w > h for h, w in grids)
    assert 200 < wide < 312  # aspect log-uniform about 1
    # each grid is the processor's for some native size in the mix's range
    for h, w in set(grids):
        a = h / w
        assert 1 / 3.2 < a < 3.2


def test_the_term_draws_pictures_at_their_grids():
    term = generate.term("image_naflex")
    m = {**MODEL, "patch_size": 16}
    pics = term.draw(SPEC, 6, 11, m, "cpu")
    for pic, (h, w) in zip(pics, term.grids(SPEC, 6, 11, m)):
        assert pic.dtype == np.uint8 and pic.shape == (16 * h, 16 * w, 3)
    again = term.draw(SPEC, 6, 11, m, "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(pics, again))
    assert not np.array_equal(pics[0][:16, :16], pics[1][:16, :16])


def test_grid_for_is_the_processors_rule():
    assert siglip2.grid_for(1024, 1024, 16, 1024) == (32, 32)
    # transformers' get_image_size_for_max_num_patches: (288, 864), (864, 288)
    assert siglip2.grid_for(480, 1440, 16, 1024) == (18, 54)
    assert siglip2.grid_for(1440, 480, 16, 1024) == (54, 18)


def test_operations_against_a_hand_count():
    m = {"width": 8, "mlp_dim": 12, "patch_size": 2, "depth": 3}
    d, mlp, f = 8, 12, 12
    sizes = [5, 9]  # two pictures' valid patches
    got = flops_naflex.call_flops(m, {"img": 2, "patches": 14, "patches_sq": 25 + 81})
    per_layer = sum(2 * s * d * 3 * d + 4 * s * s * d + 2 * s * d * d + 4 * s * d * mlp
                    for s in sizes)
    patch = sum(2 * s * f * d for s in sizes)
    head = sum(2 * s * d * 2 * d + 4 * s * d + 4 * d * d + 4 * d * mlp for s in sizes)
    assert got == pytest.approx(patch + 3 * per_layer + head)
    # one picture of the full square grid: flops.image_ops' count at that length
    # (its patch embedding reads R*R*3 uint8 pixels: the same operations)
    sq = {"image_size": 64, "patch_size": 2, "width": d, "mlp_dim": mlp, "depth": 3}
    want = sum(op for _, op, _ in flops.image_ops(sq, 1))
    assert flops_naflex.call_flops(sq, {"img": 1, "patches": 1024, "patches_sq": 1024 ** 2}) == \
        pytest.approx(want)
    # and at SO400M/16 about 0.96 TFLOP a picture of 1006 patches
    full = flops_naflex.call_flops(MODEL, {"img": 1, "patches": 1006, "patches_sq": 1006 ** 2})
    assert 0.94e12 < full < 0.98e12
    bound = flops_naflex.call_bound_s(MODEL, {"img": 128, "patches": 128 * 1006,
                                               "patches_sq": 128 * 1006 ** 2})
    assert bound == pytest.approx(128 * full / flops.PEAK_BF16, rel=0.02)


def run_cell(capsys, seed=2147483659):
    rc = harness.main(["--workload", CELL, "--seed", str(seed), "--seconds", "1.5"], cpu=True,
                      overrides=tiny_overrides(CELL))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_transposed_grid_fails(monkeypatch):
    """One picture of a call handed to the tower with its grid's h and w
    swapped (the same number of patches, read in the wrong order and given
    the wrong positions): its row's ``emb_err`` is over the limit, the
    others' under it. (A whole run fails where the sample reads it.)"""
    from meme_search_engine_tpu_torch.models.siglip import SigLIPConfig
    from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine, naflex_views

    ctx = harness.setup(["--workload", CELL, "--seed", "2147483659", "--seconds", "1"], cpu=True,
                        overrides=tiny_overrides(CELL))
    ctx.device = harness.card_device(ctx)
    pics = generate.make(ctx.traffic, ctx.seed, model=ctx.model, device="cpu").inputs[0]
    j = next(i for i, p in enumerate(pics) if p.shape[0] != p.shape[1])
    orig = EmbeddingEngine._pack_naflex

    def broken(self, pictures, *where):
        buf = orig(self, pictures, *where)
        width = self.cfg.max_num_patches * self.cfg.patch_size ** 2 * 3
        grids = naflex_views(buf, width)[1]
        grids[j] = grids[j].flip(0)
        return buf

    monkeypatch.setattr(EmbeddingEngine, "_pack_naflex", broken)
    engine = EmbeddingEngine(data.siglip_params(ctx.model, ctx.seed, "cpu"), SigLIPConfig(**ctx.model),
                             max_batch=ctx.max_batch, device="cpu")
    got = engine.embed_image_list(pics)
    want = judge.reference_rows(ctx, [("image_naflex", p) for p in pics])
    limit = ctx.workload["limits"]["emb_err"]
    errs = [judge.emb_err(got[i:i + 1], want[i:i + 1]) for i in range(len(pics))]
    assert errs[j] > limit
    assert all(e <= limit for i, e in enumerate(errs) if i != j)


def test_a_neighbours_key_mask_fails(capsys, monkeypatch):
    """Each picture attended with its neighbour's valid length in every
    attention and the MAP head (keys cut off or pad keys let in, up to
    64 rows of 1024). A mask off by one row alone moves ``emb_err`` by
    about a tenth of the sound reading (0.0053 against 0.0045 at this
    size): below what the comparison resolves, so the kernel tests hold
    the masked rows bit for bit instead (tests/test_torch_cuda_kernels.py,
    tests/test_torch_siglip2.py)."""
    import torch

    from meme_search_engine_tpu_torch.models import siglip

    enc, head = siglip._encoder_fat, siglip._map_head_fat
    monkeypatch.setattr(siglip, "_encoder_fat", lambda x, blocks, heads, n_valid: enc(
        x, blocks, heads, torch.roll(n_valid, 1)))
    monkeypatch.setattr(siglip, "_map_head_fat", lambda x, lnf, p, heads, n_valid: head(
        x, lnf, p, heads, torch.roll(n_valid, 1)))
    result = run_cell(capsys)
    assert result["correct"] is False
    assert result["checks"]["emb_err"]["value"] > result["checks"]["emb_err"]["limit"]
