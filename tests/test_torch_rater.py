"""Port parity for the rater stack (``rater/*``), against the JAX package's.

- The trainer: 5 steps at dropout 0 from the JAX ``init_ensemble``'s
  parameters (the same key the JAX ``train`` takes) against the JAX
  ``train`` itself, which draws the same batches from the same numpy
  generator: every logged loss within 1e-5 relative, every parameter
  within 1e-5 absolute. Then tests/test_score_model_sae.py's learning
  check on the port, and the port's checkpoint read back.
- Active learning: variances (population variance, as ``jnp.var``),
  the selected pairs (equal), per-pair gradient norms (1e-4 relative).
- The pipeline: the ensemble median over an even member count (the mean
  of the two middle scores, as ``jnp.median``), the duplicate mask
  (equal), the accepted candidates.
- The copies (data, evaluate, crawler, server): DBs and logs read across
  both packages, the same pages, both apps through aiohttp's test client.
"""

import asyncio
import json
import os

import jax
import numpy as np
import pytest
import torch

from meme_search_engine_tpu.models import score_model as jsm
from meme_search_engine_tpu.rater import active_learning as jal
from meme_search_engine_tpu.rater import crawler as jcrawler
from meme_search_engine_tpu.rater import data as jdata
from meme_search_engine_tpu.rater import evaluate as jeval
from meme_search_engine_tpu.rater import meme_pipeline as jpipe
from meme_search_engine_tpu.rater import server as jserver
from meme_search_engine_tpu.rater import train as jtrain
from meme_search_engine_tpu_torch.models import score_model as tsm
from meme_search_engine_tpu_torch.rater import active_learning as tal
from meme_search_engine_tpu_torch.rater import crawler as tcrawler
from meme_search_engine_tpu_torch.rater import data as tdata
from meme_search_engine_tpu_torch.rater import evaluate as teval
from meme_search_engine_tpu_torch.rater import meme_pipeline as tpipe
from meme_search_engine_tpu_torch.rater import server as tserver
from meme_search_engine_tpu_torch.rater import train as ttrain

CFG = dict(d_emb=32, n_hidden=1, n_ensemble=4, output_channels=3)


def _tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def both():
    params = jsm.init_ensemble(jax.random.PRNGKey(0), jsm.ScoreModelConfig(**CFG))
    return params, tsm.params_from_jax(_tree(params), device="cpu")


def _preference_data(seed=3, n_items=200, n_pairs=300, d=32):
    """A synthetic linear preference: the better item of each pair wins
    with probability 0.9 on all three axes."""
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal(d)
    items = rng.standard_normal((n_items, d)).astype(np.float32)
    quality = items @ w_true
    idx = rng.integers(0, n_items, (n_pairs, 2))
    idx = idx[idx[:, 0] != idx[:, 1]]
    better = quality[idx[:, 0]] > quality[idx[:, 1]]
    targets = np.repeat(np.where(better[:, None], 0.9, 0.1).astype(np.float32), 3, axis=1)
    return rng, items, quality, items[idx], targets


def test_train_five_steps_match_jax(tmp_path):
    _, _, _, pairs, targets = _preference_data()
    val = (pairs[:20], targets[:20])
    cfg = jsm.ScoreModelConfig(**CFG)
    # the JAX train's own initial parameters
    _, k_init = jax.random.split(jax.random.PRNGKey(0))
    start = tsm.params_from_jax(_tree(jsm.init_ensemble(k_init, cfg)), device="cpu")
    settings = dict(steps=5, batch_size=64, dropout=0.0, lr=1e-3)
    jparams, jhist = jtrain.train(pairs, targets, cfg, jtrain.TrainSettings(**settings), val=val)
    log = str(tmp_path / "log.jsonl")
    tparams, thist = ttrain.train(pairs, targets, tsm.ScoreModelConfig(**CFG),
                                  ttrain.TrainSettings(**settings, log_path=log), val=val,
                                  device="cpu", params=start)
    assert [sorted(h) for h in thist] == [sorted(h) for h in jhist]
    for jh, th in zip(jhist, thist):
        for key in ("loss", "val_loss"):
            if key in jh:
                assert abs(th[key] - jh[key]) <= 1e-5 * abs(jh[key]), (jh, th)
    want = tsm.params_from_jax(_tree(jparams), device="cpu")
    for (name, got), ref in zip(tparams.named_parameters(), want.parameters()):
        np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    # the start was copied, not trained in place
    assert torch.equal(start.output.b, torch.zeros_like(start.output.b))
    # both packages read the port's log
    for pkg in (jeval, teval):
        curves = pkg.loss_curves(log)
        assert curves["loss"] == [h["loss"] for h in thist]
        assert curves["val_loss"] == [thist[0]["val_loss"]]


def test_rater_training_learns(tmp_path):
    """tests/test_score_model_sae.py::test_rater_training_learns on the
    port: the loss drops and held-out pairs rank right."""
    rng, items, quality, pairs, targets = _preference_data()
    log = str(tmp_path / "log.jsonl")
    params, history = ttrain.train(
        pairs, targets, tsm.ScoreModelConfig(**CFG),
        ttrain.TrainSettings(steps=300, batch_size=64, dropout=0.0, lr=1e-3, log_path=log),
        device="cpu")
    assert history[-1]["loss"] < history[0]["loss"] * 0.8
    with open(log) as f:
        assert len(f.readlines()) == 300
    scores = tsm.ensemble_forward(params, items).mean(dim=0)[:, 0].detach().numpy()
    test_pairs = rng.integers(0, 200, (100, 2))
    test_pairs = test_pairs[quality[test_pairs[:, 0]] > quality[test_pairs[:, 1]] + 1.0]
    acc = np.mean(scores[test_pairs[:, 0]] > scores[test_pairs[:, 1]])
    assert acc > 0.8, acc


def test_checkpoint_restores_params_and_moments(tmp_path):
    _, _, _, pairs, targets = _preference_data()
    cfg = tsm.ScoreModelConfig(**CFG)
    params, _ = ttrain.train(pairs, targets, cfg, ttrain.TrainSettings(
        steps=1, batch_size=32, dropout=0.1, checkpoint_dir=str(tmp_path)), device="cpu")
    fresh = tsm.init_ensemble(cfg, torch.Generator().manual_seed(9), "cpu")
    fresh_opt = torch.optim.AdamW(fresh.parameters(), lr=3e-4, **ttrain.ADAMW_DEFAULTS)
    ttrain.load_checkpoint(str(tmp_path / "ckpt_0"), fresh, fresh_opt)
    data = np.load(str(tmp_path / "ckpt_0" / "state.npz"))
    for (name, p), trained in zip(fresh.named_parameters(), params.parameters()):
        np.testing.assert_array_equal(p.detach().numpy(), data[f"param/{name}"])
        np.testing.assert_array_equal(p.detach().numpy(), trained.detach().numpy())
        state = fresh_opt.state[p]
        assert float(state["step"]) == 1.0
        np.testing.assert_array_equal(state["exp_avg"].numpy(), data[f"exp_avg/{name}"])
        np.testing.assert_array_equal(state["exp_avg_sq"].numpy(), data[f"exp_avg_sq/{name}"])
    assert len(fresh_opt.state) == 4


def test_ratings_db_read_across_packages(tmp_path):
    rng = np.random.default_rng(4)
    for writer, reader in ((jdata, tdata), (tdata, jdata)):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}.db")
        db = writer.RatingsDB(path)
        for i in range(10):
            db.add_file(f"m{i}.png", rng.standard_normal(16))
        db.add_rating("m0.png", "m1.png", "1+")
        db.add_rating("m2.png", "m3.png", "2", axis="meme")
        db.push_queue([("a", "b"), ("c", "d")])
        back, same = reader.RatingsDB(path), writer.RatingsDB(path)
        for a, b in zip(back.pairs(), same.pairs()):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        pairs, targets, names = back.pairs()
        assert pairs.shape == (2, 2, 16)
        row = dict(zip(names, targets))
        np.testing.assert_allclose(row[("m0.png", "m1.png")], [0.9, 0.5, 0.5])
        np.testing.assert_allclose(row[("m2.png", "m3.png")], [0.5, 0.3, 0.5])
        (tr, _), (va, _) = back.train_val_split()
        assert len(tr) + len(va) == 2
        assert back.pop_queue() == ("a", "b") and same.pop_queue() == ("c", "d")
        assert back.pop_queue() is None
    assert tdata.RATING_PROBS == jdata.RATING_PROBS
    assert all(tdata.is_validation(f"m{i}") == jdata.is_validation(f"m{i}") for i in range(256))


def test_active_learning_matches_jax(both, monkeypatch):
    jp, tp = both
    rng = np.random.default_rng(5)
    embs = rng.standard_normal((50, 32)).astype(np.float32)
    var = tal.ensemble_variance(tp, embs, device="cpu")
    np.testing.assert_allclose(var, jal.ensemble_variance(jp, embs), rtol=1e-5)
    # the population variance (a default torch.var would be 4/3 of it)
    out = tsm.ensemble_forward(tp, embs).detach().numpy()
    np.testing.assert_allclose(var, out.var(axis=0, ddof=0).sum(-1), rtol=1e-6)
    assert not np.allclose(var, out.var(axis=0, ddof=1).sum(-1), rtol=1e-3)

    pairs = tal.select_pairs_by_variance(tp, embs, 5, device="cpu")
    assert pairs == jal.select_pairs_by_variance(jp, embs, 5)
    assert len(pairs) == 5 and all(a != b for a, b in pairs)

    p = rng.standard_normal((6, 2, 32)).astype(np.float32)
    t = rng.uniform(0.1, 0.9, (6, 3)).astype(np.float32)
    monkeypatch.setattr(tal, "GRAD_CHUNK", 4)  # two chunks, the second ragged
    norms = tal.gradient_norms(tp, p, t, device="cpu")
    np.testing.assert_allclose(norms, jal.gradient_norms(jp, p, t), rtol=1e-4)
    assert norms.shape == (6,) and np.all(norms > 0)

    for pct in (50, 90):
        got = tal.select_top_percentile_pairs(var, 4, percentile=pct)
        assert got == jal.select_top_percentile_pairs(var, 4, percentile=pct) and len(got) == 4


def test_score_candidates_takes_the_midpoint_median(both):
    """E = 4 members: the median is the mean of the two middle scores, as
    ``jnp.median`` takes it; ``torch.median`` would give the lower one."""
    jp, tp = both
    embs = np.random.default_rng(6).standard_normal((20, 32)).astype(np.float32)
    for channel in (0, 2):
        got = tpipe.score_candidates(embs, tp, channel, device="cpu")
        np.testing.assert_allclose(got, jpipe.score_candidates(embs, jp, channel), rtol=1e-5, atol=1e-5)
        out = tsm.ensemble_forward(tp, embs)[:, :, channel].detach()
        np.testing.assert_array_equal(got, np.asarray(jax.numpy.median(out.numpy(), axis=0)))
        assert not np.allclose(got, torch.median(out, dim=0).values.numpy(), atol=1e-4)


def test_meme_pipeline_filter_matches_jax():
    """tests/test_rater_aux.py::test_meme_pipeline_filter on both
    packages: two candidates planted in the library are flagged and
    dropped, the rest accepted in the same order with the same scores."""
    cfg = jsm.ScoreModelConfig(d_emb=16, n_hidden=1, n_ensemble=4, output_channels=1)
    jp = jsm.init_ensemble(jax.random.PRNGKey(0), cfg)
    tp = tsm.params_from_jax(_tree(jp), device="cpu")
    rng = np.random.default_rng(0)
    embs = rng.standard_normal((10, 16)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    library = np.concatenate([embs[:2], rng.standard_normal((5, 16))])
    library /= np.linalg.norm(library, axis=1, keepdims=True)

    dups = tpipe.near_duplicates(embs, library, device="cpu")
    np.testing.assert_array_equal(dups, jpipe.near_duplicates(embs, library))
    assert dups[0] and dups[1] and not dups[2:].any()
    assert not tpipe.near_duplicates(embs, library[:0], device="cpu").any()

    urls = [f"u{i}" for i in range(10)]
    got = tpipe.filter_candidates(urls, embs, tp, library, score_threshold=-np.inf, device="cpu")
    want = jpipe.filter_candidates(urls, embs, jp, library, score_threshold=-np.inf)
    assert [c.url for c in got] == [c.url for c in want] and len(got) == 8
    np.testing.assert_allclose([c.score for c in got], [c.score for c in want], rtol=1e-5, atol=1e-5)
    scores = [c.score for c in got]
    assert scores == sorted(scores, reverse=True)


def test_evaluate_equals_jax(tmp_path):
    labels = np.array([1, 1, 1, 0, 0, 0], bool)
    scores = np.array([3.0, 2.5, 2.0, 1.0, 0.5, 0.1])
    assert teval.auroc(labels, scores) == pytest.approx(1.0)
    assert teval.auroc(labels, -scores) == pytest.approx(0.0)
    rng = np.random.default_rng(7)
    lab, sc = rng.random(100) > 0.5, rng.standard_normal(100)
    for a, b in zip(teval.roc_curve(lab, sc), jeval.roc_curve(lab, sc)):
        np.testing.assert_array_equal(a, b)
    pairs, prefers = [(0, 1), (1, 2), (2, 0), (0, 2)], [True, True, False, True]
    item_scores = np.array([5.0, 3.0, 1.0])
    assert teval.pairwise_auroc(item_scores, pairs, prefers) == pytest.approx(1.0)
    names = [f"m{i}.png" for i in range(100)]
    sheet = teval.percentile_sheet(names, np.arange(100, dtype=np.float32), per_bucket=3)
    assert sheet == jeval.percentile_sheet(names, np.arange(100, dtype=np.float32), per_bucket=3)
    assert sheet.startswith("<!doctype") and "p50" in sheet


def test_crawler_paging_and_ratelimit():
    pages = {
        None: {"data": {"children": [{"data": {"id": "a"}}], "after": "t3_x"}},
        "t3_x": {"data": {"children": [{"data": {"id": "b"}}], "after": None}},
    }
    for pkg in (tcrawler, jcrawler):
        calls = {"n": 0, "slept": 0}

        def fetch(url):
            calls["n"] += 1
            if calls["n"] == 1:
                return 429, {"retry-after": "1"}, b""
            after = url.split("after=")[1].split("&")[0] if "after=" in url else None
            return 200, {"x-ratelimit-remaining": "50"}, json.dumps(pages[after]).encode()

        posts = list(pkg.crawl_multireddit(
            "u", "memes", fetch=fetch, sleep=lambda s: calls.__setitem__("slept", s)))
        assert [p["id"] for p in posts] == ["a", "b"]
        assert calls["slept"] == 1.0  # respected retry-after


def test_rater_app_through_aiohttp(tmp_path):
    """Both packages' rating UI on one DB: the queued pair's page, an
    image, a rating stored, a bad rating refused."""
    from aiohttp.test_utils import TestClient, TestServer

    images = tmp_path / "images"
    images.mkdir()
    (images / "m0.png").write_bytes(b"png0")

    async def run(pkg, db):
        client = TestClient(TestServer(pkg.make_app(db, str(images))))
        await client.start_server()
        try:
            page = await (await client.get("/")).text()
            img = await client.get("/image/m0.png")
            missing = await client.get("/image/nope.png")
            ok = await client.post("/rate", json={"m1": "m0.png", "m2": "m1.png", "axis": "meme",
                                                   "rating": "2+"})
            bad = await client.post("/rate", json={"m1": "m0.png", "m2": "m1.png", "axis": "meme",
                                                    "rating": "3"})
            return page, img.status, await img.read(), missing.status, await ok.json(), bad.status
        finally:
            await client.close()

    pages = []
    for pkg, data in ((tserver, tdata), (jserver, jdata)):
        db = data.RatingsDB(str(tmp_path / f"{pkg.__name__.split('.')[0]}.db"))
        for i in range(2):
            db.add_file(f"m{i}.png", np.ones(4))
        db.push_queue([("m0.png", "m1.png")])
        page, img_status, img, missing, ok, bad = asyncio.run(run(pkg, db))
        assert 'src="/image/m0.png"' in page and 'src="/image/m1.png"' in page
        assert (img_status, img, missing, ok, bad) == (200, b"png0", 404, {"ok": True}, 400)
        pairs, targets, names = db.pairs()
        assert names == [("m0.png", "m1.png")]
        np.testing.assert_allclose(targets[0], [0.5, 0.1, 0.5])
        pages.append(page)
    assert pages[0] == pages[1]


def test_queue_app_through_aiohttp(tmp_path):
    """The port's assignment queue: enqueue (no duplicate URLs), ``GET /``
    shows the first candidate, ``POST /skip`` pops it, ``POST /assign``
    saves the next one's bytes from a local image host."""
    from aiohttp import web
    from aiohttp.test_utils import TestClient, TestServer

    blobs = {f"/img/{i}.png": f"image {i}".encode() for i in range(3)}

    async def serve(request):
        return web.Response(body=blobs[request.path], content_type="image/png")

    host = web.Application()
    host.router.add_get("/img/{name}", serve)
    queue_path, memes = str(tmp_path / "queue.json"), tmp_path / "memes"
    memes.mkdir()

    async def run():
        host_server = TestServer(host, host="127.0.0.1")
        await host_server.start_server()
        base = f"http://127.0.0.1:{host_server.port}"
        cands = [tpipe.Candidate(url=base + p, embedding=np.zeros(2), score=1.0 - i / 10)
                 for i, p in enumerate(blobs)]
        tpipe.enqueue_candidates(queue_path, cands[:2])
        tpipe.enqueue_candidates(queue_path, cands)
        client = TestClient(TestServer(tpipe.make_queue_app(queue_path, str(memes))))
        await client.start_server()
        try:
            first = await (await client.get("/")).text()
            skipped = await client.post("/skip", allow_redirects=False)
            second = await (await client.get("/")).text()
            assigned = await client.post("/assign", data={"filename": "saved.png"},
                                         allow_redirects=False)
            return cands, first, skipped.status, second, assigned.status
        finally:
            await client.close()
            await host_server.close()

    cands, first, skipped, second, assigned = asyncio.run(run())
    assert cands[0].url in first and "3 queued" in first
    assert skipped == 302 and cands[1].url in second and "2 queued" in second
    assert assigned == 302
    assert (memes / "saved.png").read_bytes() == b"image 1"
    with open(queue_path) as f:
        assert [e["url"] for e in json.load(f)] == [cands[2].url]
    assert os.listdir(memes) == ["saved.png"]
