"""SigLIP 2 NaFlex in the port, on the CPU at tiny sizes with seeded
random weights: the port's NaFlex tower and text tower against the plain
reference (``tests/siglip2_reference.py``), that reference against
``transformers``' ``Siglip2VisionModel`` and ``Siglip2TextModel`` through
``load_hf_siglip2``, the processor's grid rule, the position weights and
the patchify, per-sequence key masks through the plain route, a batch of
mixed grids against each picture alone, the engine's and the model's
NaFlex spans, the clip server's choice of model, the decode's resize
against ``Siglip2ImageProcessor``'s, and the library indexer keeping each
picture's aspect ratio in process and through the clip server.
"""

import io

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import siglip2_reference as ref
# before transformers: its image processor's imports load a SQLite
# without FTS5, which the ingest DB needs, if sqlite3 is not loaded yet
from meme_search_engine_tpu_torch.ingest.db import IngestDB
from meme_search_engine_tpu_torch.models import siglip
from meme_search_engine_tpu_torch.ops import attention, fused
from meme_search_engine_tpu_torch.serving import preprocess
from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine
from meme_search_engine_tpu_torch.utils import profiling

CFG = siglip.tiny_naflex_test_config(64)  # patch 4, a 4 x 4 table, 64 rows a picture
# grids of the tiny tower: square, wide, tall, ragged, one row, one patch
GRIDS = [(8, 8), (4, 16), (16, 4), (5, 7), (1, 13), (1, 1)]


def _tree(cfg=CFG, seed=0):
    """Both towers from a seed, with biases and LayerNorm offsets drawn
    too (``init_params`` leaves them zero)."""
    gen = torch.Generator().manual_seed(seed)
    p = siglip.init_params(cfg, gen, "cpu")

    def jitter(t):
        if isinstance(t, dict):
            return {k: jitter(v) for k, v in t.items()}
        return (t.float() + 0.05 * torch.randn(t.shape, generator=gen)).to(t.dtype)

    return {"img": jitter(p["img"]), "txt": jitter(p["txt"]), "t": p["t"], "b": p["b"]}


def _pictures(grids, patch=CFG.patch_size, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (patch * h, patch * w, 3), dtype=np.uint8) for h, w in grids]


def _pixels(pictures, cfg=CFG):
    buf = np.zeros((len(pictures), cfg.max_num_patches * cfg.patch_size ** 2 * 3), np.uint8)
    for j, pic in enumerate(pictures):
        buf[j, : pic.size] = pic.reshape(-1)
    return torch.from_numpy(buf)


@pytest.fixture(scope="module")
def tree():
    return _tree()


@pytest.fixture(scope="module")
def prepared(tree):
    return siglip.prepare_params(tree, CFG)


def test_naflex_tower_matches_the_reference(tree, prepared):
    pics = _pictures(GRIDS)
    got = siglip.encode_image(prepared, _pixels(pics), CFG, grids=np.array(GRIDS))
    want = ref.encode_pictures(ref.to_fp32(tree["img"]), pics, CFG.patch_size, CFG.max_num_patches,
                               CFG.num_heads)
    assert got.shape == (len(GRIDS), CFG.d_emb)
    # bf16 activations against fp32: the reference's own rounding scale
    assert float((got - want).norm(dim=-1).max()) < 0.03


def test_text_tower_matches_the_reference(tree, prepared):
    tokens = torch.randint(0, CFG.vocab_size, (5, CFG.text_len), generator=torch.Generator().manual_seed(2))
    got = siglip.encode_text(prepared, tokens, CFG)
    want = ref.encode_text(ref.to_fp32(tree["txt"]), tokens, CFG.text_num_heads)
    assert float((got - want).norm(dim=-1).max()) < 0.03


def test_patches_and_pixels_give_the_same_embeddings(prepared):
    pics = _pictures(GRIDS)
    values, _, grids = ref.pack(pics, CFG.patch_size, CFG.max_num_patches)
    from_pixels = siglip.encode_image(prepared, _pixels(pics), CFG, grids=grids)
    # the patches as uint8 in row-major grid order, (row, col, channel) each
    patches = torch.stack([torch.cat([ref.patchify(torch.from_numpy(p), CFG.patch_size),
                                      torch.zeros(CFG.max_num_patches - h * w, 48, dtype=torch.uint8)])
                           for p, (h, w) in zip(pics, GRIDS)])
    assert torch.equal(siglip.encode_image(prepared, patches, CFG, grids=grids), from_pixels)
    pre = siglip.encode_image(prepared, values, CFG, grids=grids, preprocessed=True)
    assert float((pre - from_pixels).abs().max()) < 1e-2


def test_patchify_is_the_processors():
    pics = _pictures(GRIDS)
    got = siglip.naflex_patchify(_pixels(pics), torch.tensor(GRIDS, dtype=torch.int32), CFG)
    for j, (pic, (h, w)) in enumerate(zip(pics, GRIDS)):
        assert torch.equal(got[j, : h * w], ref.patchify(torch.from_numpy(pic), CFG.patch_size))
        assert not got[j, h * w:].any()


@pytest.mark.parametrize("side", [4, 16])
def test_position_weights_resize_as_the_published_model(side):
    """Every picture's table through the weights against
    ``F.interpolate(bilinear, antialias=True)`` of that picture alone:
    grids up from the table's side (upsampling), down (where the
    antialiasing widens the triangle) and across; pad rows the first row."""
    gen = torch.Generator().manual_seed(3)
    table = torch.randn(side * side, 8, generator=gen)
    grids = torch.tensor([(side, side), (side + 2, 3 * side), (3 * side, side + 1),
                          (side + 7, side + 5), (1, 1), (1, 3 * side), (side - 1, 2),
                          (side // 2 + 1, side + 3), (3, 55)], dtype=torch.int32)
    rows = int((grids[:, 0] * grids[:, 1]).max()) + 5
    got = siglip.naflex_position_weights(grids, rows, side) @ table
    want = ref.resize_positions(table, grids.long(), rows)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_grid_rule_is_the_processors():
    transformers = pytest.importorskip("transformers")  # noqa: F841
    from transformers.models.siglip2.image_processing_siglip2 import (
        get_image_size_for_max_num_patches as hf)

    rng = np.random.default_rng(4)
    sizes = [(int(h), int(w)) for h, w in rng.integers(1, 4000, (400, 2))]
    sizes += [(1, 1), (16, 16), (480, 1600), (1600, 480), (512, 512), (3000, 1), (1, 3000)]
    for h, w in sizes:
        for patch, cap in ((16, 1024), (16, 256), (16, 576), (14, 784)):
            want = hf(h, w, patch, cap)
            assert preprocess.image_size_for_max_num_patches(h, w, patch, cap) == want
            assert ref.image_size_for_max_num_patches(h, w, patch, cap) == want
            gh, gw = preprocess.naflex_grid(h, w, patch, cap)
            assert (gh * patch, gw * patch) == want and gh * gw <= cap


def test_sequence_key_masks_through_the_plain_route():
    """``ln_matmul_plain`` with each sequence's own valid length equals the
    one-scalar mask applied to each sequence alone."""
    gen = torch.Generator().manual_seed(5)
    b, sp, k, h, dh = 4, 48, 32, 4, 16
    c = attention.fat_width(dh)
    x = torch.randn(b, sp, k, generator=gen).to(torch.bfloat16)
    g, be = torch.ones(k, dtype=torch.bfloat16), torch.zeros(k, dtype=torch.bfloat16)
    w = (0.2 * torch.randn(k, 3 * h * c, generator=gen)).to(torch.bfloat16)
    bias = torch.zeros(3 * h * c, dtype=torch.bfloat16)
    lens = torch.tensor([48, 1, 37, 40], dtype=torch.int32)
    got = fused.ln_matmul(x, g, be, w, bias, k_mask=(lens, h, c, dh))
    for j, n in enumerate(lens.tolist()):
        one = fused.ln_matmul_plain(x[j:j + 1], g, be, w, bias, k_mask=(n, h, c, dh))
        assert torch.equal(got[j:j + 1], one)
    keys = got[..., h * c: 2 * h * c].reshape(b, sp, h, c)
    assert (keys[1, 1:, :, dh] == -1e30).all() and (keys[1, 1:, :, :dh] == 0).all()


def test_a_mixed_batch_gives_each_picture_its_embedding_alone(tree):
    engine = EmbeddingEngine(tree, CFG, max_batch=4, device="cpu")
    pics = _pictures(GRIDS + [(3, 20), (2, 2)], seed=6)
    together = engine.embed_image_list(pics)  # buckets of 4 and 4
    for j, pic in enumerate(pics):
        np.testing.assert_allclose(engine.embed_image_list([pic])[0], together[j], atol=1e-6)
    # the same rows through embed_image_arrays where the pictures share a size
    same = _pictures([(5, 7)] * 3, seed=7)
    np.testing.assert_array_equal(engine.embed_image_arrays(np.stack(same)),
                                  engine.embed_image_list(same))
    with pytest.raises(ValueError, match="NaFlex picture"):
        engine.embed_image_list([np.zeros((10, 8, 3), np.uint8)])
    with pytest.raises(ValueError, match="NaFlex picture"):
        engine.embed_image_list([np.zeros((4 * 9, 4 * 8, 3), np.uint8)])  # 72 > 64 patches


def test_naflex_spans_count_the_bucket(tree):
    engine = EmbeddingEngine(tree, CFG, max_batch=4, device="cpu")
    pics = _pictures([(8, 8), (4, 16), (8, 8), (5, 7), (1, 13)], seed=8)
    profiling.start_recording()
    try:
        engine.embed_image_list(pics)
    finally:
        spans = profiling.stop_recording()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    packs, positions, buckets = by["engine.pack"], by["siglip.positions"], by["engine.bucket"]
    # a row of pixels and 8 bytes of grid a picture, in one buffer
    assert [p.counts for p in packs] == [
        {"images": 4, "grids": 3, "patches": 64 + 64 + 64 + 35, "rows": 4 * 64,
         "bytes": 4 * (64 * 48 + 8)},
        {"images": 1, "grids": 1, "patches": 13, "rows": 64, "bytes": 64 * 48 + 8}]
    assert [p.counts for p in positions] == [{"images": 4}, {"images": 1}]
    for p, q, bk in zip(packs, positions, buckets):
        assert p.parent == bk.id and p.end_ns <= q.start_ns
    h2d = by["engine.h2d"]
    assert [s.counts["bytes"] for s in h2d] == [4 * (64 * 48 + 8), 64 * 48 + 8]
    assert len(h2d) == len(packs)  # one copy a part: the grids ride in the pictures' buffer


def test_a_bucket_in_parts_gives_the_same_embeddings(tree, monkeypatch):
    """A bucket run in parts (each packed, copied in and launched before
    the next is packed, then all fetched) gives the embeddings of one
    launch, with an ``engine.pack`` span a part inside its bucket."""
    from meme_search_engine_tpu_torch.serving import engine as engine_mod

    engine = EmbeddingEngine(tree, CFG, max_batch=4, device="cpu")
    pics = _pictures(GRIDS + [(3, 20)], seed=10)
    whole = engine.embed_image_list(pics)
    monkeypatch.setattr(engine_mod, "NAFLEX_PART", 3)
    profiling.start_recording()
    try:
        parted = engine.embed_image_list(pics)  # buckets 4, 2, 1: parts 3 + 1, 2, 1
    finally:
        spans = profiling.stop_recording()
    np.testing.assert_array_equal(parted, whole)
    buckets = {s.id: s for s in spans if s.name == "engine.bucket"}
    packs = [s for s in spans if s.name == "engine.pack"]
    assert [p.counts["images"] for p in packs] == [3, 1, 2, 1]
    assert [buckets[p.parent].counts["rows"] for p in packs] == [4, 4, 2, 1]
    d2h = [s for s in spans if s.name == "engine.d2h"]
    assert len(d2h) == 4 and all(s.parent in buckets for s in d2h)


def test_naflex_engine_device_list_equals_one_device(tree):
    """A NaFlex engine over ["cpu", "cpu"] splits a bucket of mixed grids
    that divides by 2 across its replicas, each replica's part packed
    into a staging slot of its own, and gives one device's embeddings."""
    single = EmbeddingEngine(tree, CFG, max_batch=8, device="cpu")
    multi = EmbeddingEngine(tree, CFG, max_batch=8, mesh=["cpu", "cpu"])
    pics = _pictures(GRIDS + [(3, 20), (2, 2), (7, 9)], seed=11)  # buckets of 8 and 1
    np.testing.assert_allclose(multi.embed_image_list(pics), single.embed_image_list(pics), atol=1e-6)
    # (pictures, (replica, first row)): the bucket of 8 as 4 on each, the bucket of 1 on the first
    assert set(multi._staging) == {(4, (0, 0)), (4, (1, 0)), (1, (0, 0))}
    assert set(single._staging) == {(8, (0, 0)), (1, (0, 0))}


def test_hf_siglip2_matches_the_reference(tmp_path):
    transformers = pytest.importorskip("transformers")
    from safetensors.torch import save_file

    width, depth, heads, mlp, vocab, text_len = 64, 2, 4, 96, 128, 16
    cfg = transformers.Siglip2Config(
        vision_config=dict(hidden_size=width, num_hidden_layers=depth, num_attention_heads=heads,
                           intermediate_size=mlp, patch_size=4, num_patches=16),
        text_config=dict(hidden_size=width, num_hidden_layers=depth, num_attention_heads=heads,
                         intermediate_size=mlp, vocab_size=vocab, max_position_embeddings=text_len,
                         projection_size=width))
    torch.manual_seed(0)
    model = transformers.Siglip2Model(cfg).eval()
    with torch.no_grad():  # no zero biases or offsets left to hide a mapping
        for prm in model.parameters():
            prm.add_(0.05 * torch.randn_like(prm))
    path = tmp_path / "model.safetensors"
    save_file({k: v.contiguous() for k, v in model.state_dict().items()}, str(path))
    ours = siglip.SigLIPConfig(image_size=16, patch_size=4, width=width, depth=depth, mlp_dim=mlp,
                               num_heads=heads, text_width=width, text_depth=depth,
                               text_mlp_dim=mlp, text_num_heads=heads, vocab_size=vocab,
                               text_len=text_len, d_emb=width, param_dtype=torch.float32,
                               max_num_patches=64)
    tree = siglip.load_hf_siglip2(str(tmp_path), ours)
    assert tuple(tree["img"]["patch_embed"]["w"].shape) == (48, width)
    assert tuple(tree["img"]["pos_emb"].shape) == (16, width)
    pics = _pictures(GRIDS, seed=9)
    values, mask, grids = ref.pack(pics, 4, 64)
    with torch.no_grad():
        hf_img = model.vision_model(pixel_values=values, attention_mask=mask.long(),
                                    spatial_shapes=grids).pooler_output
        tokens = torch.randint(0, vocab, (3, text_len), generator=torch.Generator().manual_seed(1))
        hf_txt = model.text_model(input_ids=tokens).pooler_output
    want_img = F.normalize(hf_img, dim=-1)
    got_img = ref.encode_image(tree["img"], values, mask, grids, heads)
    torch.testing.assert_close(got_img, want_img, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ref.encode_text(tree["txt"], tokens, heads),
                               F.normalize(hf_txt, dim=-1), rtol=1e-4, atol=1e-4)
    # and the port's own tower on the HF weights: fp32 parameters, but the
    # fat route's cast points (LN outputs and attention probabilities in bf16)
    port = siglip.prepare_params(tree, ours)
    got = siglip.encode_image(port, _pixels(pics, ours), ours, grids=grids)
    assert float((got - want_img).norm(dim=-1).max()) < 1e-2
    with pytest.raises(ValueError, match="NaFlex"):
        siglip.load_hf_siglip2(str(tmp_path), siglip.tiny_test_config())


def test_clip_server_serves_pictures_at_their_own_sizes():
    """``build_engine`` picks the NaFlex tower by ``model_name``; the app
    resizes each picture to its own grid in the decode pool and the
    worker hands the list to ``embed_image_list``."""
    pytest.importorskip("aiohttp")
    Image = pytest.importorskip("PIL.Image")
    import asyncio

    import msgpack
    from aiohttp.test_utils import TestClient, TestServer

    from meme_search_engine_tpu_torch.serving import clip_server
    from meme_search_engine_tpu_torch.utils.fp16 import decode_fp16_buffer

    engine = clip_server.build_engine({"device": "cpu", "model_name": "tiny-siglip2-naflex",
                                       "max_batch_size": 4, "max_num_patches": 48})
    assert engine.cfg.max_num_patches == 48 and engine.cfg.patch_size == 4
    bodies = []
    for size, colour in (((90, 30), (200, 10, 10)), ((20, 64), (0, 90, 250)), ((33, 33), (5, 5, 5))):
        buf = io.BytesIO()
        Image.new("RGB", size, colour).save(buf, "PNG")
        bodies.append(buf.getvalue())
    pics = [preprocess.decode_and_resize_naflex(b, 4, 48) for b in bodies]
    assert len({p.shape for p in pics}) == 3
    want = engine.embed_image_list(pics).astype(np.float16).astype(np.float32)

    async def run():
        client = TestClient(TestServer(clip_server.make_app(engine, {"max_batch_size": 4})))
        await client.start_server()
        try:
            cfg = msgpack.unpackb(await (await client.get("/config")).read(), raw=False)
            # no one size to resize to: the grid rule's two numbers instead
            assert cfg["image_size"] is None
            assert (cfg["patch_size"], cfg["max_num_patches"]) == (4, 48)
            resp = await client.post("/", data=msgpack.packb({"images": bodies}))
            assert resp.status == 200
            out = msgpack.unpackb(await resp.read(), raw=False)
            for got, w in zip(out, want):
                np.testing.assert_array_equal(decode_fp16_buffer(got), w)
        finally:
            await client.close()

    asyncio.run(run())
    assert siglip.SO400M_16_NAFLEX_1024.num_patches == 256
    assert siglip.SO400M_16_NAFLEX_1024.vocab_size == 256_000


def test_decode_resizes_to_the_pictures_grid():
    Image = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    Image.new("RGB", (1600, 480), (10, 200, 30)).save(buf, format="PNG")
    got = preprocess.decode_and_resize_naflex(buf.getvalue(), 16, 1024)
    h, w = preprocess.naflex_grid(480, 1600, 16, 1024)
    assert got.shape == (16 * h, 16 * w, 3) and got.dtype == np.uint8
    assert h * w <= 1024 and w > 3 * h - 3


@pytest.mark.parametrize("size, cap", [((480, 1600), 1024), ((37, 23), 1024), ((1000, 333), 256),
                                       ((20, 300), 64), ((256, 256), 256)])
def test_decode_resizes_as_the_published_processor(size, cap):
    """The pixels ``decode_and_resize_naflex`` hands the tower are those
    ``Siglip2ImageProcessor`` resizes to (PIL bilinear), shrinking and
    enlarging, and a picture at its grid's size already is left alone."""
    transformers = pytest.importorskip("transformers")
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(size[0] * 7 + size[1])
    coarse = rng.integers(0, 256, (size[0] // 8 + 2, size[1] // 8 + 2, 3), dtype=np.uint8)
    arr = np.asarray(Image.fromarray(coarse).resize(size[::-1], Image.Resampling.BICUBIC))
    arr = np.clip(arr.astype(np.int16) + rng.integers(-20, 21, arr.shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    got = preprocess.decode_and_resize_naflex(buf.getvalue(), 16, cap)
    proc = transformers.Siglip2ImageProcessor(patch_size=16, max_num_patches=cap)
    out = proc(images=[Image.open(io.BytesIO(buf.getvalue()))], return_tensors="np")
    gh, gw = (int(v) for v in out["spatial_shapes"][0])
    assert got.shape == (16 * gh, 16 * gw, 3)
    assert int(out["pixel_attention_mask"][0].sum()) == gh * gw
    # the processor's [-1, 1] values back to the uint8 pixels they came from
    want = np.rint((out["pixel_values"][0, : gh * gw] * 0.5 + 0.5) * 255).astype(np.int16)
    patches = ref.patchify(torch.from_numpy(got), 16).numpy().astype(np.int16)
    np.testing.assert_array_equal(patches, want)


def _library_of_shapes(path):
    """Pictures of five aspect ratios: wide, tall, one larger than the
    cap (the client shrinks it), a small one (the server enlarges it)."""
    Image = pytest.importorskip("PIL.Image")
    path.mkdir()
    rng = np.random.default_rng(11)
    sizes = {"wide.png": (30, 90), "tall.png": (64, 20), "big.png": (200, 50), "small.png": (7, 3),
             "square.png": (40, 40)}
    bodies = {}
    for name, (h, w) in sizes.items():
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path / name)
        bodies[name] = (path / name).read_bytes()
    return bodies


def test_ingest_keeps_each_pictures_aspect(tmp_path):
    """The library indexer on a NaFlex engine, in process and through the
    clip server: each picture's stored embedding is the one
    ``embed_image_list`` gives the picture at its own grid (not at a
    square), so the model sees it as the published processor would."""
    pytest.importorskip("aiohttp")
    import asyncio

    from aiohttp.test_utils import TestServer

    from meme_search_engine_tpu_torch.ingest.filename import Actual, encode_filename
    from meme_search_engine_tpu_torch.ingest.pipeline import IngestService
    from meme_search_engine_tpu_torch.serving import clip_server
    from meme_search_engine_tpu_torch.serving.client import RemoteEmbedder

    bodies = _library_of_shapes(tmp_path / "memes")
    base = {"files": str(tmp_path / "memes"), "device": "cpu", "model_name": "tiny-siglip2-naflex",
            "tiny_model": True, "max_batch_size": 4, "max_num_patches": 48}
    engine = clip_server.build_engine(base)
    want, squashed = {}, {}
    for name, body in bodies.items():
        pic = preprocess.decode_and_resize_naflex(body, 4, 48)
        want[encode_filename(Actual(name))] = engine.embed_image_list([pic])[0]
        sq = preprocess.decode_and_resize(body, (24, 24))  # 36 patches, the shape lost
        squashed[encode_filename(Actual(name))] = engine.embed_image_list([sq])[0]

    async def ingest(tag):
        config = dict(base, db_path=str(tmp_path / f"{tag}.db"))
        if tag == "remote":
            server = TestServer(clip_server.make_app(engine, {"max_batch_size": 4}))
            await server.start_server()
            embedder = RemoteEmbedder(str(server.make_url("")))
            await embedder.connect()
            assert embedder.config.image_size is None and embedder.config.max_num_patches == 48
            svc = IngestService(config, IngestDB(config["db_path"]), embedder)
        else:
            server = None
            svc = await IngestService.create(config)
            assert svc.embedder.config.max_num_patches == 48
        try:
            stats = await svc.ingest()
        finally:
            await svc.embedder.close()
            if server is not None:
                await server.close()
        assert stats.embedded == len(bodies) and stats.errors == 0
        return {fn: e for fn, e, _t, _m in svc.db.iter_indexable()}

    for tag in ("in_process", "remote"):
        got = asyncio.run(ingest(tag))
        assert set(got) == set(want)
        for fn, e in got.items():
            np.testing.assert_allclose(e, want[fn], atol=2e-3, err_msg=f"{tag} {fn!r}")
            if fn != encode_filename(Actual("square.png")):
                assert float(np.linalg.norm(e - squashed[fn])) > 0.05
