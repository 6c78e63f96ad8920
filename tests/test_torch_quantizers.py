"""Port parity: the quantizer path of meme_search_engine_tpu_torch (OPQ
train/encode/ADC, RaBitQ, scalar u8, the quantizer tool) against the JAX
package on the same numpy inputs.

On the CPU the ADC wrappers take their plain version. Tolerances: 1e-4
for ADC (tests/test_quantizers.py:175), 1e-5 for the fp32 transforms and
descriptor scores; codes, signs and integer dots must be equal. Trained
artifacts are held by quality, not bits: jax.random and torch.Generator
draw different numbers from one seed.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meme_search_engine_tpu.index import opq as jopq
from meme_search_engine_tpu.index import rabitq as jrabitq
from meme_search_engine_tpu.index import scalar as jscalar
from meme_search_engine_tpu.ops import adc as jadc
from meme_search_engine_tpu_torch.index import opq as topq
from meme_search_engine_tpu_torch.index import rabitq as trabitq
from meme_search_engine_tpu_torch.index import scalar as tscalar
from meme_search_engine_tpu_torch.ops import adc as tadc

ADC_TOL = 1e-4
CPU = "cpu"


def _pq_arrays(rng, d, c, dpc):
    centroids = rng.standard_normal((c, d)).astype(np.float32)
    transform = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    return centroids, transform, dpc, d


def _both_pq(arrays):
    return jopq.ProductQuantizer(*arrays), topq.ProductQuantizer(*arrays)


# -- ADC ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,m,b,c",
    [(300, 16, 3, 256), (1500, 64, 2, 256), (200, 8, 3, 16), (700, 96, 4, 256)],
    ids=["test_shape", "ragged", "codes_past_c", "m96"],
)
def test_adc_plain_matches_jax(n, m, b, c):
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 256, (n, m), dtype=np.uint8)
    luts = rng.standard_normal((b, m, c)).astype(np.float32)
    tadc.reset_launches()
    got = tadc.adc_scores_plain(torch.from_numpy(codes), torch.from_numpy(luts)).numpy()
    batched = np.asarray(jadc.adc_scores_batched(jnp.asarray(codes), jnp.asarray(luts)))
    pallas = np.asarray(
        jadc.adc_scores_pallas(jnp.asarray(codes), jnp.asarray(luts), interpret=True)
    )
    np.testing.assert_allclose(got, batched, rtol=ADC_TOL, atol=ADC_TOL)
    np.testing.assert_allclose(got, pallas, rtol=ADC_TOL, atol=ADC_TOL)
    # the wrappers take the plain version for CPU tensors and launch nothing
    for fn in (tadc.adc_scores_batched, tadc.adc_scores_pallas):
        out = fn(torch.from_numpy(codes), torch.from_numpy(luts))
        np.testing.assert_array_equal(out.numpy(), got)
    assert tadc.launches["adc_scores"] == 0
    # codes >= C occur, and both JAX routes score them 0
    assert (codes >= c).any() == (c < 256)


def test_adc_scores_and_asymmetric_dot_match_jax():
    rng = np.random.default_rng(1)
    jpq, tpq = _both_pq(_pq_arrays(rng, 64, 16, 8))
    x = rng.standard_normal((500, 64)).astype(np.float32)
    codes = np.array(jpq.quantize(x))
    lut = jpq.preprocess_query(rng.standard_normal(64).astype(np.float32))
    want = np.asarray(jadc.adc_scores(jnp.asarray(codes), jnp.asarray(lut)))
    got = tadc.adc_scores(torch.from_numpy(codes), torch.from_numpy(lut))
    assert got.shape == (500,)
    np.testing.assert_allclose(got.numpy(), want, rtol=ADC_TOL, atol=ADC_TOL)
    want = jpq.asymmetric_dot(lut, codes)
    got = tpq.asymmetric_dot(lut, codes, device=CPU)
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, want, rtol=ADC_TOL, atol=ADC_TOL)
    # codes already on the device: the scores stay there as a tensor
    got_t = tpq.asymmetric_dot(lut, torch.from_numpy(codes))
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(got_t.numpy(), got)


def test_descriptor_scores_match_jax():
    rng = np.random.default_rng(5)
    desc = rng.integers(0, 256, (40, 4), dtype=np.uint8)
    scales = np.array([1.0 / 512, 0, -0.5 / 512, 0], np.float32)
    want = np.asarray(jadc.descriptor_scores(jnp.asarray(desc), jnp.asarray(scales)))
    got = tadc.descriptor_scores(torch.from_numpy(desc), torch.from_numpy(scales))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


# -- OPQ runtime ----------------------------------------------------------------


@pytest.mark.parametrize(
    "d,c,dpc,n", [(64, 16, 8, 300), (1152, 256, 18, 256)], ids=["small", "so400m"]
)
def test_quantize_matches_jax(d, c, dpc, n):
    rng = np.random.default_rng(0)
    jpq, tpq = _both_pq(_pq_arrays(rng, d, c, dpc))
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    want = jpq.quantize(x)
    got = tpq.quantize(x, device=CPU)
    assert got.dtype == np.uint8 and got.shape == (n, d // dpc)
    np.testing.assert_array_equal(got, want)
    # fp16 input is uploaded as fp16 and widened on the device: the codes of
    # its exact fp32 widening
    x16 = x.astype(np.float16)
    got16 = tpq.quantize_async(x16, device=CPU)
    assert got16.dtype == torch.uint8
    np.testing.assert_array_equal(got16.numpy(), tpq.quantize(x16.astype(np.float32), device=CPU))
    np.testing.assert_array_equal(got16.numpy(), jpq.quantize(x16))


def test_quantize_in_row_chunks_matches_whole(monkeypatch):
    rng = np.random.default_rng(2)
    _, tpq = _both_pq(_pq_arrays(rng, 64, 16, 8))
    x = rng.standard_normal((301, 64)).astype(np.float32)
    whole = tpq.quantize(x, device=CPU)
    monkeypatch.setattr(topq, "ENCODE_ROWS", 64)
    np.testing.assert_array_equal(tpq.quantize(x, device=CPU), whole)


def test_preprocess_query_apply_transform_and_make_lut_match_jax():
    rng = np.random.default_rng(3)
    arrays = _pq_arrays(rng, 1152, 256, 18)
    jpq, tpq = _both_pq(arrays)
    q = rng.standard_normal(1152).astype(np.float32)
    x = rng.standard_normal((32, 1152)).astype(np.float32)
    np.testing.assert_allclose(tpq.preprocess_query(q), jpq.preprocess_query(q), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tpq.apply_transform(x, device=CPU), jpq.apply_transform(x), rtol=1e-5, atol=1e-5
    )
    centroids, transform, dpc, _ = arrays
    want = np.asarray(jopq._make_lut(jnp.asarray(q), jnp.asarray(transform), jnp.asarray(centroids), dpc))
    got = topq._make_lut(torch.from_numpy(q), torch.from_numpy(transform), torch.from_numpy(centroids), dpc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pq_assign_reconstruct_matches_jax():
    rng = np.random.default_rng(6)
    cen = rng.standard_normal((32, 96)).astype(np.float32)
    batch = rng.standard_normal((200, 96)).astype(np.float32)
    want = np.asarray(jopq._pq_assign_reconstruct(jnp.asarray(cen), jnp.asarray(batch), 12))
    t_cen = torch.from_numpy(cen).requires_grad_(True)
    got = topq._pq_assign_reconstruct(t_cen, torch.from_numpy(batch), 12)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    # the gradient reaches the centroids through the gathered slices only
    got.sum().backward()
    assert t_cen.grad is not None and (t_cen.grad != 0).any()


# -- msgpack artifacts ----------------------------------------------------------


def _artifacts(rng):
    pq = _pq_arrays(rng, 64, 16, 8)
    x = rng.standard_normal((512, 32)).astype(np.float32)
    sq = jscalar.train_scalar_quantizer(x)
    rq = jrabitq.train_rabitq(x, output_dims=16, seed=1)
    return [
        (jopq.ProductQuantizer(*pq), topq.ProductQuantizer),
        (rq, trabitq.RaBitQ),
        (sq, tscalar.ScalarQuantizer),
    ]


@pytest.mark.parametrize("which", [0, 1, 2], ids=["opq", "rabitq", "scalar"])
def test_msgpack_artifacts_match_jax_both_ways(which):
    jobj, tcls = _artifacts(np.random.default_rng(7))[which]
    jcls = type(jobj)
    tobj = tcls(**{f.name: getattr(jobj, f.name) for f in dataclasses.fields(jobj)})
    jbytes, tbytes = jobj.to_msgpack(), tobj.to_msgpack()
    assert tbytes == jbytes
    from_j, from_t = tcls.from_msgpack(jbytes), jcls.from_msgpack(tbytes)
    for a, b in ((from_j, jobj), (from_t, tobj)):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
            assert np.asarray(va).dtype == np.asarray(vb).dtype


# -- OPQ training ----------------------------------------------------------------


def _clustered(rng):
    """The data of test_quantizers.py::test_train_opq_reduces_query_error."""
    centers = rng.standard_normal((8, 32)).astype(np.float32) * 2
    x = centers[rng.integers(0, 8, 512)] + rng.standard_normal((512, 32)).astype(np.float32) * 0.3
    queries = rng.standard_normal((64, 32)).astype(np.float32)
    return x, queries


def _query_err(p, x, queries):
    xt = x @ p.transform.T
    codes = p.quantize(x) if isinstance(p, jopq.ProductQuantizer) else p.quantize(x, device=CPU)
    recon = np.zeros_like(xt)
    for k in range(p.n_chunks):
        lo, hi = k * p.n_dims_per_code, (k + 1) * p.n_dims_per_code
        recon[:, lo:hi] = p.centroids[codes[:, k], lo:hi]
    qt = queries @ p.transform.T
    return float(np.mean((qt @ (xt - recon).T) ** 2))


# the port's mean query error over seeds 0-2 stays within this factor of
# the JAX package's: both optimise the same objective from different draws.
# One seed's error ranges from 0.3x to 1x the baseline's in either package
# (10.4 to 35.8 against 35.1 here), so the means of 3 seeds differ by up to
# 25% (0.95x on seeds 0-2, 1.24x on seeds 3-5); 1.5 leaves room for that
TRAIN_FACTOR = 1.5


def test_train_opq_quality_matches_jax():
    rng = np.random.default_rng(4)
    x, queries = _clustered(rng)
    kw = dict(n_chunks=8, n_centroids=16, outer_iters=2, adam_iters=40, batch_size=512,
              query_batch_size=64)
    base = jopq.ProductQuantizer(
        centroids=x[rng.permutation(512)[:16]].astype(np.float32),
        transform=np.eye(32, dtype=np.float32), n_dims_per_code=4, n_dims=32,
    )
    base_err = _query_err(base, x, queries)
    t_errs, j_errs = [], []
    for seed in range(3):
        pq = topq.train_opq(x, queries, seed=seed, device=CPU, **kw)
        assert isinstance(pq.centroids, np.ndarray) and pq.centroids.shape == (16, 32)
        np.testing.assert_allclose(pq.transform @ pq.transform.T, np.eye(32), atol=1e-3)
        t_errs.append(_query_err(pq, x, queries))
        assert t_errs[-1] < base_err, (t_errs, base_err)
        j_errs.append(_query_err(jopq.train_opq(x, queries, seed=seed, **kw), x, queries))
    assert np.mean(t_errs) <= TRAIN_FACTOR * np.mean(j_errs), (t_errs, j_errs)


def test_train_opq_calls_pause_point_and_drops_ragged_rows():
    rng = np.random.default_rng(8)
    x, queries = _clustered(rng)
    calls = []
    pq = topq.train_opq(x[:300], queries, n_chunks=8, n_centroids=16, outer_iters=2,
                        adam_iters=20, batch_size=128, query_batch_size=32, seed=0,
                        pause_point=lambda: calls.append(1), device=CPU)
    assert len(calls) == 2 * 2  # at iterations 0 and 16 of each outer loop
    np.testing.assert_allclose(pq.transform @ pq.transform.T, np.eye(32), atol=1e-3)


# -- RaBitQ ------------------------------------------------------------------


def test_rabitq_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 64)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    jrq = jrabitq.train_rabitq(x, output_dims=48, seed=1)
    trq = trabitq.RaBitQ(jrq.mean, jrq.transform, jrq.output_dims, jrq.n_dims)
    js, jd, jn = jrq.quantize(x)
    ts, td, tn = trq.quantize(x, device=CPU)
    assert ts.dtype == bool and ts.shape == (256, 48)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tn, jn, rtol=1e-5)
    q = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        trq.approx_dot(ts, td, tn, q, device=CPU), jrq.approx_dot(js, jd, jn, q),
        rtol=1e-5, atol=1e-6,
    )
    # tensors in, tensors out, where they lie
    out = trq.quantize(torch.from_numpy(x))
    assert all(isinstance(t, torch.Tensor) for t in out)
    np.testing.assert_array_equal(out[0].numpy(), js)
    packed = trabitq.RaBitQ.pack_bits(ts)
    np.testing.assert_array_equal(packed, jrabitq.RaBitQ.pack_bits(js))
    np.testing.assert_array_equal(trabitq.RaBitQ.unpack_bits(packed, 48), ts)


@pytest.mark.parametrize("sample", ["numpy", "tensor"])
def test_train_rabitq_rows_are_orthonormal(sample):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((300, 96)).astype(np.float32)
    rq = trabitq.train_rabitq(x if sample == "numpy" else torch.from_numpy(x), output_dims=64, seed=3)
    assert rq.transform.shape == (64, 96) and rq.transform.dtype == np.float32
    np.testing.assert_allclose(rq.transform @ rq.transform.T, np.eye(64), atol=1e-4)
    np.testing.assert_allclose(rq.mean, x.mean(0), rtol=1e-5, atol=1e-6)
    again = trabitq.train_rabitq(x, output_dims=64, seed=3)
    np.testing.assert_array_equal(again.transform, rq.transform)


# -- scalar ---------------------------------------------------------------------


def test_scalar_quantizer_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((512, 32)).astype(np.float32) * 0.1
    jsq = jscalar.train_scalar_quantizer(x)
    tsq = tscalar.train_scalar_quantizer(x)
    for f in ("permutation", "offsets", "scales", "q_offsets", "q_scales"):
        a, b = getattr(tsq, f), getattr(jsq, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    codes = tsq.quantize(x)
    np.testing.assert_array_equal(codes, jsq.quantize(x))
    np.testing.assert_array_equal(tsq.quantize(torch.from_numpy(x)).numpy(), codes)
    np.testing.assert_array_equal(tsq.dequantize(codes), jsq.dequantize(codes))
    y = np.repeat(codes[:1], 512, 0)
    got = tsq.integer_dot(y, codes, device=CPU)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jsq.integer_dot(y, codes))


@pytest.mark.parametrize(
    "n,kind",
    [(1001, "normal"), (1000, "normal"), (2, "normal"), (777, "ties"), (999, "fp16"),
     (1_000_000, "normal")],
)
def test_column_quantile_is_np_quantile_bit_for_bit(n, kind):
    """The order statistics found with torch.kthvalue, interpolated in
    numpy's dtypes and formula, give np.quantile's bits: odd and even N,
    ties, fp16-rounded data, the quantizer's cut-offs at the 1e6 corpus
    (gammas 0.9995 and 0 there) and gammas on both sides of 0.5; and a
    tensor trains the same quantizer as its numpy copy."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 5 if n < 10**6 else 2)).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 2) / 2
    elif kind == "fp16":
        x = x.astype(np.float16).astype(np.float32)
    for q in (tscalar.CUTOFF, 1 - tscalar.CUTOFF, 0.25, 0.5, 0.7, 1 / 3, 0.0, 1.0):
        want = np.quantile(x, q, axis=0)
        got = tscalar.column_quantile(torch.from_numpy(x), q, chunk=2)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if n == 1001:
        a, b = tscalar.train_scalar_quantizer(torch.from_numpy(x)), jscalar.train_scalar_quantizer(x)
        for f in ("offsets", "scales", "q_offsets", "q_scales"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# -- the quantizer tool -----------------------------------------------------------


def test_quantizer_bench_on_the_cpu(capsys):
    from meme_search_engine_tpu_torch.tools import quantizer_bench

    tadc.reset_launches()
    run = quantizer_bench.main(["--n", "2000", "--d-emb", "512", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == run.results
    assert set(printed) == {"opq_64x256", "rabitq_512", "scalar_u8", "faiss"}
    for name, nbytes in (("opq_64x256", 64), ("rabitq_512", 72), ("scalar_u8", 512)):
        r = printed[name]
        assert set(r) == {"encode_vecs_per_s", "bytes_per_vec", "rank_agreement@20"}
        assert r["bytes_per_vec"] == nbytes and r["encode_vecs_per_s"] > 0
        assert 0 < r["rank_agreement@20"] <= 1
    assert run.codes.shape == (2000, 64) and run.codes.dtype == torch.uint8
    assert tadc.launches["adc_scores"] == 0  # the CPU run launches no kernel


# Rank agreement@20 of the two tools on one corpus. The scalar quantizer
# trains the same numpy on both sides, so its figure agrees to a few of the
# 1,280 top-20 slots. OPQ and RaBitQ train from different random draws
# (jax.random against torch.Generator): over corpus seeds 0-3 of both kinds
# the tools differed by at most 0.025 for either codec, and the JAX tool's
# own figure spread by 0.03 over those seeds; 0.05 leaves room for that.
SCALAR_BAND, TRAINED_BAND = 0.002, 0.05


@pytest.mark.parametrize("kind", ["isotropic", "low_rank"])
def test_quantizer_bench_agrees_with_the_jax_tool(kind, tmp_path, capsys):
    """Both tools on one fp16 corpus and query file: unit vectors drawn
    isotropically (the synthetic corpus of both tools) or near a rank-16
    subspace, so the codecs have structure to find."""
    from meme_search_engine_tpu.tools import quantizer_bench as jbench
    from meme_search_engine_tpu_torch.tools import quantizer_bench as tbench

    rng = np.random.default_rng(0)
    n, d = 2000, 512
    if kind == "isotropic":
        x, q = rng.standard_normal((n, d)), rng.standard_normal((64, d))
    else:
        w = rng.standard_normal((16, d))
        x = rng.standard_normal((n, 16)) @ w + 1.2 * rng.standard_normal((n, d))
        q = rng.standard_normal((64, 16)) @ w + 1.2 * rng.standard_normal((64, d))
    for a, path in ((x, "x.bin"), (q, "q.bin")):
        (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float16).tofile(tmp_path / path)
    argv = ["--vectors", str(tmp_path / "x.bin"), "--queries", str(tmp_path / "q.bin"),
            "--d-emb", str(d), "--n", str(n)]
    jbench.main(argv)
    want = json.loads(capsys.readouterr().out)
    tbench.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want)
    for name, band in (("opq_64x256", TRAINED_BAND), ("rabitq_512", TRAINED_BAND),
                       ("scalar_u8", SCALAR_BAND)):
        assert got[name]["bytes_per_vec"] == want[name]["bytes_per_vec"]
        g, w_ = got[name]["rank_agreement@20"], want[name]["rank_agreement@20"]
        assert abs(g - w_) <= band, (name, g, w_)
