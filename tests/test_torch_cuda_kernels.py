"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips on a host without a GPU. These shapes
are chosen to hit the kernels' edges (rows and columns that do not fill a
tile, ragged key tiles, narrow heads, strided views); chip_smoke.py
checks the SO400M shapes. Tolerances: 0.05 for the GEMMs
(tests/test_fused.py), atol 2e-2 for attention (tests/test_attention.py:98)
and rtol = atol = 2e-2 for the fused attention + o-projection, rtol = atol = 1e-4 for ADC (tests/test_quantizers.py:175); the row gather
is exact, so it is compared bit for bit; the gathered dots at 1e-5 with
bf16 rows of unit vectors, as the build holds them, and exactly with int8
rows (integer sums below 2^24). This file
imports neither JAX nor the JAX package, so on the GPU machine it runs
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from meme_search_engine_tpu_torch.ops import adc, attention, fused, gather

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rn(gen, *shape, std=1.0, mean=0.0):
    return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(torch.bfloat16)


def _assert_close(got, want, tol):
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# Shapes at the GEMM tiles' edges: M not a multiple of the 128-row tile,
# K not a multiple of the 64-deep stage (200, 1160), N of 8, 136 and 1160
# (ragged against every tile width), and the main path's widths (1152 with
# 192-wide tiles without LN and 256-wide with it, 2304, 3840 and 4352 with
# 256-wide ones either way) at B = 2 x SP 736. With LN, N = 136 and 384
# take 192-wide tiles and N = 8 128-wide ones.
GEMM_MAIN_N = [(2, 736, 1152, n) for n in (1152, 2304, 3840, 4352)]


@pytest.mark.parametrize(
    "b,sp,k,n",
    [(1, 40, 64, 136), (3, 736, 1152, 384), (2, 24, 200, 8), (1, 300, 1160, 1160),
     (1, 77, 200, 136), *GEMM_MAIN_N],
)
@pytest.mark.parametrize("act", [None, "gelu"])
def test_ln_matmul_kernel(gen, b, sp, k, n, act):
    x, g, be = _rn(gen, b, sp, k), _rn(gen, k, std=0.1, mean=1.0), _rn(gen, k, std=0.1)
    w, bias = _rn(gen, k, n, std=k**-0.5), _rn(gen, n, std=0.1)
    fused.reset_launches()
    got = fused.ln_matmul(x, g, be, w, bias, act=act)
    assert fused.launches["ln_matmul"] == 1
    _assert_close(got, fused.ln_matmul_plain(x, g, be, w, bias, act=act), 0.05)


# "inside_a_tile": N = 1008 takes 256-wide tiles (16 columns wasted), and
# the key section [336, 672) starts and ends inside one
@pytest.mark.parametrize(
    "b,sp,n_valid,h,c,d,k",
    [(2, 48, 37, 4, 24, 16, 64), (2, 736, 729, 16, 80, 72, 1152), (2, 100, 90, 4, 84, 72, 1152)],
    ids=["small", "so400m", "inside_a_tile"],
)
def test_ln_matmul_kernel_key_mask(gen, b, sp, n_valid, h, c, d, k):
    x, g, be = _rn(gen, b, sp, k), _rn(gen, k, mean=1.0, std=0.1), _rn(gen, k)
    w, bias = _rn(gen, k, 3 * h * c, std=k**-0.5), _rn(gen, 3 * h * c)
    km = (n_valid, h, c, d)
    got = fused.ln_matmul(x, g, be, w, bias, k_mask=km)
    torch.cuda.synchronize()
    want = fused.ln_matmul_plain(x, g, be, w, bias, k_mask=km)
    assert torch.equal(got[:, n_valid:, h * c : 2 * h * c], want[:, n_valid:, h * c : 2 * h * c])
    _assert_close(got, want, 0.05)


# The key mask with each sequence's own valid length (the NaFlex tower's):
# 1024-row sequences whose lengths fall on and off the 128-row tiles and
# the 8-row fragment groups (one row, eight, a whole sequence), and the
# SO400M shape with every length 729, which must equal the one-scalar mask
# bit for bit.
@pytest.mark.parametrize(
    "sp,lens",
    [(1024, [1024, 960, 1, 1017]), (1024, [968, 1023, 8]), (736, [729, 729])],
    ids=["naflex", "naflex_edges", "so400m_as_scalar"],
)
def test_ln_matmul_kernel_sequence_key_mask(gen, sp, lens):
    h, c, d, k = 16, 80, 72, 1152
    b = len(lens)
    x, g, be = _rn(gen, b, sp, k), _rn(gen, k, mean=1.0, std=0.1), _rn(gen, k)
    w, bias = _rn(gen, k, 3 * h * c, std=k**-0.5), _rn(gen, 3 * h * c)
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = fused.ln_matmul(x, g, be, w, bias, k_mask=(n, h, c, d))
    torch.cuda.synchronize()
    want = fused.ln_matmul_plain(x, g, be, w, bias, k_mask=(n, h, c, d))
    for j, v in enumerate(lens):
        assert torch.equal(got[j, v:, h * c: 2 * h * c], want[j, v:, h * c: 2 * h * c])
    _assert_close(got, want, 0.05)
    if len(set(lens)) == 1:
        assert torch.equal(got, fused.ln_matmul(x, g, be, w, bias, k_mask=(lens[0], h, c, d)))


def test_naflex_tower_at_depth_two_against_the_reference(gen):
    """The SigLIP 2 NaFlex image tower at its published widths, two layers
    deep, on the card (kernels 1, 7, 2, 3 with a key mask a picture)
    against the plain fp32 reference of tests/siglip2_reference.py."""
    import dataclasses

    import numpy as np

    import siglip2_reference as ref
    from meme_search_engine_tpu_torch.models import siglip

    cfg = dataclasses.replace(siglip.SO400M_16_NAFLEX_1024, depth=2, text_depth=1, vocab_size=512)
    params = siglip.init_params(cfg, gen, "cuda")
    grids = [(32, 32), (18, 55), (55, 18), (31, 33), (10, 100), (1, 7)]
    rng = np.random.default_rng(0)
    pics = [rng.integers(0, 256, (16 * h, 16 * w, 3), dtype=np.uint8) for h, w in grids]
    buf = np.zeros((len(pics), cfg.max_num_patches * 768), np.uint8)
    for j, pic in enumerate(pics):
        buf[j, : pic.size] = pic.reshape(-1)
    got = siglip.encode_image(siglip.prepare_params(params, cfg), torch.from_numpy(buf).cuda(), cfg,
                              grids=np.array(grids))
    want = ref.encode_pictures(ref.to_fp32(params["img"]), pics, 16, cfg.max_num_patches,
                               cfg.num_heads)
    torch.cuda.synchronize()
    assert float((got - want).norm(dim=-1).max()) < 0.03


# The LN kernel's normalised stages at 256-wide tiles (N = 512, 768, 2304,
# 3840): K of one 64-deep stage, and K = 200 and 1160, whose last stage the
# normaliser must leave zero past K; ragged M (40, 231, 300, 129 rows);
# then the model-parallel shards' widths, QKV 1920 and fc1 2176, which
# take 256-wide tiles too (the fewest tiles; the last one part empty).
@pytest.mark.parametrize(
    "b,sp,k,n",
    [(1, 40, 64, 512), (3, 77, 200, 768), (1, 300, 1160, 2304), (1, 129, 1152, 3840),
     (2, 736, 1152, 1920), (1, 300, 1152, 2176)],
)
@pytest.mark.parametrize("act", [None, "gelu"])
def test_ln_matmul_kernel_normalised_stages(gen, b, sp, k, n, act):
    x, g, be = _rn(gen, b, sp, k, mean=0.5), _rn(gen, k, std=0.1, mean=1.0), _rn(gen, k, std=0.1)
    w, bias = _rn(gen, k, n, std=k**-0.5), _rn(gen, n, std=0.1)
    _assert_close(fused.ln_matmul(x, g, be, w, bias, act=act),
                  fused.ln_matmul_plain(x, g, be, w, bias, act=act), 0.05)


def _bf16_step(v):
    """The distance between neighbouring bf16 values at |v| (8 significant bits)."""
    _, e = torch.frexp(v)
    return torch.ldexp(torch.ones_like(v), e - 8)


# The rounding points at the main widths (QKV with its key mask, the MAP
# head's k|v, fc1 with gelu): against an exact emulation, the fp32
# LayerNorm rounded once to bf16 (the plain version's), its product with w
# and the bias in float64, the gelu in float64. The kernel's output is that
# rounded once to bf16 but for its fp32 sums (about 1e-5 here) and rare
# LN values that its own fp32 statistics round to the neighbouring bf16
# (about 1e-4 an output of their row, 1e-3 at most): so every output lies
# within two bf16 steps + 2^-8 of the emulation, and at least 95% of them
# round to the same bf16. An LN rounded elsewhere (gamma folded into w,
# the normalised x rounded before gamma and beta, or not rounded) moves
# outputs by up to 1e-2 and rounds about half of them elsewhere (the
# plain versions' arithmetic on the CPU: 0.44-0.58 the same; 0.997 with
# every row's 1/sigma 2 ulps off).
@pytest.mark.parametrize("n,act,k_mask", [(3840, None, (729, 16, 80, 72)), (2304, None, None),
                                          (4352, "gelu", None)], ids=["qkv", "map_kv", "fc1"])
def test_ln_matmul_kernel_rounds_where_the_reference_does(gen, n, act, k_mask):
    b, sp, k = 2, 736, 1152
    x, g, be = _rn(gen, b, sp, k), _rn(gen, k, std=0.1, mean=1.0), _rn(gen, k, std=0.1)
    w, bias = _rn(gen, k, n, std=k**-0.5), _rn(gen, n, std=0.1)
    got = fused.ln_matmul(x, g, be, w, bias, act=act, k_mask=k_mask).double()
    want = fused._ln_plain(x, g, be).double() @ w.double() + bias.double()
    if act == "gelu":
        want = torch.nn.functional.gelu(want, approximate="tanh")
    if k_mask is not None:
        want = fused._k_mask_plain(want, k_mask)
    err = (got - want).abs()
    worst = float((err - 2 * _bf16_step(want)).max())
    same = float((got == want.to(torch.bfloat16).double()).double().mean())
    assert worst <= 2**-8, f"an output {worst:.3g} past two bf16 steps of the emulation"
    assert same >= 0.95, f"only {same:.4f} of the outputs round as the emulation's"


@pytest.mark.parametrize(
    "b,sp,k,n",
    [(1, 40, 64, 136), (2, 736, 1152, 1152), (2, 736, 4352, 1152), (1, 300, 200, 8),
     (1, 100, 1160, 1160), *GEMM_MAIN_N[1:]],
)
def test_matmul_residual_kernel(gen, b, sp, k, n):
    x, w, bias, res = _rn(gen, b, sp, k), _rn(gen, k, n, std=k**-0.5), _rn(gen, n), _rn(gen, b, sp, n)
    _assert_close(fused.matmul_residual(x, w, bias, res), fused.matmul_residual_plain(x, w, bias, res), 0.05)


@pytest.mark.parametrize("b,sp,d,m", [(2, 50, 128, 200), (1, 300, 200, 136), (2, 736, 1152, 4304)])
def test_ln_mlp_residual_kernel(gen, b, sp, d, m):
    x, g, be = _rn(gen, b, sp, d), _rn(gen, d, mean=1.0, std=0.1), _rn(gen, d)
    w1, b1 = _rn(gen, d, m, std=d**-0.5), _rn(gen, m)
    w2, b2 = _rn(gen, m, d, std=m**-0.5), _rn(gen, d)
    pw1, pb1, pw2 = (t.contiguous() for t in fused.pad_hidden(w1, b1, w2))
    with pytest.raises(ValueError, match="pad_hidden"):
        fused.ln_mlp_residual(x, g, be, w1, b1, w2, b2)
    got = fused.ln_mlp_residual(x, g, be, pw1, pb1, pw2, b2)
    _assert_close(got, fused.ln_mlp_residual_plain(x, g, be, w1, b1, w2, b2), 0.05)


# (B, SP, n_valid, H, d, key ramp): the tiny fat and tiny widths (fat
# widths 8 and 24, copied to a zero-padded 16 and 32 by the wrapper), a
# ragged SP, SO400M; then an SP whose last 128-key tile holds one row, few
# valid keys (whole key tiles of pad rows), keys scaled up along the
# sequence (scores far apart: the row max grows from tile to tile and O is
# rescaled), a grid of 4 tiles (fewer than the card's SMs), and the tiny
# fat width over several key tiles
FAT_GEOMETRIES = [
    pytest.param(2, 16, 11, 16, 7, False, id="tiny_fat"),
    pytest.param(2, 16, 4, 4, 16, False, id="tiny"),
    pytest.param(2, 100, 90, 4, 72, False, id="ragged"),
    pytest.param(2, 736, 729, 16, 72, False, id="so400m"),
    pytest.param(2, 257, 250, 4, 72, False, id="last_key_tile_one_row"),
    pytest.param(2, 736, 40, 4, 72, False, id="mostly_pad_keys"),
    pytest.param(2, 736, 729, 4, 72, True, id="scores_far_apart"),
    pytest.param(1, 200, 190, 2, 72, False, id="grid_under_the_sms"),
    pytest.param(1, 300, 280, 16, 7, False, id="tiny_fat_key_tiles"),
]


@pytest.mark.parametrize("b,sp,n_valid,h,d,ramp", FAT_GEOMETRIES)
def test_fat_attention_kernel(gen, b, sp, n_valid, h, d, ramp):
    c = attention.fat_width(d)
    f = torch.randn((b, sp, 3, h, c), generator=gen, device="cuda")
    f[..., d:] = 0
    f[:, :, 0, :, :d] *= d**-0.5
    if ramp:  # key j scaled by 0.5 .. 6: scores grow along the keys
        f[:, :, 1, :, :d] *= torch.linspace(0.5, 6.0, sp, device="cuda")[None, :, None, None]
    f[:, :, 0, :, d] = 1
    f[:, n_valid:, 1] = 0
    f[:, n_valid:, 1, :, d] = -1e30
    f[:, :, 2, :, d] = 1
    qkvf = f.reshape(b, sp, 3 * h * c).to(torch.bfloat16)
    attention.reset_launches()
    got = attention.fat_vit_mha_packed(qkvf, h, d)
    want = attention.fat_vit_mha_packed_plain(qkvf, h, d)
    _assert_close(got[:, :n_valid], want[:, :n_valid], 2e-2)
    q, k, v = (qkvf[..., i * h * c : (i + 1) * h * c].contiguous() for i in range(3))
    _assert_close(attention.fat_vit_mha(q, k, v, h, d)[:, :n_valid], want[:, :n_valid], 2e-2)
    assert attention.launches["fat_vit_mha"] == 2


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x, w, b = _rn(gen, 1, 8, 64), _rn(gen, 64, 64), _rn(gen, 64)
    with pytest.raises(TypeError):
        fused.matmul_residual(x.float(), w, b, x)
    with pytest.raises(ValueError):
        fused.matmul_residual(x.transpose(1, 2).contiguous().transpose(1, 2), w, b, x)
    with pytest.raises(ValueError):
        fused.ln_matmul(_rn(gen, 1, 8, 60), b[:60].contiguous(), b[:60].contiguous(), w[:60].contiguous(), b)
    with pytest.raises(ValueError):
        fused.matmul_residual(x, w, b, x.cpu())
    with pytest.raises(ValueError, match="compiled for"):  # head_dim 40: fat width 48
        attention.fat_vit_mha_packed(_rn(gen, 1, 8, 3 * 4 * 48), 4, 40)


def _fat_qkvf(gen, b, sp, n_valid, h, d):
    """A packed fat-layout (B, SP, 3*H*C) bf16 qkvf: q pre-scaled with its
    constant 1, k's constant -1e30 on the pad rows, v's constant 1."""
    c = attention.fat_width(d)
    f = torch.randn((b, sp, 3, h, c), generator=gen, device="cuda")
    f[..., d:] = 0
    f[:, :, 0, :, :d] *= d**-0.5
    f[:, :, 0, :, d] = 1
    f[:, n_valid:, 1] = 0
    f[:, n_valid:, 1, :, d] = -1e30
    f[:, :, 2, :, d] = 1
    return f.reshape(b, sp, 3 * h * c).to(torch.bfloat16)


# The tiny fat and tiny geometries (clusters of 8 and 2 CTAs, the fat
# widths padded by the wrapper, Wo's rows padded to 8 a head at head_dim
# 7, the last CTA's output columns past DM at the tiny fat one), a ragged
# SP, SO400M (clusters of 8, 144 columns a CTA), then SP = 136 and 200 with
# 129 valid rows: two 128-row query blocks, the second with one valid row
# and rows past SP, at all three geometries; then more (image, query
# block) tiles than the card holds clusters, so each cluster walks several
# (15 clusters of 8 fit an H100)
@pytest.mark.parametrize(
    "b,sp,n_valid,h,d",
    [(2, 16, 4, 16, 7), (2, 16, 4, 4, 16), (2, 100, 90, 4, 16), (2, 736, 729, 16, 72),
     (1, 136, 129, 4, 16), (1, 136, 129, 16, 7), (1, 200, 129, 16, 72),
     (20, 200, 129, 16, 72), (20, 16, 4, 16, 7), (80, 200, 129, 4, 16)],
    ids=["tiny_fat", "tiny", "ragged", "so400m", "two_blocks_ragged", "tiny_fat_two_blocks",
         "so400m_heads_two_blocks", "so400m_heads_many_tiles", "tiny_fat_many_tiles",
         "tiny_many_tiles"],
)
def test_fat_attention_proj_kernel(gen, b, sp, n_valid, h, d):
    """Kernel 8 against its plain version and against kernels 7 then 2,
    on the valid rows (pad rows hold finite values no caller reads), at
    the fat attention's 2e-2 (rtol = atol)."""
    qkvf = _fat_qkvf(gen, b, sp, n_valid, h, d)
    dm = h * d
    wo, bo, res = _rn(gen, h * d, dm, std=(h * d) ** -0.5), _rn(gen, dm, std=0.02), _rn(gen, b, sp, dm)
    attention.reset_launches()
    got = attention.fat_vit_mha_packed_proj(qkvf, wo, bo, res, h, d)
    torch.cuda.synchronize()
    assert attention.launches["fat_vit_mha_packed_proj"] == 1
    assert got.shape == (b, sp, dm) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    want = attention.fat_vit_mha_packed_proj_plain(qkvf, wo, bo, res, h, d)
    _assert_close(got[:, :n_valid], want[:, :n_valid], 2e-2)
    composed = fused.matmul_residual(attention.fat_vit_mha_packed(qkvf, h, d), wo, bo, res)
    _assert_close(got[:, :n_valid], composed[:, :n_valid], 2e-2)
    assert attention.launches["fat_vit_mha_packed_proj"] == 1


def test_fat_attention_proj_wrapper_refuses_what_the_kernel_does_not_take(gen):
    h, d, sp = 4, 16, 16
    qkvf = _fat_qkvf(gen, 1, sp, sp, h, d)
    wo, bo, res = _rn(gen, h * d, 64), _rn(gen, 64), _rn(gen, 1, sp, 64)
    attention.reset_launches()
    with pytest.raises(TypeError):
        attention.fat_vit_mha_packed_proj(qkvf.float(), wo, bo, res, h, d)
    with pytest.raises(TypeError):
        attention.fat_vit_mha_packed_proj(qkvf, wo, bo, res.float(), h, d)
    with pytest.raises(ValueError, match="shape"):
        attention.fat_vit_mha_packed_proj(qkvf, wo[:32].contiguous(), bo, res, h, d)
    with pytest.raises(ValueError, match="shape"):
        attention.fat_vit_mha_packed_proj(qkvf, wo, bo, res[:, :8].contiguous(), h, d)
    with pytest.raises(ValueError, match="width"):
        attention.fat_vit_mha_packed_proj(qkvf, wo, bo, res, h, 8)
    with pytest.raises(ValueError, match="compiled for"):  # head_dim 40: fat width 48
        attention.fat_vit_mha_packed_proj(_rn(gen, 1, 8, 3 * 4 * 48), _rn(gen, 160, 64), bo,
                                          _rn(gen, 1, 8, 64), 4, 40)
    with pytest.raises(ValueError, match="multiple of 8"):
        attention.fat_vit_mha_packed_proj(qkvf, _rn(gen, h * d, 60), _rn(gen, 60), _rn(gen, 1, sp, 60), h, d)
    # the cluster: two heads a CTA, at most 8 CTAs, DM / (H / 2) columns a
    # CTA rounded up to 16 as compiled (32 at this fat width)
    c = attention.fat_width(d)
    with pytest.raises(ValueError, match="even head count"):
        attention.fat_vit_mha_packed_proj(_rn(gen, 1, sp, 3 * 3 * c), _rn(gen, 3 * d, 48), _rn(gen, 48),
                                          _rn(gen, 1, sp, 48), 3, d)
    with pytest.raises(ValueError, match="at most 8"):
        attention.fat_vit_mha_packed_proj(_rn(gen, 1, sp, 3 * 18 * c), _rn(gen, 18 * d, 64), bo, res, 18, d)
    with pytest.raises(ValueError, match="compiled for 32"):
        attention.fat_vit_mha_packed_proj(qkvf, _rn(gen, h * d, 128), _rn(gen, 128), _rn(gen, 1, sp, 128), h, d)
    with pytest.raises(ValueError):
        attention.fat_vit_mha_packed_proj(qkvf, wo, bo, res.cpu(), h, d)
    assert attention.launches["fat_vit_mha_packed_proj"] == 0


# S up to 64 takes the persistent one-block kernel (2, 24, 63 and 64: one
# key row, ragged tiles, a full tile), past it the multi-block one (65:
# a second block of one row; 729, the image tower's xla route)
@pytest.mark.parametrize("s", [2, 24, 63, 64, 65, 729])
@pytest.mark.parametrize("d", [72, 16, 7])
@pytest.mark.parametrize("stable", ["row", "scalar", "none"])
def test_fused_mha_kernel(gen, s, d, stable):
    b, h = 2, 4
    q, k, v = (_rn(gen, b, s, h, d) for _ in range(3))
    attention.reset_launches()
    got = attention.fused_mha(q, k, v, stable=stable)
    assert attention.launches["fused_mha"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, h, d)
    assert got.is_contiguous() or d % 8  # a width padded to 8 comes back as a view
    _assert_close(got, attention.fused_mha_plain(q, k, v, stable), 2e-2)


@pytest.mark.parametrize("b,h", [(1, 16), (37, 16), (1000, 3)])
@pytest.mark.parametrize("stable", ["row", "scalar", "none"])
def test_fused_mha_kernel_at_the_text_shape(gen, b, h, stable):
    """The text tower's (B, 64, H, 72): a single text (16 items, fewer than
    the grid), and more (batch, head) items than the persistent grid
    holds, their count no multiple of it, so CTAs take unequal shares."""
    q, k, v = (_rn(gen, b, 64, h, 72) for _ in range(3))
    attention.reset_launches()
    got = attention.fused_mha(q, k, v, stable=stable)
    assert attention.launches["fused_mha"] == 1
    _assert_close(got, attention.fused_mha_plain(q, k, v, stable), 2e-2)


@pytest.mark.parametrize("s", [80, 64, 50])
@pytest.mark.parametrize("stable", ["row", "scalar"])
def test_fused_mha_kernel_strided_views(gen, stable, s):
    """q/k/v as views into one packed (B, S, 3, H, Dh) projection and into
    a head-major (B, H, S, Dh) array: read in place through strides (by
    cp.async past 64 rows, by tensor maps up to 64)."""
    b, h, d = 3, 16, 72
    packed = _rn(gen, b, s, 3, h, d)
    q, k, v = packed.unbind(2)
    assert not q.is_contiguous()
    want = attention.fused_mha_plain(q, k, v, stable)
    _assert_close(attention.fused_mha(q, k, v, stable=stable), want, 2e-2)
    heads = _rn(gen, b, h, s, d).transpose(1, 2)  # (B, S, H, Dh) view
    _assert_close(
        attention.fused_mha(heads, k, v, stable=stable),
        attention.fused_mha_plain(heads, k, v, stable), 2e-2,
    )


def test_fused_mha_kernel_pads_odd_head_widths_and_scores_far_apart(gen):
    """Dh % 8 != 0 is padded to 8 by the wrapper; in scalar mode a head
    whose rows sit far below its max may underflow to l = 0 and give NaN
    rows, as in the reference: the kernel reproduces the plain version
    there, NaN for NaN."""
    q, k, v = (_rn(gen, 2, 40, 2, 12) for _ in range(3))
    _assert_close(attention.fused_mha(q, k, v), attention.fused_mha_plain(q, k, v), 2e-2)
    q = _rn(gen, 1, 64, 1, 16)
    # rows 0-31 share one query whose scores dwarf the other rows' by far
    # more than exp's range: those rows keep l >= 1, rows 32-63 get l = 0
    q[:, :32] = q[:, :1] * 200.0
    k, v = _rn(gen, 1, 64, 1, 16), _rn(gen, 1, 64, 1, 16)
    got = attention.fused_mha(q, k, v)
    want = attention.fused_mha_plain(q, k, v)
    torch.cuda.synchronize()
    assert want[:, 32:].isnan().all() and not want[:, :32].isnan().any()
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    torch.testing.assert_close(got.float()[ok], want.float()[ok], rtol=2e-2, atol=2e-2)


def test_fused_mha_wrapper_refuses_what_the_kernel_does_not_take(gen):
    q = _rn(gen, 1, 16, 2, 72)
    with pytest.raises(TypeError):
        attention.fused_mha(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="shape"):
        attention.fused_mha(q, q[:, :8], q[:, :8])
    for d in (40, 136):  # padded widths 48 and 144 are not compiled
        with pytest.raises(ValueError, match="head width"):
            x = _rn(gen, 1, 16, 1, d)
            attention.fused_mha(x, x, x)
    with pytest.raises(ValueError, match="stride"):
        x = _rn(gen, 1, 16, 2, 144)[..., ::2]  # unit stride on Dh broken
        attention.fused_mha(x, x, x)
    with pytest.raises(ValueError, match="aligned"):
        x = _rn(gen, 16 * 2 * 72 + 8).narrow(0, 4, 16 * 2 * 72).view(1, 16, 2, 72)
        attention.fused_mha(x, x, x)
    with pytest.raises(ValueError):
        attention.fused_mha(q, q, q.cpu())


def test_tiny_engine_serves_both_towers_on_the_card():
    """The tiny test config (fat width 32, text head width 16) runs on the
    card and agrees with the CPU plain path on the same weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from meme_search_engine_tpu_torch.models import siglip
    from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine

    cfg = siglip.tiny_test_config()
    params = siglip.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cpu = EmbeddingEngine(params, cfg, max_batch=4, device="cpu")
    card = EmbeddingEngine(params, cfg, max_batch=4, device="cuda")
    imgs = np.random.default_rng(0).integers(0, 256, (5, 28, 28, 3), dtype=np.uint8)
    texts = ["a cat", "two dogs on a beach", "", "memes", "x y z"]
    attention.reset_launches()
    for a, b in ((card.embed_image_arrays(imgs), cpu.embed_image_arrays(imgs)),
                 (card.embed_texts(texts), cpu.embed_texts(texts))):
        assert np.isfinite(a).all()
        assert ((a * b).sum(-1)).min() > 0.999
    assert attention.launches == {"fat_vit_mha": 2 * cfg.depth, "fused_mha": 2 * cfg.text_depth,
                                  "fat_vit_mha_packed_proj": 0}


def test_xla_image_route_on_the_card():
    """attn_impl="xla": the plain encoder and MAP head, whose
    self-attention (S=729 at SO400M, 4 here) takes the fused kernel and
    whose probe attention (one query) takes the plain route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from meme_search_engine_tpu_torch.models import siglip

    cfg = dataclasses.replace(siglip.tiny_test_config(), attn_impl="xla")
    params = siglip.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    imgs = torch.randint(0, 256, (3, 28, 28, 3), generator=torch.Generator().manual_seed(2),
                         dtype=torch.uint8)
    want = siglip.encode_image(params, imgs, cfg)
    card = siglip.prepare_params(_to_cuda(params), cfg)
    attention.reset_launches()
    got = siglip.encode_image(card, imgs.cuda(), cfg).cpu()
    assert attention.launches == {"fused_mha": cfg.depth, "fat_vit_mha": 0, "fat_vit_mha_packed_proj": 0}
    assert torch.isfinite(got).all() and ((got * want).sum(-1)).min() > 0.999


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    return tree.cuda()


# The text tower's routes: its GEMMs at S = 64 (QKV N = 3456 = 27 x 128,
# no key mask; o; the MLP at the padded 4352, with a residual apart from x
# as a model-parallel shard chains it) from 1 to 128 texts, the fat
# attention at SP = 64 (half a 128-row tile a text, every key valid) over
# 16 heads and a shard's 8, and kernel 1's key mask over a shard's heads
@pytest.mark.parametrize("b", [1, 2, 3, 128])
def test_gemms_at_the_text_shapes(gen, b):
    d, s = 1152, 64
    x, g, be = _rn(gen, b, s, d), _rn(gen, d, mean=1.0, std=0.1), _rn(gen, d, std=0.1)
    wqkv, bqkv = _rn(gen, d, 3 * d, std=d**-0.5), _rn(gen, 3 * d, std=0.1)
    _assert_close(fused.ln_matmul(x, g, be, wqkv, bqkv), fused.ln_matmul_plain(x, g, be, wqkv, bqkv), 0.05)
    wo, bo = _rn(gen, d, d, std=d**-0.5), _rn(gen, d, std=0.1)
    _assert_close(fused.matmul_residual(x, wo, bo, x), fused.matmul_residual_plain(x, wo, bo, x), 0.05)
    w1, b1 = _rn(gen, d, 4304, std=d**-0.5), _rn(gen, 4304)
    w2, b2 = _rn(gen, 4304, d, std=4304**-0.5), _rn(gen, d)
    pw1, pb1, pw2 = (t.contiguous() for t in fused.pad_hidden(w1, b1, w2))
    res = _rn(gen, b, s, d)
    _assert_close(fused.ln_mlp_residual(x, g, be, pw1, pb1, pw2, b2, res=res),
                  fused.ln_mlp_residual_plain(x, g, be, w1, b1, w2, b2, res=res), 0.05)


@pytest.mark.parametrize("b", [1, 3, 128])
@pytest.mark.parametrize("h", [16, 8])
def test_fat_attention_kernel_at_the_text_shape(gen, b, h):
    qkvf = _fat_qkvf(gen, b, 64, 64, h, 72)
    _assert_close(attention.fat_vit_mha_packed(qkvf, h, 72),
                  attention.fat_vit_mha_packed_plain(qkvf, h, 72), 2e-2)


def test_ln_matmul_key_mask_over_a_shards_heads(gen):
    b, sp, n_valid, h, c, d, k = 2, 736, 729, 8, 80, 72, 1152
    x, g, be = _rn(gen, b, sp, k), _rn(gen, k, mean=1.0, std=0.1), _rn(gen, k)
    w, bias = _rn(gen, k, 3 * h * c, std=k**-0.5), _rn(gen, 3 * h * c)
    km = (n_valid, h, c, d)
    _assert_close(fused.ln_matmul(x, g, be, w, bias, k_mask=km),
                  fused.ln_matmul_plain(x, g, be, w, bias, k_mask=km), 0.05)


def test_text_routes_and_model_parallel_on_the_card(monkeypatch):
    """The tiny config on the card: the text tower through MSE_TEXT_FUSED=1
    with every sub-block fused (kernels 1, 5, 2 and 3 once a layer) and
    through attn_impl="fat_interpret" (1, 7, 2, 3), and the engine over
    [["cuda", "cuda"]] with model_parallel (each kernel once a shard a
    layer), each against the CPU plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    import numpy as np

    from meme_search_engine_tpu_torch.models import siglip
    from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine

    cfg = siglip.tiny_test_config()
    params = siglip.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (3, cfg.text_len), generator=torch.Generator().manual_seed(4))
    want = siglip.encode_text(siglip.prepare_params(params, cfg), toks, cfg)
    card = siglip.prepare_params(_to_cuda(params), cfg)
    for k in ("FUSED", "QKV", "O", "MLP"):
        monkeypatch.setenv(f"MSE_TEXT_{k}", "1" if k == "FUSED" else "fused")
    fused.reset_launches()
    attention.reset_launches()
    got = siglip.encode_text(card, toks.cuda(), cfg).cpu()
    assert ((got * want).sum(-1)).min() > 0.999
    n = cfg.text_depth
    assert fused.launches == {"ln_matmul": n, "matmul_residual": n, "ln_mlp_residual": n}
    assert attention.launches["fused_mha"] == n
    monkeypatch.setenv("MSE_TEXT_FUSED", "0")
    fat = dataclasses.replace(siglip.tiny_fat_test_config("fat_interpret"), text_width=112,
                              text_num_heads=16, text_len=16, d_emb=112)
    fparams = siglip.init_params(fat, torch.Generator().manual_seed(5), "cpu")
    ftoks = torch.randint(0, fat.vocab_size, (3, fat.text_len), generator=torch.Generator().manual_seed(6))
    fwant = siglip.encode_text(siglip.prepare_params(fparams, fat), ftoks, fat)
    fused.reset_launches()
    attention.reset_launches()
    fgot = siglip.encode_text(siglip.prepare_params(_to_cuda(fparams), fat), ftoks.cuda(), fat).cpu()
    assert ((fgot * fwant).sum(-1)).min() > 0.999
    assert fused.launches == {"ln_matmul": 2, "matmul_residual": 2, "ln_mlp_residual": 2}
    assert attention.launches == {"fat_vit_mha": 2, "fused_mha": 0, "fat_vit_mha_packed_proj": 0}
    single = EmbeddingEngine(fparams, fat, max_batch=4, device="cpu")
    tp = EmbeddingEngine(fparams, fat, max_batch=4, mesh=[["cuda", "cuda"]], model_parallel=True)
    imgs = np.random.default_rng(7).integers(0, 256, (4, 28, 28, 3), dtype=np.uint8)
    toks4 = np.random.default_rng(8).integers(0, fat.vocab_size, (4, fat.text_len))
    fused.reset_launches()
    attention.reset_launches()
    for a, b in ((tp.embed_image_arrays(imgs), single.embed_image_arrays(imgs)),
                 (tp.embed_tokens(toks4), single.embed_tokens(toks4))):
        assert np.isfinite(a).all() and ((a * b).sum(-1)).min() > 0.999
    # one bucket of 4 a tower: 2 shards x 2 layers, both towers (the text's
    # fat route), the MAP head's k|v once a shard
    assert fused.launches == {"ln_matmul": 4 + 4 + 2, "matmul_residual": 8, "ln_mlp_residual": 8}
    assert attention.launches["fat_vit_mha"] == 8


@pytest.mark.parametrize("c", [16, 256])
@pytest.mark.parametrize("m", [8, 16, 48, 32, 64, 96, 128])
@pytest.mark.parametrize("b", [1, 2, 3, 64])
def test_adc_kernel(gen, b, m, c):
    """Ragged N (not a multiple of the 4096-row tile, of 512 rows, nor of 256
    threads); codes up to 255 also where C = 16, which score 0. M a multiple
    of 32 up to 128 takes the conflict-free route (up to three LUTs a CTA,
    B = 64 leaving a last group of one), 8, 16 and 48 the other; each route
    counts its launch once."""
    n = 10_007
    codes = torch.randint(0, 256, (n, m), generator=gen, device="cuda", dtype=torch.uint8)
    luts = torch.randn((b, m, c), generator=gen, device="cuda")
    adc.reset_launches()
    got = adc.adc_scores_batched(codes, luts)
    torch.cuda.synchronize()
    assert adc.launches["adc_scores"] == 1
    assert got.shape == (b, n) and got.dtype == torch.float32
    torch.testing.assert_close(got, adc.adc_scores_plain(codes, luts), rtol=1e-4, atol=1e-4)
    one = adc.adc_scores(codes, luts[0])
    torch.cuda.synchronize()
    torch.testing.assert_close(one, got[0], rtol=1e-4, atol=1e-4)
    assert adc.launches["adc_scores"] == 2


@pytest.mark.parametrize("n", [1, 31, 300, 513])
@pytest.mark.parametrize("m", [64, 128, 48])
def test_adc_kernel_below_one_tile(gen, n, m):
    """Fewer rows than a warp, a CTA's pass (512) or a tile (4096)."""
    codes = torch.randint(0, 256, (n, m), generator=gen, device="cuda", dtype=torch.uint8)
    luts = torch.randn((3, m, 256), generator=gen, device="cuda")
    adc.reset_launches()
    got = adc.adc_scores_batched(codes, luts)
    torch.cuda.synchronize()
    assert adc.launches["adc_scores"] == 1
    torch.testing.assert_close(got, adc.adc_scores_plain(codes, luts), rtol=1e-4, atol=1e-4)


def test_adc_kernel_byte_loads_on_unaligned_codes(gen):
    """Codes whose base is not 16-byte aligned take the byte-load route."""
    n, m = 5000, 64
    flat = torch.randint(0, 256, (n * m + 1,), generator=gen, device="cuda", dtype=torch.uint8)
    codes = flat.narrow(0, 1, n * m).view(n, m)
    assert codes.data_ptr() % 16 and codes.is_contiguous()
    luts = torch.randn((2, m, 256), generator=gen, device="cuda")
    got = adc.adc_scores_pallas(codes, luts)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, adc.adc_scores_plain(codes, luts), rtol=1e-4, atol=1e-4)


def test_adc_wrapper_refuses_what_the_kernel_does_not_take(gen):
    codes = torch.randint(0, 256, (100, 16), generator=gen, device="cuda", dtype=torch.uint8)
    luts = torch.randn((2, 16, 256), generator=gen, device="cuda")
    with pytest.raises(TypeError, match="codes"):
        adc.adc_scores_batched(codes.int(), luts)
    with pytest.raises(TypeError, match="codes"):
        adc.adc_scores_batched(codes.t().contiguous().t(), luts)
    with pytest.raises(TypeError, match="luts"):
        adc.adc_scores_batched(codes, luts.double())
    with pytest.raises(TypeError, match="luts"):
        adc.adc_scores_batched(codes, luts.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="at most 256"):
        adc.adc_scores_batched(codes, torch.randn((2, 16, 300), device="cuda"))
    with pytest.raises(ValueError, match="chunks"):
        adc.adc_scores_batched(codes, luts[:, :8].contiguous())
    with pytest.raises(ValueError, match="shared memory"):
        wide = torch.zeros((4, 240), device="cuda", dtype=torch.uint8)
        adc.adc_scores_batched(wide, torch.zeros((1, 240, 256), device="cuda"))
    with pytest.raises(ValueError):
        adc.adc_scores_batched(codes, luts.cpu())
    # 2^16 queries x 2^15 row tiles: one CTA past the grid's 2^31 - 1
    many = torch.zeros((32767 * adc.TILE_ROWS + 1, 1), device="cuda", dtype=torch.uint8)
    with pytest.raises(ValueError, match="CTAs"):
        adc.adc_scores_batched(many, torch.zeros((2**16, 1, 256), device="cuda"))
    torch.cuda.synchronize()


def test_quantize_on_the_card_matches_the_cpu_within_near_ties(gen):
    """The card's codes equal the CPU's, except where the CPU's two best
    sims lie within 1e-4 of each other; the card's asymmetric_dot agrees
    with the CPU's at 1e-4."""
    import numpy as np

    from meme_search_engine_tpu_torch.index.opq import ProductQuantizer

    rng = np.random.default_rng(0)
    d, c, dpc, n = 1152, 256, 18, 4096
    pq = ProductQuantizer(
        rng.standard_normal((c, d)).astype(np.float32) * 0.1,
        np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32), dpc, d,
    )
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    card = pq.quantize(x)  # device="cuda" by default
    cpu = pq.quantize(x, device="cpu")
    rows, ks = np.nonzero(card != cpu)
    xt = (x[rows] @ pq.transform.T).reshape(len(rows), d // dpc, dpc)[np.arange(len(rows)), ks]
    sims = np.einsum("rd,crd->rc", xt, pq.centroids.reshape(c, d // dpc, dpc)[:, ks])
    gap = sims.max(-1, initial=-np.inf) - sims[np.arange(len(rows)), card[rows, ks]]
    assert (gap <= 1e-4).all(), gap.max()
    assert (card == cpu).mean() > 0.999
    codes_dev = torch.from_numpy(card).cuda()
    adc.reset_launches()
    for i in range(2):
        lut = pq.preprocess_query(x[i])
        got = pq.asymmetric_dot(lut, codes_dev)
        torch.cuda.synchronize()
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), torch.from_numpy(pq.asymmetric_dot(lut, card, device="cpu")),
                                   rtol=1e-4, atol=1e-4)
    assert adc.launches["adc_scores"] == 2


def test_quantizer_tool_on_the_card(capsys):
    """The tool at a small size on the card: one ADC launch per query."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from meme_search_engine_tpu_torch.tools import quantizer_bench

    adc.reset_launches()
    run = quantizer_bench.main(["--n", "3000", "--d-emb", "512"])
    assert adc.launches["adc_scores"] == len(run.q) == 64
    assert run.codes.device.type == "cuda" and run.x.device.type == "cuda"
    assert set(run.results) == {"opq_64x256", "rabitq_512", "scalar_u8", "faiss"}


@pytest.mark.parametrize("d", [16, 32, 72, 1152])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_gather_rows_kernel(gen, d, dtype):
    """Bit for bit against indexing; int8 rows of 16, 32 and 72 bytes take
    the 16-, 16- and 8-byte word routes, bf16 rows of 144 bytes 16."""
    n = 3001
    x = torch.randn((n, d), generator=gen, device="cuda").mul(50).to(dtype)
    for shape in ((1024, 128), (3, 50), (1, 1), (7, 0)):
        idx = torch.randint(0, n, shape, generator=gen, device="cuda", dtype=torch.int32)
        gather.reset_launches()
        got = gather.gather_rows(x, idx)
        torch.cuda.synchronize()
        assert gather.launches["gather_rows"] == (1 if idx.numel() else 0)
        assert got.shape == (*shape, d) and got.dtype == dtype
        assert torch.equal(got, x[idx.long()])


def test_gather_rows_kernel_narrow_words_and_clamped_ids(gen):
    """Rows of odd byte counts (1- and 2-byte words), a corpus whose base
    is not 16-byte aligned, and ids past both ends, which clamp."""
    for d, dtype in ((7, torch.int8), (9, torch.bfloat16), (33, torch.int8)):
        x = torch.randn((500, d), generator=gen, device="cuda").mul(50).to(dtype)
        idx = torch.randint(-50, 550, (64, 9), generator=gen, device="cuda", dtype=torch.int32)
        idx[0, :3] = torch.tensor([-(2**31), 2**31 - 1, 499], dtype=torch.int32)
        got = gather.gather_rows(x, idx)
        assert torch.equal(got, x[idx.long().clamp(0, 499)])
        assert torch.equal(got, gather.gather_rows_plain(x, idx))
    flat = torch.randint(-127, 128, (1 + 100 * 64,), generator=gen, device="cuda", dtype=torch.int8)
    x = flat[1:].view(100, 64)
    assert x.data_ptr() % 16 and x.is_contiguous()
    idx = torch.randint(0, 100, (5, 20), generator=gen, device="cuda", dtype=torch.int32)
    assert torch.equal(gather.gather_rows(x, idx), x[idx.long()])
    torch.cuda.synchronize()


def test_gather_rows_kernel_past_2_31_bytes(gen):
    """A 1e6 x 1152 bf16 corpus is 2.3 GB: rows near its end need 64-bit
    offsets."""
    n, d = 1_000_000, 1152
    x = torch.empty((n, d), device="cuda", dtype=torch.bfloat16)
    x[-1000:] = torch.randn((1000, d), generator=gen, device="cuda").to(torch.bfloat16)
    idx = torch.randint(n - 1000, n, (64, 100), generator=gen, device="cuda", dtype=torch.int32)
    assert torch.equal(gather.gather_rows(x, idx), x[idx.long()])
    del x
    torch.cuda.empty_cache()


def test_gather_rows_wrapper_refuses_what_the_kernel_does_not_take(gen):
    x = torch.randn((100, 64), generator=gen, device="cuda").to(torch.bfloat16)
    idx = torch.zeros((2, 3), device="cuda", dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        gather.gather_rows(x, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_rows(x.t(), idx)
    with pytest.raises(ValueError):
        gather.gather_rows(x, idx.cpu())
    with pytest.raises(ValueError, match=r"\(B, K\)"):
        gather.gather_rows(x, idx[0])


def test_vamana_build_on_the_card_matches_the_cpu_port():
    """tests/test_vamana.py's fixture built on the card: the build's own
    device-mirror check passes, every hop and prune goes through the
    gathered-dot kernels (and none through the row gather), and recall@10
    is within 0.03 of the CPU port's build."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from meme_search_engine_tpu_torch.index import vamana

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2000, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    cfg = vamana.VamanaConfig(r=16, l=48, maxc=96, alpha=1.0, batch_size=256)
    q = x[:200]
    truth = np.argsort(-(q @ x.T), axis=1)[:, :10]
    recall = {}
    for device in ("cuda", "cpu"):
        gather.reset_launches()
        graph = vamana.build_graph(x, cfg, seed=0, device=device)
        assert (gather.launches["gather_dot"] > 0) == (device == "cuda")
        assert (gather.launches["gather_gram"] > 0) == (device == "cuda")
        assert gather.launches["gather_rows"] == 0
        ids = vamana.search(x, graph, q, 10, cfg, device=device)[1]
        recall[device] = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, truth)])
    assert recall["cuda"] > 0.85 and abs(recall["cuda"] - recall["cpu"]) <= 0.03, recall


# the gathered dots: C ragged against the Gram's 128-wide tiles (1, 7, 129,
# 750), rows of 32, 72 (not a 16-byte multiple in int8) and 1152 elements


def _unit_rows(gen, n, d, dtype):
    """The build's corpora: bf16 unit vectors, or int8 in [-127, 127]; fp32
    unit vectors are the stitch's corpus when no device copy is given."""
    if dtype == torch.int8:
        return torch.randint(-127, 128, (n, d), generator=gen, device="cuda", dtype=torch.int8)
    x = torch.randn((n, d), generator=gen, device="cuda")
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


def _assert_dots(got, want, dtype):
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [32, 72, 1152])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("c", [1, 7, 129, 750])
def test_gather_dot_kernel(gen, c, dtype, d):
    n, b = 3001, 5
    x = _unit_rows(gen, n, d, dtype)
    idx = torch.randint(0, n, (b, c), generator=gen, device="cuda", dtype=torch.int32)
    q = x[torch.randint(0, n, (b,), generator=gen, device="cuda")].float()
    gather.reset_launches()
    got = gather.gather_dot(x, idx, q)
    assert gather.launches == {"gather_rows": 0, "gather_dot": 1, "gather_gram": 0}
    _assert_dots(got, gather.gather_dot_plain(x, idx, q), dtype)


@pytest.mark.parametrize("d", [32, 72, 1152])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("c", [1, 7, 129, 750])
def test_gather_gram_kernel(gen, c, dtype, d):
    """Against the plain version, and exactly symmetric: each tile on the
    diagonal stores its upper half twice, each one above it itself and
    its transpose."""
    n, b = 3001, 3
    x = _unit_rows(gen, n, d, dtype)
    ids = torch.randint(0, n, (b, c), generator=gen, device="cuda", dtype=torch.int32)
    gather.reset_launches()
    got = gather.gather_gram(x, ids)
    assert gather.launches == {"gather_rows": 0, "gather_dot": 0, "gather_gram": 1}
    _assert_dots(got, gather.gather_gram_plain(x, ids), dtype)
    assert torch.equal(got, got.transpose(1, 2))


def test_gathered_dots_kernels_at_the_builds_shapes(gen):
    """The hop, (1024, 128) ids, and a prune of 64 rows of the maxc = 750
    pool, into 48,643 x 1152 bf16 unit rows, as the shard build gives
    them."""
    x = _unit_rows(gen, 48_643, 1152, torch.bfloat16)
    hop = torch.randint(0, 48_643, (1024, 128), generator=gen, device="cuda", dtype=torch.int32)
    q = x[torch.randint(0, 48_643, (1024,), generator=gen, device="cuda")].float()
    _assert_dots(gather.gather_dot(x, hop, q), gather.gather_dot_plain(x, hop, q), torch.bfloat16)
    pool = torch.randint(0, 48_643, (64, 750), generator=gen, device="cuda", dtype=torch.int32)
    _assert_dots(gather.gather_gram(x, pool), gather.gather_gram_plain(x, pool), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_gathered_dots_kernels_clamp_ids_and_narrow_words(gen, dtype):
    """Ids past both ends clamp; rows of odd byte counts (2- and 1-byte
    words) and a corpus whose base is not 16-byte aligned run in the
    kernels too."""
    for d in (9, 33, 64):
        x = _unit_rows(gen, 500, d, dtype)
        idx = torch.randint(-50, 550, (6, 140), generator=gen, device="cuda", dtype=torch.int32)
        idx[0, :3] = torch.tensor([-(2**31), 2**31 - 1, 499], dtype=torch.int32)
        clamped = idx.clamp(0, 499)
        q = x[:6].float()
        got = gather.gather_dot(x, idx, q)
        _assert_dots(got, gather.gather_dot_plain(x, clamped, q), dtype)
        gram = gather.gather_gram(x, idx)
        _assert_dots(gram, gather.gather_gram_plain(x, clamped), dtype)
        assert torch.equal(gram, gather.gather_gram(x, clamped))
    flat = _unit_rows(gen, 1 + 100 * 64, 1, torch.int8).view(-1)
    x = flat[1:].view(100, 64)
    assert x.data_ptr() % 16 and x.is_contiguous()
    idx = torch.randint(0, 100, (5, 20), generator=gen, device="cuda", dtype=torch.int32)
    _assert_dots(gather.gather_dot(x, idx, x[:5].float()), gather.gather_dot_plain(x, idx, x[:5].float()), torch.int8)
    _assert_dots(gather.gather_gram(x, idx), gather.gather_gram_plain(x, idx), torch.int8)


def test_gathered_dots_kernels_past_2_31_bytes_and_no_ids(gen):
    """A 1e6 x 1152 bf16 corpus is 2.3 GB: rows near its end need 64-bit
    offsets. No ids launch nothing."""
    n, d = 1_000_000, 1152
    x = torch.zeros((n, d), device="cuda", dtype=torch.bfloat16)
    x[-1000:] = _unit_rows(gen, 1000, d, torch.bfloat16)
    idx = torch.randint(n - 1000, n, (64, 100), generator=gen, device="cuda", dtype=torch.int32)
    q = x[-64:].float()
    _assert_dots(gather.gather_dot(x, idx, q), gather.gather_dot_plain(x, idx, q), torch.bfloat16)
    _assert_dots(gather.gather_gram(x, idx[:4]), gather.gather_gram_plain(x, idx[:4]), torch.bfloat16)
    gather.reset_launches()
    assert gather.gather_dot(x, idx[:, :0], q).shape == (64, 0)
    assert gather.gather_gram(x, idx[:0]).shape == (0, 100, 100)
    assert gather.launches == {"gather_rows": 0, "gather_dot": 0, "gather_gram": 0}
    del x
    torch.cuda.empty_cache()


def test_gathered_dots_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = _unit_rows(gen, 100, 64, torch.bfloat16)
    idx = torch.zeros((2, 3), device="cuda", dtype=torch.int32)
    q = x[:2].float()
    with pytest.raises(TypeError, match="int32"):
        gather.gather_dot(x, idx.long(), q)
    with pytest.raises(TypeError, match="int32"):
        gather.gather_gram(x, idx.long())
    strided = _unit_rows(gen, 100, 128, torch.bfloat16)[:, :64]  # (100, 64), rows 256 B apart
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_dot(strided, idx, q)
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_gram(strided, idx)
    with pytest.raises(ValueError):
        gather.gather_dot(x, idx.cpu(), q)
    with pytest.raises(ValueError):
        gather.gather_gram(x, idx.cpu())
    with pytest.raises(TypeError, match="fp32"):
        gather.gather_dot(x, idx, x[:2])
    with pytest.raises(TypeError):
        gather.gather_gram(x.float(), idx)
    with pytest.raises(TypeError):
        gather.gather_dot(x.half(), idx, q)

