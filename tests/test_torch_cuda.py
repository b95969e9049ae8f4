"""The hand-written Hopper kernels against their plain versions, on the GPU.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (the kernels have no CPU mode). On a machine with the card and without
JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX).
"""

import pytest
import torch

from cryovit_tpu_torch import kernels
from cryovit_tpu_torch.ops import conv3d_dm as cd
from cryovit_tpu_torch.ops import convt_dm as ct
from cryovit_tpu_torch.ops import flash_attention as fa
from cryovit_tpu_torch.ops import fused_norm as fn
from cryovit_tpu_torch.ops import window_attention as wa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(dev, *shape, seed=0, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=dev) * scale).to(torch.bfloat16)


def _close(got, want):
    """bf16 outputs: within four bf16 ulps of the largest value."""
    got, want = got.float(), want.float()
    tol = 2.0**-6 * want.abs().max().item()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= tol


# The int8 attention's second limit (chip_smoke.py holds the kernel to the
# same): the RMS over output rows (one head's 64 values of one token) of each
# row's relative L2 error. On the outlier inputs the largest values are
# those of the few rows that attend to the ×16 value row, so _close alone
# would pass a fault on the ordinary rows; here every row counts alike.
INT8_ROW_RMS = 2.0**-7


def row_rms(got, want, width=fa.HEAD_DIM):
    """Root mean square over rows of ``width`` values of each row's relative
    L2 error ``‖got − want‖ / ‖want‖``."""
    got, want = (t.float().reshape(-1, width) for t in (got, want))
    return ((got - want).norm(dim=1) / want.norm(dim=1)).square().mean().sqrt().item()


@pytest.mark.parametrize("b,n,heads,true_len", [
    (2, 37, 2, None), (3, 130, 4, 101), (1, 1029, 24, None), (1, 4101, 2, None), (2, 4101, 2, 3999),
])
def test_attention_kernel_matches_plain(cuda, b, n, heads, true_len):
    """Column views of one projection, biases, ragged N and keys past
    true_len masked (ViT-g at 1024²: 4101 tokens)."""
    c = heads * fa.HEAD_DIM
    qkv = _randn(cuda, b, n, 3 * c)
    q, k, v = qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :]
    bias = _randn(cuda, 3, c, seed=1, scale=0.5)
    _close(fa.flash_attention(q, k, v, bias, heads, true_len),
           fa.flash_attention_reference(q, k, v, bias, heads, true_len))


def _outlier_qkv(dev, b, n, heads):
    """q, k, v as column views of one projection, with int8 outliers: q rows
    ≡ 3 (mod 64) ×16 (q ×4 overall), key 7 and value row 11 ×16."""
    c = heads * fa.HEAD_DIM
    qkv = _randn(dev, b, n, 3 * c)
    qkv[..., :c] *= 4
    qkv[:, 3::64, :c] *= 16
    qkv[:, min(7, n - 1), c : 2 * c] *= 16
    qkv[:, min(11, n - 1), 2 * c :] *= 16
    return qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :]


@pytest.mark.parametrize("quant", ["qk", "pv", "qkpv"])
@pytest.mark.parametrize("b,n,heads,true_len", [(2, 37, 2, None), (3, 130, 4, 101),
                                                (2, 520, 2, 515), (1, 1029, 24, None),
                                                (2, 1029, 2, 1024), (1, 4101, 2, None),
                                                (1, 4101, 24, 4096)])
def test_int8_attention_kernel_matches_plain(cuda, quant, b, n, heads, true_len):
    """The int8 kernel against its plain version (exact integer products)
    on outlier inputs with biases, by the largest error and by every row's;
    q chunks of 32 (N=520), 96 (1029) and 160 (4101), which 64-row query
    tiles straddle; N not a multiple of 64, a ragged true_len (N − 5); a
    second call equal bit for bit."""
    q, k, v = _outlier_qkv(cuda, b, n, heads)
    bias = _randn(cuda, 3, heads * fa.HEAD_DIM, seed=1, scale=0.5)
    got = fa.flash_attention(q, k, v, bias, heads, true_len, quant=quant)
    want = fa.flash_attention_reference(q, k, v, bias, heads, true_len, quant=quant)
    _close(got, want)
    assert row_rms(got, want) <= INT8_ROW_RMS
    assert torch.equal(fa.flash_attention(q, k, v, bias, heads, true_len, quant=quant), got)


@pytest.mark.parametrize("quant", ["qk", "pv", "qkpv"])
@pytest.mark.parametrize("b,n,heads,true_len", [(2, 130, 4, 101), (1, 1029, 24, None),
                                                (1, 4101, 2, 4096)])
def test_int8_operands_kernel_equals_plain(cuda, quant, b, n, heads, true_len):
    """The operand pre-pass's K and V (int8 where the mode quantizes, int8
    Vᵀ in pv_key_positions order, zero past true_len and in the padding)
    equal their plain twin bit for bit, on the kernel's own scales."""
    q, k, v = _outlier_qkv(cuda, b, n, heads)
    bias = _randn(cuda, 3, heads * fa.HEAD_DIM, seed=1, scale=0.5)
    scales = fa.attention_int8_scales(q, k, v, bias, heads, true_len, quant)
    got = fa.attention_int8_operands(q, k, v, bias, heads, true_len, quant, scales)
    want = fa.attention_int8_operands_reference(q, k, v, bias, heads, true_len, quant, scales)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("quant", ["qk", "pv", "qkpv"])
@pytest.mark.parametrize("b,n,heads,true_len", [(2, 520, 2, 515), (1, 1029, 4, None),
                                                (1, 4101, 2, 4000)])
def test_int8_scales_kernel_equals_plain(cuda, quant, b, n, heads, true_len):
    """The pre-pass's scales equal the plain ones bit for bit (a max and one
    f32 product each)."""
    q, k, v = _outlier_qkv(cuda, b, n, heads)
    bias = _randn(cuda, 3, heads * fa.HEAD_DIM, seed=1, scale=4.0)
    got = fa.attention_int8_scales(q, k, v, bias, heads, true_len, quant)
    want = fa.attention_int8_scales_reference(q, k, v, bias, heads, true_len, quant)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("quant", ["qk", "pv", "qkpv"])
def test_int8_pass_clocks_split_the_passes(cuda, quant):
    """The kernel's clock counters: pass 1 (Q·Kᵀ and the row max) runs only
    with int8 P·V, pass 2 always; one call of the kernel."""
    q, k, v = _outlier_qkv(cuda, 1, 1029, 2)
    bias = _randn(cuda, 3, 2 * fa.HEAD_DIM, seed=1, scale=0.5)
    p1, p2 = fa.int8_pass_clocks(q, k, v, bias, 2, quant)
    assert p2 > 0 and (p1 > 0) == ("pv" in quant)


def test_int8_attention_refuses_what_it_cannot_take(cuda):
    c = 2 * fa.HEAD_DIM
    q = torch.zeros(1, 5857, c, device=cuda, dtype=torch.bfloat16)
    bias = torch.zeros(3, c, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="single-K-block"):
        fa.flash_attention(q, q, q, bias, 2, quant="pv")
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention(q.float(), q.float(), q.float(), bias.float(), 2, quant="qk")
    with pytest.raises(ValueError, match="unknown quant mode"):
        fa.flash_attention(q, q, q, bias, 2, quant="int8")


@pytest.mark.parametrize("b,n,heads", [(2, 37, 2), (3, 130, 4), (2, 1029, 24)])
@pytest.mark.parametrize("layout", ["views", "contiguous"])
def test_attention_bhnd_kernel_matches_plain(cuda, b, n, heads, layout):
    """Head-major q, k, v as permuted (B, H, N, 64) views of one
    (B, N, 3, H, 64) projection, as the model passes them, or contiguous;
    ragged N. The output is a (B, H, N, 64) view of (B, N, H, 64) memory."""
    qkv = _randn(cuda, b, n, 3, heads, fa.HEAD_DIM)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    if layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    got = fa.flash_attention_bhnd(q, k, v)
    assert got.shape == (b, heads, n, fa.HEAD_DIM) and got.transpose(1, 2).is_contiguous()
    _close(got, fa.flash_attention_bhnd_reference(q, k, v))


def test_attention_bnhd_kernel_matches_plain(cuda):
    """(B, N, H, D) inputs, f32 cast to bf16 as the JAX flash_attention does."""
    q, k, v = (_randn(cuda, 2, 333, 3, fa.HEAD_DIM, seed=s).float() for s in range(3))
    got = fa.flash_attention_bnhd(q, k, v)
    assert got.shape == (2, 333, 3, fa.HEAD_DIM) and got.is_contiguous()
    assert got.dtype == torch.bfloat16
    _close(got, fa.flash_attention_bnhd_reference(q, k, v))


def test_head_major_output_feeds_the_projection_without_a_copy(cuda, monkeypatch):
    """The head-major Attention's path: the kernel's output, viewed back as
    (B, N, C), shares its memory; the block's output matches the block run
    on the plain version."""
    from cryovit_tpu_torch.models import dinov2 as dm

    b, n, heads = 2, 77, 4
    c = heads * fa.HEAD_DIM
    qkv = _randn(cuda, b, n, 3, heads, fa.HEAD_DIM)
    out = fa.flash_attention_bhnd(*(qkv[:, :, i].transpose(1, 2) for i in range(3)))
    flat = out.transpose(1, 2).reshape(b, n, c)
    assert flat.data_ptr() == out.data_ptr() and flat.is_contiguous()
    attn = dm.Attention(c, heads, pair_heads=False).to(cuda, torch.bfloat16)
    x = _randn(cuda, b, n, c, seed=1)
    got = attn(x)
    monkeypatch.setattr(dm, "flash_attention_bhnd", fa.flash_attention_bhnd_reference)
    _close(got, attn(x))


@pytest.mark.parametrize("x_dtype,h_dtype,with_gamma,shape", [
    (torch.bfloat16, torch.bfloat16, True, (2, 1029, 1536)),
    (torch.bfloat16, torch.bfloat16, False, (3, 37, 128)),
    (torch.float32, torch.bfloat16, True, (2, 1029, 1536)),
    (torch.float32, torch.float32, False, (1, 25, 1536)),
    (torch.float32, torch.float32, True, (5, 11, 200)),
])
def test_residual_layernorm_kernel_matches_plain(cuda, x_dtype, h_dtype, with_gamma, shape):
    """Every (x, h) dtype pair the model produces, with and without
    LayerScale, ragged row counts and C = 200 (not a multiple of 256); bf16
    parameters as the model holds them. x' to its dtype's rounding (f32: 1e-5 of max|x'|), y within
    2^-6·max|plain|."""
    c = shape[-1]
    x = _randn(cuda, *shape).to(x_dtype)
    h = _randn(cuda, *shape, seed=1).to(h_dtype)
    gamma = _randn(cuda, c, seed=2, scale=0.5) if with_gamma else None
    scale, bias = 1 + _randn(cuda, c, seed=3, scale=0.1), _randn(cuda, c, seed=4, scale=0.1)
    got_x, got_y = fn.residual_layernorm(x, h, gamma, scale, bias)
    want_x, want_y = fn.residual_layernorm_reference(x, h, gamma, scale, bias)
    assert got_x.dtype == x_dtype and got_y.dtype == torch.bfloat16
    if x_dtype == torch.float32:
        assert (got_x - want_x).abs().max().item() <= 1e-5 * want_x.abs().max().item()
    else:
        _close(got_x, want_x)
    _close(got_y, want_y)


def _block_params(dev, c, f, c_out, seed=1):
    """LayerNorm affine (f32) and a Linear pair (c → f, then → c_out) in
    bf16, torch layout: the arguments after x of the window-block ops."""
    g = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    inner = c if f == 3 * c else f  # window_block_attention: proj is (C, C)
    return (
        1.0 + randn(c, scale=0.1), randn(c, scale=0.1),
        randn(f, c, scale=c**-0.5).bfloat16(), randn(f, scale=0.1).bfloat16(),
        randn(c_out, inner, scale=inner**-0.5).bfloat16(), randn(c_out, scale=0.1).bfloat16(),
    )


@pytest.mark.parametrize("n,t,heads,d", [(3, 256, 8, 72), (5, 144, 1, 72), (2, 200, 2, 72),
                                        (3, 256, 4, 96), (2, 77, 1, 96)])
def test_window_block_attention_kernel_matches_plain(cuda, n, t, heads, d):
    """Hiera-L's stage-3 block width (8 x 72) at 256-token windows, one head
    of 72, head width 96, and token counts that leave ragged row, query and
    key tiles."""
    c = heads * d
    x = _randn(cuda, n, t, c)
    ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj = _block_params(cuda, c, 3 * c, c)
    params = (ln_w, ln_b, *wa.fold_q_scale(w_qkv, b_qkv, heads), w_proj, b_proj)
    _close(wa.window_block_attention(x, *params, heads),
           wa.window_block_attention_reference(x, *params, heads))


@pytest.mark.parametrize("n,t,c", [(3, 256, 576), (5, 144, 72), (1, 7, 16)])
def test_window_block_mlp_kernel_matches_plain(cuda, n, t, c):
    x = _randn(cuda, n, t, c)
    params = _block_params(cuda, c, 4 * c, c)
    _close(wa.window_block_mlp(x, *params), wa.window_block_mlp_reference(x, *params))


@pytest.mark.parametrize("op,n,t,c,heads,offset", [
    ("mlp", 1, 300, 144, None, 0.0),  # 300 rows: two 128-row tiles and 44; K tail of 16
    ("mlp", 3, 100, 704, None, 0.0),  # the widest C: 11 k chunks beside two ring stages
    ("mlp", 2, 129, 576, None, 8.0),  # Hiera-L's stage-3 width, x offset by +8
    ("attention", 1, 130, 216, 3, 0.0),  # 3C = 648: a ragged 144-column tile; K tail of 24
    ("attention", 2, 256, 576, 8, 8.0),  # Hiera-L's stage-3 block, x offset by +8
])
def test_window_block_kernels_at_the_tile_edges(cuda, op, n, t, c, heads, offset):
    """The wgmma products at their edges: row counts that are not a multiple
    of the 128-row tile, C not a multiple of the 64-column k chunk (the K
    tail, and the LayerNorm's zero-filled columns past C set back to 0),
    ragged output tiles, the widest C the LayerNorm products take, and x
    offset by +8, where the variance is E[x²] − mean² at a large mean."""
    x = (_randn(cuda, n, t, c).float() + offset).bfloat16()
    if op == "mlp":
        params = _block_params(cuda, c, 4 * c, c)
        got, want = wa.window_block_mlp(x, *params), wa.window_block_mlp_reference(x, *params)
    else:
        ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj = _block_params(cuda, c, 3 * c, c)
        params = (ln_w, ln_b, *wa.fold_q_scale(w_qkv, b_qkv, heads), w_proj, b_proj)
        got = wa.window_block_attention(x, *params, heads)
        want = wa.window_block_attention_reference(x, *params, heads)
    _close(got, want)


@pytest.mark.parametrize("b,t,heads,d", [(2, 1024, 8, 72), (3, 200, 1, 72), (1, 77, 2, 72),
                                        (2, 1024, 4, 96), (3, 200, 1, 96), (1, 77, 2, 96)])
def test_window_attention_kernel_matches_plain(cuda, b, t, heads, d):
    """q (pre-scaled), k and v as column views of one (B, T, 3C)
    projection, as the global blocks pass them: Hiera-L's 8 x 72 and
    Hiera-T's 4 x 96 at 1024 tokens, and ragged T."""
    c = heads * d
    qkv = _randn(cuda, b, t, 3 * c)
    qkv[..., :c] *= d**-0.5 * wa.LOG2E
    q, k, v = qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :]
    _close(wa.window_attention(q, k, v, heads), wa.window_attention_reference(q, k, v, heads))


def test_window_kernels_refuse_what_they_cannot_take(cuda):
    """f32, head widths without a kernel, non-contiguous x and C past
    ``MAX_BLOCK_WIDTH`` raise before a launch; a launch the library refuses
    (head width 64 past the wrapper) returns an error code, and
    ``kernels.check`` raises on it."""
    x = _randn(cuda, 2, 128, 144)
    params = _block_params(cuda, 144, 432, 144)
    with pytest.raises(ValueError, match="bfloat16"):
        wa.window_block_attention(x.float(), *params, 2)
    with pytest.raises(ValueError, match="head dim"):
        wa.window_block_attention(x, *params, 1)
    with pytest.raises(ValueError, match="contiguous"):
        wa.window_block_mlp(x.transpose(0, 1), *_block_params(cuda, 144, 576, 144))
    with pytest.raises(ValueError, match="head dim"):
        wa.window_attention(x[..., :128], x[..., :128], x[..., :128], 2)
    wide = wa.MAX_BLOCK_WIDTH + 8
    with pytest.raises(ValueError, match=f"up to {wa.MAX_BLOCK_WIDTH}"):
        wa.window_block_mlp(_randn(cuda, 1, 8, wide), *_block_params(cuda, wide, 4 * wide, wide))
    out = torch.empty(2, 128, 128, device=cuda, dtype=torch.bfloat16)
    rc = kernels.load_library().cryovit_window_attention(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), out.data_ptr(), 2, 128, 2, 64, 144, 128 * 144,
        torch.cuda.current_stream().cuda_stream,
    )
    assert rc != 0
    with pytest.raises(RuntimeError, match="failed to launch"):
        kernels.check(rc, "window_attention")


@pytest.mark.parametrize(
    "ci,co,b,d,h,w,dil",
    [
        (8, 1, 2, 5, 7, 33, 1), (16, 8, 2, 5, 20, 64, 2), (32, 32, 2, 5, 9, 40, 4),
        # every (Ci, Co) the decoder makes, forward and input gradient; H not
        # a multiple of the tile height, W below, past and off a 64-wide tile
        (32, 32, 1, 12, 10, 128, 8),  # 32 -> 32 at dilation 8 >= D - 4
        (32, 16, 2, 6, 13, 72, 2),
        (16, 32, 1, 6, 11, 136, 2),
        (16, 16, 2, 5, 18, 64, 1),  # 18 rows: past one 16-row tile
        (8, 8, 1, 6, 35, 24, 1),  # W below one tile, 35 rows past one 32-row tile
        (8, 1, 2, 4, 4, 128, 6),  # dilation 6 >= D = 4: only the centre depth tap
        (1, 8, 1, 6, 20, 36, 1),  # the mask head's input gradient; W % 8 != 0
        (8, 8, 1, 70, 2, 64, 1),  # a depth chain of 70 planes: three segments of 32
        (24, 16, 1, 5, 5, 16, 1),  # Ci = 24, padded to 32 in the kernel
        (1, 32, 1, 4, 5, 64, 2),
        (32, 1, 1, 4, 3, 13, 1),  # W % 8 != 0 at Ci = 32
        # UNet3D's level 1: the first conv 1 -> 16, the others 16 -> 16
        (1, 16, 1, 6, 21, 72, 1),
        (16, 16, 1, 7, 33, 80, 1),
    ],
)
def test_conv3d_kernel_matches_plain(cuda, ci, co, b, d, h, w, dil):
    """Within 2^-6·max|plain| (bf16 output), and the same bits on a second
    run: each output voxel is summed in one warp in a fixed order."""
    x = _randn(cuda, b, d, ci, h, w)
    kern = _randn(cuda, 3, 3, 3, ci, co, seed=1, scale=(27 * ci) ** -0.5)
    got = cd.conv3d_dm(x, kern, (dil, 1, 1))
    _close(got, cd.conv3d_dm_reference(x, kern, (dil, 1, 1)))
    assert torch.equal(got, cd.conv3d_dm(x, kern, (dil, 1, 1)))


@pytest.mark.parametrize(
    "ci,co,h,w",
    [
        (8, 1, 5, 9), (16, 8, 12, 20), (32, 32, 8, 128),
        (64, 8, 9, 72),  # Ci = 64: four k16 steps; odd H; W past one 64-wide tile
        (5, 16, 3, 33),  # Ci = 5, zero-padded to one k16 step; W % 8 != 0
        (24, 32, 7, 64),  # Ci = 24: a half-empty second k16 step; odd H
        (16, 1, 1, 8),  # H = 1 of a tile's 8 rows; W = 8, one 16-byte chunk
    ],
)
def test_convt_kernel_matches_plain(cuda, ci, co, h, w):
    """Within 2^-6·max|plain| (bf16 output), B·D = 6 planes, and the same
    bits on a second run."""
    x = _randn(cuda, 2, 3, ci, h, w)
    kern = _randn(cuda, 1, 2, 2, ci, co, seed=1, scale=ci**-0.5)
    got = ct.convt2x_dm(x, kern)
    _close(got, ct.convt2x_dm_reference(x, kern))
    assert torch.equal(got, ct.convt2x_dm(x, kern))


def test_each_launch_counts_once(cuda):
    kernels.reset_launch_counts()
    x = _randn(cuda, 1, 2, 8, 4, 4)
    cd.conv3d_dm(x, _randn(cuda, 3, 3, 3, 8, 8))
    ct.convt2x_dm(x, _randn(cuda, 1, 2, 2, 8, 8))
    ct.convt2x_dm(x, _randn(cuda, 1, 2, 2, 8, 8))
    cd.conv3d_dm_dw(x, x)
    ct.convt2x_dm_bwd(_randn(cuda, 1, 2, 8, 8, 8), x, _randn(cuda, 1, 2, 2, 8, 8))
    xw = _randn(cuda, 2, 128, 72)
    wa.window_block_attention(xw, *_block_params(cuda, 72, 216, 72), 1)
    wa.window_block_mlp(xw, *_block_params(cuda, 72, 288, 72))
    wa.window_attention(xw, xw, xw, 1)
    qh = _randn(cuda, 1, 2, 16, fa.HEAD_DIM)
    fa.flash_attention_bhnd(qh, qh, qh)
    fa.flash_attention_bnhd(qh, qh, qh)
    fa.flash_attention_bnhd(qh, qh, qh)
    ln = (t.bfloat16() for t in _block_params(cuda, 72, 72, 72)[:2])
    fn.residual_layernorm(xw, xw, None, *ln)
    qc = _randn(cuda, 1, 16, 128)
    fa.flash_attention(qc, qc, qc, _randn(cuda, 3, 128), 2, quant="qkpv")
    fa.attention_int8_scales(qc, qc, qc, _randn(cuda, 3, 128), 2, quant="pv")
    assert kernels.launch_counts() == {
        "flash_attention_int8_operands": 1,
        "flash_attention": 0, "conv3d_dm": 1, "convt2x_dm": 2, "conv3d_dm_dw": 1,
        "convt2x_dm_bwd": 1, "window_block_attention": 1, "window_block_mlp": 1,
        "window_attention": 1, "flash_attention_bhnd": 1, "flash_attention_bnhd": 2,
        "residual_layernorm": 1, "flash_attention_int8": 1, "flash_attention_int8_scales": 2,
    }


@pytest.mark.parametrize(
    "ci,co,d,h,w,dil",
    [
        (8, 1, 5, 7, 33, 1), (16, 8, 5, 20, 64, 2), (32, 32, 5, 9, 40, 4), (32, 16, 5, 12, 70, 7),
        (8, 8, 5, 3, 5, 1),
        (1, 8, 5, 6, 64, 1),  # Ci = 1: 7 zero channels in the 8-channel row-pair tile
        (3, 16, 5, 5, 24, 2),  # Ci = 3; W below one 64-wide tile, a multiple of 8
        (40, 8, 5, 3, 72, 1),  # Ci > 32: two channel chunks; W past one tile
        (16, 32, 5, 1, 136, 1),  # H = 1; W a multiple of 8, not of the tile
        (8, 1, 4, 4, 128, 6),  # dilation 6 >= D = 4
        (32, 32, 12, 10, 128, 8),  # decoder width: 32 -> 32, dilation 8, 128-wide
        (8, 8, 70, 2, 64, 1),  # a depth chain of 70 planes: three segments of 32
        # UNet3D's level 1: Ci 1 and 16 -> 16 at dilation 1
        (1, 16, 6, 9, 72, 1),
        (16, 16, 6, 10, 64, 1),
    ],
)
def test_conv3d_dw_kernel_matches_plain(cuda, ci, co, d, h, w, dil):
    """Ragged H and W (W % 8 != 0 lands element by element), H = 1, Ci = 1,
    3 and 40, every Co of KERNEL_COUT, depth dilation >= D (only the centre
    depth tap has planes); f32 sums in another order: within
    1e-3·max|plain|, and the same bits on a second run (fixed-order
    reduction)."""
    x = _randn(cuda, 2, d, ci, h, w)
    g = _randn(cuda, 2, d, co, h, w, seed=1)
    got = cd.conv3d_dm_dw(x, g, (dil, 1, 1))
    want = cd.conv3d_dm_dw_reference(x, g, (dil, 1, 1))
    assert got.dtype == torch.float32 and got.shape == (3, 3, 3, ci, co)
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()
    assert torch.equal(got, cd.conv3d_dm_dw(x, g, (dil, 1, 1)))


@pytest.mark.parametrize(
    "ci,co,h,w",
    [
        (8, 8, 5, 9), (16, 8, 12, 20), (32, 32, 8, 128), (32, 16, 3, 33),
        (16, 16, 7, 72),  # odd H; W a multiple of 8 past one 64-wide tile
        (32, 8, 9, 40),  # Ci / Co = 4: the two-stage ring; odd H
        (8, 32, 1, 64),  # H = 1 of a tile's 2 rows
    ],
)
def test_convt_bwd_kernel_matches_plain(cuda, ci, co, h, w):
    """dx in bf16 within 2^-6·max|plain|; dW (f32) within 1e-3·max|plain|;
    B·D = 6 planes; the same bits on a second run (dW's partials are added
    in a fixed order)."""
    x = _randn(cuda, 2, 3, ci, h, w)
    g = _randn(cuda, 2, 3, co, 2 * h, 2 * w, seed=1)
    kern = _randn(cuda, 1, 2, 2, ci, co, seed=2, scale=ci**-0.5)
    dx, dw = ct.convt2x_dm_bwd(g, x, kern)
    want_dx, want_dw = ct.convt2x_dm_bwd_reference(g, x, kern)
    _close(dx, want_dx)
    assert dw.shape == want_dw.shape == (1, 2, 2, ci, co)
    assert (dw - want_dw).abs().max().item() <= 1e-3 * want_dw.abs().max().item()
    dx2, dw2 = ct.convt2x_dm_bwd(g, x, kern)
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2)


def test_conv3d_kernel_takes_one_input_channel(cuda):
    """The input gradient of the mask head's 8 -> 1 conv is a 1 -> 8 conv:
    the kernel turns each voxel's 9 lateral taps into the 16 channels of one
    k16 step."""
    g = _randn(cuda, 1, 6, 1, 20, 36)
    kern = _randn(cuda, 3, 3, 3, 1, 8, seed=1)
    _close(cd.conv3d_dm(g, kern), cd.conv3d_dm_reference(g, kern))


def test_decoder_gradients_match_plain_versions_on_the_gpu(cuda, monkeypatch):
    """A bf16 decoder (full width, f32 master weights) backpropagates a
    masked Dice loss through the kernels; the same step with every kernel
    wrapper swapped for its plain version on the GPU gives each parameter's
    gradient within relative L2 error 2e-2 (bf16 outputs, the same inputs)."""
    from cryovit_tpu_torch.models import cryovit as cv
    from cryovit_tpu_torch.models.losses import dice_loss

    sd = cv.random_cryovit_state_dict(torch.Generator().manual_seed(0), in_channels=64)
    feats = torch.randn(1, 4, 4, 6, 64, generator=torch.Generator().manual_seed(1)).to(cuda)
    label = (torch.rand(1, 4, 64, 96, generator=torch.Generator().manual_seed(2)) > 0.5).float()
    label[:, 0] = -1
    label = label.to(cuda)

    def grads():
        model = cv.make_cryovit(sd, device=cuda, dtype=torch.bfloat16, trainable=True)
        dice_loss(model(feats), label, label > -1).backward()
        return {n: p.grad.float() for n, p in model.named_parameters()}

    kernels.reset_launch_counts()
    got = grads()
    assert kernels.launch_counts()["conv3d_dm_dw"] == 6
    assert kernels.launch_counts()["convt2x_dm_bwd"] == 2
    monkeypatch.setattr(cv, "conv3d_dm", cd.conv3d_dm_reference)
    monkeypatch.setattr(cv, "conv3d_dm_dw", cd.conv3d_dm_dw_reference)
    monkeypatch.setattr(cv, "convt2x_dm", ct.convt2x_dm_reference)
    monkeypatch.setattr(cv, "convt2x_dm_bwd", ct.convt2x_dm_bwd_reference)
    want = grads()
    for name, w in want.items():
        rel = (got[name] - w).norm() / w.norm().clamp_min(1e-12)
        assert rel.item() <= 2e-2, (name, rel.item())


def test_unet3d_train_step_matches_the_cpu(cuda):
    """One UNet3D train step (full width, 1x16x32x32 voxels, masked Dice)
    in bf16 through the kernels against CPU f32 through the plain versions:
    probabilities, loss and each gradient (relative L2; against the largest
    norm for a tensor whose norm is below 1e-3 of it) within the train
    reference's limits (2e-2, 2e-4, 5e-2) or twice the CPU bf16 plain path's
    own error against f32, whichever is larger (chip_smoke.py's rule); the
    step launches conv3d_dm 5 times and conv3d_dm_dw 3 times."""
    from cryovit_tpu_torch.models.losses import dice_loss
    from cryovit_tpu_torch.models.unet3d import make_unet3d, random_unet3d_state_dict

    sd = random_unet3d_state_dict(torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(10)
    x = torch.rand(1, 16, 32, 32, 1, generator=gen)
    label = (torch.rand(1, 16, 32, 32, generator=gen) > 0.5).to(torch.int8)
    label[:, 0] = -1
    cpu = torch.device("cpu")
    out = {}
    for device, dtype in ((cuda, torch.bfloat16), (cpu, torch.bfloat16), (cpu, torch.float32)):
        model = make_unet3d(sd, device=device, dtype=dtype, trainable=True)
        y = label.to(device)
        kernels.reset_launch_counts()
        probs = model(x.to(device))
        loss = dice_loss(probs, y, y > -1)
        loss.backward()
        if device.type == "cuda":
            counts = kernels.launch_counts()
        out[(device.type, dtype)] = (probs.detach().float().cpu(), loss.item(),
                                     {n: p.grad.float().cpu() for n, p in model.named_parameters()})
    p_ref, loss_ref, g_ref = out[("cpu", torch.float32)]
    largest = max(g.norm().item() for g in g_ref.values())

    def errors(key):
        probs, loss, grads = out[key]
        worst = max((grads[n] - w).norm().item()
                    / (w.norm().item() if w.norm().item() >= 1e-3 * largest else largest)
                    for n, w in g_ref.items())
        return (probs - p_ref).abs().max().item(), abs(loss - loss_ref), worst

    limits = [max(tol, 2 * e) for tol, e in zip((2e-2, 2e-4, 5e-2),
                                                 errors(("cpu", torch.bfloat16)))]
    got = errors(("cuda", torch.bfloat16))
    assert all(e <= lim for e, lim in zip(got, limits)), (got, limits)
    assert counts["conv3d_dm"] == 5 and counts["conv3d_dm_dw"] == 3


def test_cuda_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    """f32 CUDA tensors and conv weights, head widths other than 64 and
    unsupported channel counts raise: nothing falls back to the plain
    versions on the GPU."""
    x32 = torch.zeros(1, 2, 8, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        cd.conv3d_dm(x32, torch.zeros(3, 3, 3, 8, 8, device=cuda))
    with pytest.raises(ValueError, match="bf16 weights"):
        cd.conv3d_dm(x32.bfloat16(), torch.zeros(3, 3, 3, 8, 8, device=cuda))
    x12 = torch.zeros(1, 2, 12, 4, 4, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Ci in"):
        cd.conv3d_dm(x12, torch.zeros(3, 3, 3, 12, 8, device=cuda, dtype=torch.bfloat16))
    x40 = torch.zeros(1, 2, 40, 4, 4, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 32"):
        cd.conv3d_dm(x40, torch.zeros(3, 3, 3, 40, 8, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="Co in"):
        ct.convt2x_dm(x32.bfloat16(), torch.zeros(1, 2, 2, 8, 4, device=cuda))
    with pytest.raises(ValueError, match="bf16 weights"):
        ct.convt2x_dm(x32.bfloat16(), torch.zeros(1, 2, 2, 8, 8, device=cuda))
    x = x32.bfloat16()
    with pytest.raises(ValueError, match="bf16"):
        cd.conv3d_dm_dw(x32, x)
    with pytest.raises(ValueError, match="Co in"):
        cd.conv3d_dm_dw(x, torch.zeros(1, 2, 4, 4, 4, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        cd.conv3d_dm_dw(x, x.transpose(3, 4))
    g = torch.zeros(1, 2, 1, 8, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Ci and Co in"):
        ct.convt2x_dm_bwd(g, x, torch.zeros(1, 2, 2, 8, 1, device=cuda))
    with pytest.raises(ValueError, match="is not"):
        ct.convt2x_dm_bwd(g[:, :, :, :4].contiguous(), x, torch.zeros(1, 2, 2, 8, 1, device=cuda))
    with pytest.raises(ValueError, match="bf16 weights"):
        ct.convt2x_dm_bwd(torch.zeros(1, 2, 8, 8, 8, device=cuda, dtype=torch.bfloat16), x,
                          torch.zeros(1, 2, 2, 8, 8, device=cuda))
    q = torch.zeros(1, 5, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q, torch.zeros(3, 64, device=cuda, dtype=torch.bfloat16), 2)
    qh = torch.zeros(1, 2, 5, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention_bhnd(qh.float(), qh.float(), qh.float())
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bhnd(qh[..., :32], qh[..., :32], qh[..., :32])
    shifted = torch.zeros(qh.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:].view(qh.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_bhnd(shifted, qh, qh)
    # a token stride of 68 elements (136 bytes): TMA takes multiples of 16 bytes
    odd = torch.zeros(1, 2, 5, 68, device=cuda, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fa.flash_attention_bhnd(odd, qh, qh)
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fa.flash_attention_bnhd(odd.transpose(1, 2), qh.transpose(1, 2), qh.transpose(1, 2))
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bnhd(qh[..., :32], qh[..., :32], qh[..., :32])
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention_bnhd(qh, qh, qh, dtype=torch.float32)
    x = torch.zeros(2, 3, 128, device=cuda, dtype=torch.bfloat16)
    ln = (torch.ones(128, device=cuda, dtype=torch.bfloat16),
          torch.zeros(128, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bf16 or f32"):
        fn.residual_layernorm(x.half(), x, None, *ln)
    with pytest.raises(TypeError, match="only with an f32 x"):
        fn.residual_layernorm(x, x.float(), None, *ln)
    with pytest.raises(TypeError, match="bf16 vector"):
        fn.residual_layernorm(x, x, None, *(t.float() for t in ln))
    with pytest.raises(ValueError, match="contiguous"):
        fn.residual_layernorm(x.transpose(0, 1), x.transpose(0, 1), None, *ln)
    with pytest.raises(ValueError, match="multiple of 8"):
        fn.residual_layernorm(x[..., :100].contiguous(), x[..., :100].contiguous(), None,
                              ln[0][:100], ln[1][:100])
    with pytest.raises(TypeError, match="y in bf16"):
        fn.residual_layernorm(x, x, None, *ln, y_dtype=torch.float32)


def _sam2_step(device, dtype, sd, x, label, **custom):
    """One SAM2 train step's probabilities, total loss and the gradients of
    the trained parameters."""
    from cryovit_tpu_torch.models import SAM2
    from cryovit_tpu_torch.models.base import prediction_mask
    from cryovit_tpu_torch.models.losses import DiceLoss

    fam = SAM2(name="SAM2", input_key="data", lr=5e-5, losses={"dice_loss": DiceLoss()},
               metrics={}, dtype=dtype, custom_kwargs=custom)
    module = fam.build_module(sd, device)
    y = label.to(device)
    preds, aux = fam.apply_with_aux(module, x.to(device))
    losses = fam.compute_losses(preds, y, prediction_mask(y), aux=aux)
    losses["total"].backward()
    return (preds.detach().float().cpu(), losses["total"].item(),
            {n: p.grad.float().cpu() for n, p in module.named_parameters() if p.grad is not None})


def test_sam2_train_step_matches_the_cpu(cuda):
    """One SAM2 train step at SAM2Config.tiny_test()'s widths and 256² on 32
    slices of a blob tomogram, GPU bf16 against CPU f32: ``chip_smoke.py``'s
    SAM2 train reference, run as the smoke script runs it. Probabilities,
    loss, and per group of trained leaves the gradient's direction (1 − cos)
    and size (|ln norm ratio|), each within the train reference's limit or
    twice the CPU bf16 plain path's own reading; the limits must reject a
    planted zero and a sign-flipped gradient in every group."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.sam2_reference_phase(cuda)  # raises on any failed check


def test_sam2_hiera_l_train_step_launches_rows_9_to_11(cuda):
    """A SAM2 train step at full width (SAM2Config.large(), 512²) on 8 slices
    with the encoder run live in chunks of 4: each chunk launches Hiera-L's
    32 fused window blocks (rows 9 and 10) and 3 global attentions (row
    11), so the step launches 64 / 64 / 6 (the 128-slice crop's two
    64-slice chunks give the same), nothing else; the probabilities are
    finite and in [0, 1]."""
    from cryovit_tpu_torch.models.sam2.config import SAM2Config
    from cryovit_tpu_torch.models.sam2.model import random_sam2_state_dict

    sd = random_sam2_state_dict(SAM2Config.large(), torch.Generator(device=cuda).manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    x = torch.rand(1, 8, 512, 512, 1, generator=gen)
    label = (torch.rand(1, 8, 512, 512, generator=gen) > 0.5).to(torch.int8)
    kernels.reset_launch_counts()
    probs, loss, grads = _sam2_step(cuda, torch.bfloat16, sd, x, label, encoder_chunk=4)
    torch.cuda.synchronize()
    counts = {k: n for k, n in kernels.launch_counts().items() if n}
    assert counts == {"window_block_attention": 64, "window_block_mlp": 64, "window_attention": 6}
    assert torch.isfinite(probs).all() and 0 <= probs.min() and probs.max() <= 1
    assert any(n.startswith("prompt_predictor.") for n in grads)


@pytest.mark.parametrize("m,k,n,with_bias", [(65, 1536, 4608, False), (4096, 576, 2304, True),
                                             (17, 72, 216, True)])
def test_w8a8_product_matches_the_cpu(cuda, m, k, n, with_bias):
    """``ops/quant.py:int8_matmul`` (cuBLASLt's int8 path through
    ``torch._int_mm``, then the f32 dequantization and the bf16 bias) on the
    GPU against the same call on the CPU, bit for bit: the int32 products
    are exact and the epilogue rounds the same way on both."""
    from cryovit_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(m + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    sx, sw = torch.rand(m, 1, generator=g) * 0.01, torch.rand(n, generator=g) * 0.01
    bias = torch.randn(n, generator=g) if with_bias else None
    want = quant.int8_matmul(xq, sx, wq, sw, torch.bfloat16, bias)
    got = quant.int8_matmul(*(t.to(cuda) for t in (xq, sx, wq, sw)), torch.bfloat16,
                            None if bias is None else bias.to(cuda))
    assert got.dtype == torch.bfloat16 and torch.equal(got.cpu(), want)


def test_w8a8_product_refuses_what_the_card_cannot_take(cuda):
    """16 rows, or K or N not a multiple of 8, raise on the GPU (no CPU
    fallback)."""
    from cryovit_tpu_torch.ops import quant

    for m, k, n in ((16, 64, 64), (32, 60, 64), (32, 64, 60)):
        xq = torch.zeros(m, k, dtype=torch.int8, device=cuda)
        wq = torch.zeros(n, k, dtype=torch.int8, device=cuda)
        with pytest.raises(ValueError, match="int8_matmul on CUDA"):
            quant.int8_matmul(xq, torch.ones(m, 1, device=cuda), wq, torch.ones(n, device=cuda),
                              torch.bfloat16)


def test_w8a8_models_match_the_cpu(cuda):
    """The w8a8 mode, GPU bf16 against CPU f32 (both int8): ``chip_smoke.py``'s
    w8a8 reference, run as the smoke script runs it. The DINOv2 pair path
    (features and fused probabilities) and the Hiera at widths 72 and 96
    (both kernel gates open) within the serving reference's 2e-2 or twice
    the CPU's bf16 reading; the launches and int8 products the gates give;
    the two planted faults read above a limit."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.w8a8_reference_phase(cuda)  # raises on any failed check
