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


@pytest.mark.parametrize("b,n,heads,true_len", [(2, 37, 2, None), (3, 130, 4, 101), (1, 1029, 24, None)])
def test_attention_kernel_matches_plain(cuda, b, n, heads, true_len):
    c = heads * fa.HEAD_DIM
    qkv = _randn(cuda, b, n, 3 * c)
    q, k, v = qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :]
    bias = _randn(cuda, 3, c, seed=1, scale=0.5)
    _close(fa.flash_attention(q, k, v, bias, heads, true_len),
           fa.flash_attention_reference(q, k, v, bias, heads, true_len))


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


@pytest.mark.parametrize("n,t,heads", [(3, 256, 8), (5, 144, 1), (2, 200, 2)])
def test_window_block_attention_kernel_matches_plain(cuda, n, t, heads):
    """Hiera-L's stage-3 block width (8 x 72) at 256-token windows, one head
    of 72, and token counts that leave ragged row, query and key tiles."""
    c = heads * 72
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


@pytest.mark.parametrize("b,t,heads", [(2, 1024, 8), (3, 200, 1), (1, 77, 2)])
def test_window_attention_kernel_matches_plain(cuda, b, t, heads):
    """q (pre-scaled), k and v as column views of one (B, T, 3C)
    projection, as the global blocks pass them."""
    c = heads * 72
    qkv = _randn(cuda, b, t, 3 * c)
    qkv[..., :c] *= 72**-0.5 * wa.LOG2E
    q, k, v = qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :]
    _close(wa.window_attention(q, k, v, heads), wa.window_attention_reference(q, k, v, heads))


def test_window_kernels_refuse_what_they_cannot_take(cuda):
    """f32, head widths without a kernel and non-contiguous x raise before a
    launch; a launch the library refuses (head width 64 past the wrapper)
    returns an error code, and ``kernels.check`` raises on it."""
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
    out = torch.empty(2, 128, 128, device=cuda, dtype=torch.bfloat16)
    rc = kernels.load_library().cryovit_window_attention(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), out.data_ptr(), 2, 128, 2, 64, 144, 128 * 144,
        torch.cuda.current_stream().cuda_stream,
    )
    assert rc != 0
    with pytest.raises(RuntimeError, match="failed to launch"):
        kernels.check(rc, "window_attention")


@pytest.mark.parametrize("ci,co,h,w,dil", [(8, 1, 7, 33, 1), (16, 8, 20, 64, 2), (32, 32, 9, 40, 4)])
def test_conv3d_kernel_matches_plain(cuda, ci, co, h, w, dil):
    x = _randn(cuda, 2, 5, ci, h, w)
    kern = _randn(cuda, 3, 3, 3, ci, co, seed=1, scale=(27 * ci) ** -0.5)
    _close(cd.conv3d_dm(x, kern, (dil, 1, 1)), cd.conv3d_dm_reference(x, kern, (dil, 1, 1)))


@pytest.mark.parametrize("ci,co,h,w", [(8, 1, 5, 9), (16, 8, 12, 20), (32, 32, 8, 128)])
def test_convt_kernel_matches_plain(cuda, ci, co, h, w):
    x = _randn(cuda, 2, 3, ci, h, w)
    kern = _randn(cuda, 1, 2, 2, ci, co, seed=1, scale=ci**-0.5)
    _close(ct.convt2x_dm(x, kern), ct.convt2x_dm_reference(x, kern))


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
    assert kernels.launch_counts() == {
        "flash_attention": 0, "conv3d_dm": 1, "convt2x_dm": 2, "conv3d_dm_dw": 1,
        "convt2x_dm_bwd": 1, "window_block_attention": 1, "window_block_mlp": 1,
        "window_attention": 1,
    }


@pytest.mark.parametrize(
    "ci,co,h,w,dil",
    [(8, 1, 7, 33, 1), (16, 8, 20, 64, 2), (32, 32, 9, 40, 4), (32, 16, 12, 70, 7), (8, 8, 3, 5, 1)],
)
def test_conv3d_dw_kernel_matches_plain(cuda, ci, co, h, w, dil):
    """Ragged H and W, depth dilation 7 > D = 5 (only the centre depth tap
    has planes); f32 sums in another order: within 1e-3·max|plain|, and the
    same bits on a second run (fixed-order reduction)."""
    x = _randn(cuda, 2, 5, ci, h, w)
    g = _randn(cuda, 2, 5, co, h, w, seed=1)
    got = cd.conv3d_dm_dw(x, g, (dil, 1, 1))
    want = cd.conv3d_dm_dw_reference(x, g, (dil, 1, 1))
    assert got.dtype == torch.float32 and got.shape == (3, 3, 3, ci, co)
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()
    assert torch.equal(got, cd.conv3d_dm_dw(x, g, (dil, 1, 1)))


@pytest.mark.parametrize("ci,co,h,w", [(8, 8, 5, 9), (16, 8, 12, 20), (32, 32, 8, 128), (32, 16, 3, 33)])
def test_convt_bwd_kernel_matches_plain(cuda, ci, co, h, w):
    """dx in bf16 within 2^-6·max|plain|; dW (f32) within 1e-3·max|plain|."""
    x = _randn(cuda, 2, 3, ci, h, w)
    g = _randn(cuda, 2, 3, co, 2 * h, 2 * w, seed=1)
    kern = _randn(cuda, 1, 2, 2, ci, co, seed=2, scale=ci**-0.5)
    dx, dw = ct.convt2x_dm_bwd(g, x, kern)
    want_dx, want_dw = ct.convt2x_dm_bwd_reference(g, x, kern)
    _close(dx, want_dx)
    assert dw.shape == want_dw.shape == (1, 2, 2, ci, co)
    assert (dw - want_dw).abs().max().item() <= 1e-3 * want_dw.abs().max().item()


def test_conv3d_kernel_takes_one_input_channel(cuda):
    """The input gradient of the mask head's 8 -> 1 conv is a 1 -> 8 conv:
    the forward kernel zero-fills the rest of its chunk of 8 channels."""
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


def test_cuda_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    """f32 CUDA tensors, head widths other than 64 and unsupported channel
    counts raise: nothing falls back to the plain versions on the GPU."""
    x32 = torch.zeros(1, 2, 8, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        cd.conv3d_dm(x32, torch.zeros(3, 3, 3, 8, 8, device=cuda))
    with pytest.raises(ValueError, match="Co in"):
        ct.convt2x_dm(x32.bfloat16(), torch.zeros(1, 2, 2, 8, 4, device=cuda))
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
    q = torch.zeros(1, 5, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q, torch.zeros(3, 64, device=cuda, dtype=torch.bfloat16), 2)
