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
    assert kernels.launch_counts() == {"flash_attention": 0, "conv3d_dm": 1, "convt2x_dm": 2}


def test_cuda_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    """f32 CUDA tensors, head widths other than 64 and unsupported channel
    counts raise: nothing falls back to the plain versions on the GPU."""
    x32 = torch.zeros(1, 2, 8, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        cd.conv3d_dm(x32, torch.zeros(3, 3, 3, 8, 8, device=cuda))
    with pytest.raises(ValueError, match="Co in"):
        ct.convt2x_dm(x32.bfloat16(), torch.zeros(1, 2, 2, 8, 4, device=cuda))
    q = torch.zeros(1, 5, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q, torch.zeros(3, 64, device=cuda, dtype=torch.bfloat16), 2)
