"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper in ``cryovit_tpu_torch.ops`` runs its plain PyTorch
version; the JAX side runs the Pallas kernel in interpret mode, as the JAX
package's own tests do. Inputs come from a seeded numpy generator and go to
both packages unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cryovit_tpu.ops.conv3d_dm import conv3d_dm as jax_conv3d_dm
from cryovit_tpu.ops.convt_dm import convt2x_dm as jax_convt2x_dm
from cryovit_tpu.ops.flash_attention import flash_attention_pairs
from cryovit_tpu_torch.ops.conv3d_dm import conv3d_dm, conv3d_dm_reference, pack_weights
from cryovit_tpu_torch.ops.convt_dm import convt2x_dm
from cryovit_tpu_torch.ops.flash_attention import flash_attention
from cryovit_tpu_torch.ops.resize import bicubic_resize_matrix, resize_bicubic_2d


@pytest.mark.parametrize("true_len", [None, 30])
def test_attention_matches_pallas_pairs_kernel(rng, true_len):
    """f32, N = 37 (not a multiple of 16), 4 heads of 64; atol 1e-5: the two
    differ only in reduction order."""
    b, n, heads, d = 2, 37, 4, 64
    c = heads * d
    q, k, v = (rng.standard_normal((b, n, c)).astype(np.float32) for _ in range(3))
    q *= d**-0.5  # pre-scaled, as the JAX model folds the scale into its q weights
    bias = (0.5 * rng.standard_normal((3, c))).astype(np.float32)
    want = flash_attention_pairs(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        channel_major=True, kv_bias=jnp.asarray(bias.reshape(3, heads // 2, 2 * d)),
        true_len=true_len, pre_scaled=True, interpret=True,
    )
    got = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bias), heads, true_len=true_len, scale=1.0,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_attention_takes_views_of_a_fused_projection(rng):
    """q/k/v as column views of one (B, N, 3C) tensor give the same result as
    contiguous copies."""
    b, n, heads, d = 1, 21, 2, 64
    c = heads * d
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * c)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal((3, c)).astype(np.float32))
    views = qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :]
    copies = [t.contiguous() for t in views]
    torch.testing.assert_close(
        flash_attention(*views, bias, heads), flash_attention(*copies, bias, heads)
    )


@pytest.mark.parametrize("dil", [1, 2, 4])
def test_conv3d_dm_matches_pallas_kernel(rng, dil):
    """f32, Co = 1 (the mask head's shape), depth dilation only; atol 1e-4:
    reduction order only."""
    x = rng.standard_normal((1, 5, 8, 6, 128)).astype(np.float32)
    kern = rng.standard_normal((3, 3, 3, 8, 1)).astype(np.float32) * 0.2
    want = jax_conv3d_dm(jnp.asarray(x), jnp.asarray(kern), (dil, 1, 1), interpret=True)
    got = conv3d_dm(torch.from_numpy(x), torch.from_numpy(kern), (dil, 1, 1))
    assert got.shape == (1, 5, 1, 6, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _conv_from_packed(x, packed, co, dil):
    """The CUDA conv kernel's arithmetic on ``pack_weights``' layout, in
    plain torch: for each column group and kh, the 16 k-channels the
    kernel's A fragments hold (shifted windows of the zero-padded x) times
    the group's 16 × 8·NT B fragment, unpacked from the lanes' registers."""
    b, d, ci, h, w = x.shape
    nt = -(-co // 8)
    xp = F.pad(x, (1, 1, 1, 1, 0, 0, dil, dil))  # pads W, H, (not C), D

    def shifted(kd, kh, kw):  # (B, D, Ci, H, W): tap (kd, kh, kw) of every output voxel
        return xp[:, kd * dil : kd * dil + d, :, kh : kh + h, kw : kw + w]

    zeros = torch.zeros(b, d, 8, h, w)
    if ci == 1:  # a group per depth tap; k = the 9 lateral taps and 7 zeros
        groups = [[torch.cat([shifted(kd, t // 3, t % 3) for t in range(9)] + [zeros[:, :, :7]], 2)]
                  for kd in range(3)]
    elif ci == 8:  # pairs of (kd, kw), 8 channels each; the tenth is zero
        def half(c, kh):
            return shifted(c // 3, kh, c % 3) if c < 9 else zeros
        groups = [[torch.cat([half(2 * p, kh), half(2 * p + 1, kh)], 2) for kh in range(3)]
                  for p in range(5)]
    else:  # (kd, kw, 16 channels), Ci padded to a multiple of 16
        cip = -(-ci // 16) * 16
        groups = [[F.pad(shifted(kd, kh, kw), (0, 0, 0, 0, 0, cip - ci))[:, :, ks : ks + 16]
                   for kh in range(3)]
                  for kd in range(3) for kw in range(3) for ks in range(0, cip, 16)]
    # lane g·4 + q of n-tile t holds B[2q + h, 8t + g] and B[8 + 2q + h, 8t + g]
    frags = packed.float().reshape(len(groups), len(groups[0]), nt, 8, 4, 2, 2)
    bmat = frags.permute(0, 1, 5, 4, 6, 2, 3).reshape(len(groups), len(groups[0]), 16, 8 * nt)
    y = sum(torch.einsum("bdkhw,kn->bdnhw", a, bmat[g, kh])
            for g, group in enumerate(groups) for kh, a in enumerate(group))
    return y[:, :, :co]


@pytest.mark.parametrize(
    "ci,co,dil", [(1, 8, 1), (8, 1, 2), (8, 8, 1), (16, 1, 6), (16, 32, 2), (24, 16, 1), (32, 32, 4)]
)
def test_packed_conv_weights_give_the_plain_conv(rng, ci, co, dil):
    """``pack_weights`` lays the weights out as the CUDA kernel's mma B
    fragments (per column group, kh and n-tile; Ci = 1 with the lateral taps
    as k, Ci = 8 with two (kd, kw) per k16): contracting that layout the way
    the kernel does gives ``conv3d_dm_reference``'s result. f32, atol 1e-5:
    reduction order only."""
    x = torch.from_numpy(rng.standard_normal((2, 5, ci, 6, 10)).astype(np.float32))
    kern = rng.standard_normal((3, 3, 3, ci, co)).astype(np.float32) * (27 * ci) ** -0.5
    kern = torch.from_numpy(kern)
    packed = pack_weights(kern)
    assert packed.dtype == kern.dtype and packed.dim() == 1
    got = _conv_from_packed(x, packed, co, dil)
    torch.testing.assert_close(got, conv3d_dm_reference(x, kern, (dil, 1, 1)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("ci,co", [(8, 8), (32, 32), (16, 8)])
def test_convt2x_dm_matches_pallas_kernel(rng, ci, co):
    """bf16 in and out, compared in f32 with rtol 1e-2 (bf16 rounding); the
    decoder's two ConvTransposes (32 -> 32, 16 -> 8) and 8 -> 8, W = 128."""
    x = rng.standard_normal((2, 3, ci, 4, 128)).astype(np.float32)
    kern = rng.standard_normal((1, 2, 2, ci, co)).astype(np.float32) * 0.3
    want = jax_convt2x_dm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(kern, jnp.bfloat16), interpret=True
    )
    got = convt2x_dm(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(kern).to(torch.bfloat16)
    )
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, co, 8, 256)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want).astype(np.float32), rtol=1e-2, atol=1e-2
    )


@pytest.mark.parametrize("size", [(32, 28), (48, 42), (128, 112)])
def test_bicubic_resize_matches_jax_and_torch(rng, size):
    """The numpy resize matrices carried over from the JAX package reproduce
    torch's bicubic interpolate (A = -0.75, half-pixel, clamped); atol 5e-5
    for f32 sums of 16 weighted taps taken in another order."""
    from cryovit_tpu.ops.resize import bicubic_resize_matrix as jax_matrix

    n_in, n_out = size
    np.testing.assert_array_equal(bicubic_resize_matrix(n_in, n_out), jax_matrix(n_in, n_out))
    x = torch.from_numpy(rng.random((2, n_in, n_in)).astype(np.float32))
    want = torch.nn.functional.interpolate(
        x[:, None], size=(n_out, n_out), mode="bicubic", align_corners=False
    )[:, 0]
    torch.testing.assert_close(resize_bicubic_2d(x, n_out, n_out), want, atol=5e-5, rtol=0)
