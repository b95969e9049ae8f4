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

from cryovit_tpu.ops.conv3d_dm import conv3d_dm as jax_conv3d_dm
from cryovit_tpu.ops.convt_dm import convt2x_dm as jax_convt2x_dm
from cryovit_tpu.ops.flash_attention import flash_attention_pairs
from cryovit_tpu_torch.ops.conv3d_dm import conv3d_dm
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


def test_convt2x_dm_matches_pallas_kernel(rng):
    """bf16 in and out, compared in f32 with rtol 1e-2 (bf16 rounding)."""
    x = rng.standard_normal((2, 3, 8, 4, 128)).astype(np.float32)
    kern = rng.standard_normal((1, 2, 2, 8, 8)).astype(np.float32) * 0.3
    want = jax_convt2x_dm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(kern, jnp.bfloat16), interpret=True
    )
    got = convt2x_dm(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(kern).to(torch.bfloat16)
    )
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 8, 8, 256)
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
