"""The port's head-major attention, fused residual + LayerNorm and the DINOv2
options that reach them, against the JAX package.

Inputs and weights are drawn with numpy; on the CPU the port's wrappers run
their plain versions and the JAX side runs its Pallas kernels in interpret
mode.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import SMALL, randomize, to_torch

from cryovit_tpu.models.dinov2 import DinoV2 as JaxDinoV2
from cryovit_tpu.models.dinov2 import DinoV2Config as JaxDinoV2Config
from cryovit_tpu.models.dinov2 import make_dinov2 as jax_make_dinov2
from cryovit_tpu.ops import flash_attention as jfa
from cryovit_tpu.ops import fused_norm as jfn
from cryovit_tpu_torch.convert import dinov2_from_jax
from cryovit_tpu_torch.models.dinov2 import DinoV2Config, make_dinov2
from cryovit_tpu_torch.ops.flash_attention import flash_attention_bhnd, flash_attention_bnhd
from cryovit_tpu_torch.ops.fused_norm import residual_layernorm


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


# ---- flash_attention_bhnd / flash_attention_bnhd ----------------------------


@pytest.mark.parametrize("n", [64, 333])
def test_bhnd_matches_jax(rng, n):
    """f32 (B, H, N, D) = (2, 3, n, 64); atol 2e-5 as the JAX package's own
    kernel test: f32 reduction order only."""
    q, k, v = (rng.standard_normal((2, 3, n, 64)).astype(np.float32) for _ in range(3))
    want = np.asarray(jfa.flash_attention_bhnd(q, k, v, interpret=True))
    got = flash_attention_bhnd(_t(q), _t(k), _t(v))
    assert got.shape == (2, 3, n, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_bhnd_matches_jax_partial_final_block(rng):
    """The JAX kernel with a final query block that round_up(n, block_k)
    alone would drop (tests/test_dinov2.py's regression case); the port has
    no blocks, so it must match whatever blocks the JAX side takes."""
    q, k, v = (rng.standard_normal((1, 2, 300, 64)).astype(np.float32) for _ in range(3))
    want = np.asarray(jfa.flash_attention_bhnd(q, k, v, block_q=256, block_k=384, interpret=True))
    np.testing.assert_allclose(flash_attention_bhnd(_t(q), _t(k), _t(v)).numpy(), want,
                               atol=2e-5, rtol=0)


def test_bhnd_takes_permuted_views_of_one_projection(rng):
    """q, k, v as (B, H, N, D) views of one (B, N, 3, H, D) tensor, as the
    head-major Attention passes them; the result is a (B, H, N, D) view of
    (B, N, H, D) memory."""
    qkv = rng.standard_normal((2, 77, 3, 3, 64)).astype(np.float32)
    want = np.asarray(jfa.flash_attention_bhnd(
        *(np.ascontiguousarray(qkv[:, :, i].transpose(0, 2, 1, 3)) for i in range(3)),
        interpret=True,
    ))
    views = [_t(qkv)[:, :, i].transpose(1, 2) for i in range(3)]
    assert not views[0].is_contiguous()
    got = flash_attention_bhnd(*views)
    assert got.transpose(1, 2).is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("n", [64, 200])
def test_bnhd_matches_jax_flash_attention(rng, n):
    """(B, N, H, D) = (2, n, 3, 64) against the JAX ``flash_attention`` at
    dtype f32; atol 2e-5."""
    q, k, v = (rng.standard_normal((2, n, 3, 64)).astype(np.float32) for _ in range(3))
    want = np.asarray(jfa.flash_attention(q, k, v, block_q=128, block_k=128,
                                          dtype=jnp.float32, interpret=True))
    got = flash_attention_bnhd(_t(q), _t(k), _t(v), dtype=torch.float32)
    assert got.shape == (2, n, 3, 64) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


# ---- residual_layernorm -----------------------------------------------------


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_gamma", [True, False])
@pytest.mark.parametrize("y_dtype", ["float32", "bfloat16"])
def test_residual_layernorm_matches_jax(rng, x_dtype, with_gamma, y_dtype):
    """(2, 64, 256), h bf16, f32 affine. x' within 1e-5 (f32 x) or 2e-2 (bf16
    x, one bf16 ulp at |x'| ~ 4); y within 1e-4 in f32 and 5e-2 in bf16 (the
    JAX package's own tolerance for its kernel)."""
    b, n, c = 2, 64, 256
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    h = rng.standard_normal((b, n, c)).astype(np.float32)
    gamma = (0.1 * rng.standard_normal(c)).astype(np.float32) if with_gamma else None
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, x_dtype))
    jh = jnp.asarray(h, dtype=jnp.bfloat16)
    want_x, want_y = jfn.residual_layernorm(
        jx, jh, None if gamma is None else jnp.asarray(gamma), jnp.asarray(scale),
        jnp.asarray(bias), y_dtype=getattr(jnp, y_dtype), interpret=True,
    )
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, x_dtype))
    th = torch.from_numpy(np.array(jh.astype(jnp.float32))).bfloat16()
    got_x, got_y = residual_layernorm(
        tx, th, None if gamma is None else _t(gamma), _t(scale), _t(bias),
        y_dtype=getattr(torch, y_dtype),
    )
    assert got_x.dtype == tx.dtype and got_y.dtype == getattr(torch, y_dtype)
    np.testing.assert_allclose(got_x.float().numpy(), np.asarray(want_x, np.float32),
                               atol=1e-5 if x_dtype == "float32" else 2e-2, rtol=0)
    np.testing.assert_allclose(got_y.float().numpy(), np.asarray(want_y, np.float32),
                               atol=1e-4 if y_dtype == "float32" else 5e-2, rtol=0)


def test_residual_layernorm_statistics_come_from_the_f32_sum():
    """bf16 x whose f32 sum x + h is not a bf16 value: the mean and variance
    are those of the f32 sum (the Pallas kernel's), not of the rounded x'
    (eps 1e-12, below the spike's variance)."""
    x = torch.full((1, 1, 8), 1.0, dtype=torch.bfloat16)
    h = torch.tensor([[[2.0**-9, 0, 0, 0, 0, 0, 0, 0]]], dtype=torch.bfloat16)
    x_new, y = residual_layernorm(x, h, None, torch.ones(8), torch.zeros(8), eps=1e-12,
                                  y_dtype=torch.float32)
    assert torch.equal(x_new, x)  # 1 + 2^-9 rounds back to 1 in bf16
    assert y[0, 0, 0].item() > 2.6  # normalized spike, not 0 / sqrt(eps)


# ---- the model's options ----------------------------------------------------


def _port_and_variables(jmodel, x, rng, **options):
    variables = randomize(jmodel.init(jax.random.key(0), jnp.asarray(x)), rng)
    model = make_dinov2(to_torch(dinov2_from_jax(variables)), DinoV2Config(**SMALL),
                        device="cpu", dtype=options.pop("dtype", torch.float32), **options)
    return model, variables


def test_head_major_dinov2_matches_jax(rng):
    """``pair_heads=False`` at SMALL (2 blocks of 2 heads × 64), f32, against
    the JAX ``make_dinov2(pair_heads=False)`` through its interpret-mode
    ``flash_attention_bhnd``; atol 1e-4: reduction order only."""
    jmodel = jax_make_dinov2(JaxDinoV2Config(**SMALL), dtype=jnp.float32,
                             use_flash_attention=True, flash_interpret=True, pair_heads=False)
    x = rng.random((2, 56, 70)).astype(np.float32)
    model, variables = _port_and_variables(jmodel, x, rng, pair_heads=False)
    assert not model.blocks[0].attn.pair_heads and not model.fused_ln
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 20, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_fused_ln_dinov2_matches_jax(rng):
    """``fused_ln=True`` at SMALL, f32, against a JAX ``DinoV2`` on its
    production graph: pair-packed attention and the fused residual +
    LayerNorm, both Pallas in interpret mode (25 tokens pad to 32 there, so
    the fused kernel runs; the port does not pad). atol 1e-4."""
    jmodel = JaxDinoV2(
        cfg=JaxDinoV2Config(**SMALL), dtype=jnp.float32,
        pair_attention_fn=partial(jfa.flash_attention_pairs, interpret=True),
        fused_ln_fn=partial(jfn.residual_layernorm, interpret=True),
    )
    x = rng.random((2, 56, 70)).astype(np.float32)
    model, variables = _port_and_variables(jmodel, x, rng, fused_ln=True)
    assert model.fused_ln and model.blocks[0].attn.pair_heads
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("fused_ln", [False, True])
def test_f32_residual_stream_with_bf16_compute_matches_jax(rng, fused_ln):
    """bf16 compute with ``residual_dtype=torch.float32``, head-major, against
    the JAX ``make_dinov2`` with the same options. The stream entering each
    block is f32. Two bf16 implementations round at different places (the
    bias added by the projection or not, products re-associated), so the
    features (unit variance after the final norm; measured 0.027 apart) are
    held within 0.05 of JAX's, and their distance to the f32 model (0.021)
    within 1.25x that of the JAX bf16 run (0.023)."""
    cfg = JaxDinoV2Config(**SMALL)
    opts = dict(use_flash_attention=True, flash_interpret=True, pair_heads=False,
                fused_ln=fused_ln)
    jmodel = jax_make_dinov2(cfg, dtype=jnp.bfloat16, residual_dtype=jnp.float32, **opts)
    x = rng.random((2, 56, 70)).astype(np.float32)
    model, variables = _port_and_variables(jmodel, x, rng, pair_heads=False, fused_ln=fused_ln,
                                           dtype=torch.bfloat16, residual_dtype=torch.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)), np.float32)
    exact = np.asarray(jax_make_dinov2(cfg, dtype=jnp.float32, **opts).apply(
        variables, jnp.asarray(x)))
    seen = []
    hook = model.blocks[1].register_forward_pre_hook(lambda m, a: seen.append(a[0].dtype))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        if fused_ln:  # forward_fused is not a module call: check the stream directly
            tokens = torch.zeros(2, 25, 128, dtype=torch.float32)
            out, pending = model.blocks[0].forward_fused(tokens, torch.zeros_like(tokens))
            seen += [out.dtype, pending.dtype]
    hook.remove()
    assert seen and all(d == torch.float32 for d in seen), seen
    err, to_f32, jax_to_f32 = (np.abs(a - b).max() for a, b in
                               ((got, want), (got, exact), (want, exact)))
    assert err <= 0.05 and to_f32 <= 1.25 * jax_to_f32, (err, to_f32, jax_to_f32)
