"""SAM2's cached memory attention (``SAM2Model(kv_cache=True)``) against the
uncached path and the JAX package's cached path, f32, on the CPU.

On ``SAM2Config.tiny_test()`` with seeded weights moved by seeded noise
(``test_torch_sam2_heads.build``):

- ``MemoryAttention.project_memory`` / ``project_ptr`` / ``cached`` (two
  layers, two spatial slots of different recency, two pointers) within
  1e-4 × max|JAX| of the JAX package's, and of the port's own uncached
  ``forward`` on the same bank;
- the tracking pass with ``max_cond_slices=2``, depth 6, order
  ``[0, 3, 1, 2, 4, 5]`` and two cond slices (``tests/test_sam2.py``'s
  ``test_tracking_kv_cache_matches_uncached``): cached against uncached and
  against JAX ``SAM2Model(kv_cache=True)``, probabilities and prompts within
  atol 1e-4; cached against uncached again where the ring wraps;
- one backward pass: the gradient of every trained leaf (the ``train`` and
  ``prompt`` groups) cached against uncached, within 1e-4 × the leaf's
  max|gradient|;
- the cache is off by default.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cryovit_tpu.models.sam2.config import SAM2Config as JaxSAM2Config
from cryovit_tpu.models.sam2.convert import convert_sam2_state_dict
from cryovit_tpu.models.sam2.memory import MemoryAttention as JaxMemoryAttention
from cryovit_tpu.models.sam2.model import SAM2Model as JaxSAM2Model
from cryovit_tpu_torch.models.sam2.config import SAM2Config
from cryovit_tpu_torch.models.sam2.family import make_sam2, param_group
from cryovit_tpu_torch.models.sam2.encoder import sine_position_encoding
from cryovit_tpu_torch.models.sam2.model import MemoryBank, SAM2Model, random_sam2_state_dict

from test_torch_sam2_heads import S, _t, assert_close, build

ORDER, NUM_COND = [0, 3, 1, 2, 4, 5], 2


@pytest.fixture(scope="module")
def two_cond():
    return build({"max_cond_slices": 2}, seed=3)


def _run(port, x, kv_cache, order=ORDER, num_cond=NUM_COND):
    port.kv_cache = kv_cache
    try:
        return port(_t(x)[..., None], order=order, num_cond=num_cond)
    finally:
        port.kv_cache = False


def _two_layer_model():
    """The port's tiny_test model with two memory-attention layers, its
    seeded weights moved by N(0, 0.05²), and the same weights in JAX's tree."""
    kw = {"memory_attention_layers": 2}
    cfg = dataclasses.replace(SAM2Config.tiny_test(), **kw)
    rng = np.random.default_rng(5)
    sd = random_sam2_state_dict(cfg, torch.Generator().manual_seed(5), 4, 4.0)
    sd = {k: t.numpy() + 0.05 * rng.standard_normal(t.shape).astype(np.float32)
          for k, t in sd.items()}
    params = convert_sam2_state_dict(sd, dataclasses.replace(JaxSAM2Config.tiny_test(), **kw))
    v = jax.tree_util.tree_map(jnp.asarray, {"params": params["params"]["sam"]})
    return v, make_sam2(sd, cfg, "cpu", lora_rank=4, lora_alpha=4.0)


def test_memory_attention_cached_matches_jax_and_uncached():
    v, port = _two_layer_model()
    cfg, ma = port.cfg, port.model.memory_attention
    assert len(ma.layers) == 2
    e, md = cfg.embed_size, cfg.mem_dim
    ratio = cfg.d_model // md
    rng = np.random.default_rng(12)
    feats = rng.standard_normal((1, e, e, cfg.d_model)).astype(np.float32)
    pos = rng.standard_normal((1, e, e, cfg.d_model)).astype(np.float32)
    slots = [rng.standard_normal((1, e * e, md)).astype(np.float32) for _ in range(2)]
    ptrs = [rng.standard_normal((1, ratio, md)).astype(np.float32) for _ in range(2)]
    recency = [cfg.num_maskmem - 1, 0]
    tpos = v["params"]["maskmem_tpos_enc"]  # (num_maskmem, mem_dim)
    ptr_pe = rng.standard_normal((2, md)).astype(np.float32)

    jma = JaxMemoryAttention(dataclasses.replace(JaxSAM2Config.tiny_test(),
                                                 memory_attention_layers=2))
    params = {"params": v["params"]["memory_attention"]}
    jk, jv = zip(*(jma.apply(params, jnp.asarray(m), method=JaxMemoryAttention.project_memory)
                   for m in slots))
    jkp, jvp = zip(*(jma.apply(params, jnp.asarray(p), method=JaxMemoryAttention.project_ptr)
                     for p in ptrs))
    mask = jnp.ones((1, 2 * e * e + 2 * ratio), bool)
    want = jma.apply(params, jnp.asarray(feats), jnp.asarray(pos), jnp.stack(jk, 1),
                     jnp.stack(jv, 1), jnp.stack(jkp, 1), jnp.stack(jvp, 1),
                     jnp.asarray(recency), tpos, jnp.asarray(ptr_pe), mask,
                     method=JaxMemoryAttention.cached)

    with torch.no_grad():
        k, vv = zip(*(ma.project_memory(_t(m)) for m in slots))
        kp, vp = zip(*(ma.project_ptr(_t(p)) for p in ptrs))
        for got, ref in zip((k, vv, kp, vp), (jk, jv, jkp, jvp)):
            for g, r in zip(got, ref):
                assert_close(g, r)
        grid = torch.from_numpy(sine_position_encoding(e, e, md).copy()).reshape(e * e, md)
        tpos_t = _t(tpos)
        static = ma.static_keys(grid, tpos_t)
        got = ma.cached(_t(feats), _t(pos), torch.stack(k, 1), torch.stack(vv, 1),
                        torch.stack(kp, 1), torch.stack(vp, 1), recency, _t(ptr_pe), static)
        assert_close(got, want)
        # the uncached path on the same bank: positions added to the tokens
        tokens = torch.cat([_t(m) for m in slots] + [_t(p) for p in ptrs], dim=1)
        mem_pos = torch.cat([grid + tpos_t[r] for r in recency]
                            + [_t(ptr_pe[i]).expand(ratio, md) for i in range(2)])[None]
        plain = ma(_t(feats), _t(pos), tokens, mem_pos, None, 2 * e * e)
    assert_close(got, plain.numpy())


def test_cached_tracking_matches_uncached_and_jax(two_cond):
    jm, v, port = two_cond
    x = np.random.default_rng(4).random((1, 6, S, S)).astype(np.float32)
    with torch.no_grad():
        plain, cached = _run(port, x, False), _run(port, x, True)
    cached_jax = JaxSAM2Model(cfg=jm.cfg, lora_rank=jm.lora_rank, lora_alpha=jm.lora_alpha,
                              kv_cache=True)
    want = jax.jit(cached_jax.apply)(v, jnp.asarray(x), order=jnp.asarray(ORDER),
                                     num_cond=jnp.asarray(NUM_COND))
    for key in ("preds", "prompts"):
        np.testing.assert_allclose(cached[key].numpy(), plain[key].numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(cached["preds"].numpy(), np.asarray(want["preds"]), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(cached["prompts"].numpy(),
                               np.asarray(jax.nn.sigmoid(want["prompts"])), atol=1e-4, rtol=0)
    assert np.ptp(np.asarray(want["preds"])) > 0.1, "the gate hid the masks"


def test_cached_tracking_matches_uncached_where_the_ring_wraps(two_cond):
    _, _, port = two_cond
    x = np.random.default_rng(5).random((1, 9, S, S)).astype(np.float32)
    with torch.no_grad():
        plain, cached = _run(port, x, False, None, None), _run(port, x, True, None, None)
    np.testing.assert_allclose(cached["preds"].numpy(), plain["preds"].numpy(), atol=1e-4,
                               rtol=0)


def test_cached_gradients_match_uncached(two_cond):
    _, _, port = two_cond
    rng = np.random.default_rng(6)
    x = rng.random((1, 6, S, S)).astype(np.float32)
    label = torch.from_numpy((rng.random((1, 6, S, S)) > 0.5).astype(np.float32))
    trained = {n: p for n, p in port.named_parameters() if p.requires_grad}
    assert {param_group(n) for n in trained} == {"train", "prompt"}

    def grads(kv_cache):
        port.zero_grad(set_to_none=True)
        out = _run(port, x, kv_cache)
        loss = ((out["preds"] - label) ** 2).mean() + ((out["prompts"] - label) ** 2).mean()
        loss.backward()
        return {n: p.grad.clone() for n, p in trained.items() if p.grad is not None}

    plain, cached = grads(False), grads(True)
    assert set(plain) == set(cached) and len(plain) > 10
    assert any(n.startswith("model.sam_mask_decoder") and g.abs().max() > 0
               for n, g in plain.items()), "no gradient reached the LoRA factors"
    for name, g in plain.items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(cached[name].numpy(), g.numpy(), atol=1e-4 * scale + 1e-12,
                                   rtol=0, err_msg=name)
    port.zero_grad(set_to_none=True)


def test_kv_cache_is_off_by_default():
    cfg = SAM2Config.tiny_test()
    assert SAM2Model(cfg).kv_cache is False
    bank = MemoryBank.empty(cfg)
    assert bank.k_sp is None and bank.v_pt is None
    cached = MemoryBank.empty(cfg, kv_cache=True)
    n = cfg.max_cond_slices + cfg.num_maskmem - 1
    assert cached.k_sp == cached.v_sp == [None] * n
    assert cached.k_pt == cached.v_pt == [None] * cfg.max_obj_ptrs
    sd = random_sam2_state_dict(cfg, torch.Generator().manual_seed(0), 4, 4.0)
    assert make_sam2(sd, cfg, "cpu", lora_rank=4, lora_alpha=4.0).kv_cache is False
    assert make_sam2(sd, cfg, "cpu", lora_rank=4, lora_alpha=4.0, kv_cache=True).kv_cache
