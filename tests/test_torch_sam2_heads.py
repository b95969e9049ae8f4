"""The SAM2 heads and tracking: the port against the JAX package, f32, CPU.

On ``SAM2Config.tiny_test()``: the port's seeded initial weights moved by
seeded noise (so LoRA's zero B, LayerScale's 1e-6 and the object-score gate
do not hide anything) are taken into JAX's tree by the JAX package's
``convert_sam2_state_dict`` (flax's init of the tracking model takes half a
minute on the CPU) and back into the port by ``sam2_from_jax``:

- each module within 1e-4 × max|JAX| of its JAX counterpart:
  ``PromptEncoder`` (with and without a mask prompt), ``PromptPredictor``,
  ``MaskDecoder`` (LoRA rank 0 and 4), ``MemoryEncoder``,
  ``MemoryAttention`` (a masked bank with pointer tokens) and
  ``axial_rope`` (one grid and tiled over three slots);
- the aligned-corners resize matrix equal to the JAX package's;
- the tracking pass within atol 1e-4 of ``SAM2Model.apply`` (the bound of
  ``tests/test_sam2.py``'s python-loop oracle): live and cached backbone, a
  depth longer than ``num_maskmem`` (the ring wraps), several cond slices
  in a permuted order, and the order identity (natural order with one cond
  slice is the default call exactly).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cryovit_tpu.models.sam2.config import SAM2Config as JaxSAM2Config
from cryovit_tpu.models.sam2.convert import convert_sam2_state_dict
from cryovit_tpu.models.sam2.decoder import MaskDecoder as JaxMaskDecoder
from cryovit_tpu.models.sam2.memory import MemoryAttention as JaxMemoryAttention
from cryovit_tpu.models.sam2.memory import MemoryEncoder as JaxMemoryEncoder
from cryovit_tpu.models.sam2.memory import axial_rope as jax_axial_rope
from cryovit_tpu.models.sam2.model import SAM2Model as JaxSAM2Model
from cryovit_tpu.models.sam2.prompt_predictor import PromptPredictor as JaxPromptPredictor
from cryovit_tpu.models.sam2.prompts import PromptEncoder as JaxPromptEncoder
from cryovit_tpu.ops.resize import linear_resize_matrix as jax_linear_resize_matrix
from cryovit_tpu_torch.convert import sam2_from_jax
from cryovit_tpu_torch.models.sam2.config import SAM2Config
from cryovit_tpu_torch.models.sam2.family import make_sam2
from cryovit_tpu_torch.models.sam2.memory import axial_rope
from cryovit_tpu_torch.models.sam2.model import random_sam2_state_dict
from cryovit_tpu_torch.ops.resize import align_corners_resize_matrix

S = 64  # tiny_test's image size


def jax_variables(cfg, lora_rank: int, seed: int, obj_bias: float = 3.0):
    """(the port's state dict, JAX variables): the seeded init + N(0, 0.05²)
    on every tensor, the object-score head's last bias ``obj_bias`` (so the
    masks pass the gate), in JAX's tree by ``convert_sam2_state_dict``."""
    rng = np.random.default_rng(seed + 1)
    sd = random_sam2_state_dict(cfg, torch.Generator().manual_seed(seed), lora_rank,
                                float(max(lora_rank, 1)))
    sd = {k: v.numpy() + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
          for k, v in sd.items()}
    sd["model.sam_mask_decoder.pred_obj_score_head.layers.2.bias"][:] = obj_bias
    jcfg = dataclasses.replace(JaxSAM2Config.tiny_test(), max_cond_slices=cfg.max_cond_slices)
    params = convert_sam2_state_dict(sd, jcfg)["params"]["sam"]
    return sd, jax.tree_util.tree_map(jnp.asarray, {"params": params})


def build(cfg_kw=None, lora_rank=4, seed=0):
    """(JAX SAM2Model, its variables, the port's module)."""
    cfg = dataclasses.replace(SAM2Config.tiny_test(), **(cfg_kw or {}))
    jcfg = dataclasses.replace(JaxSAM2Config.tiny_test(), **(cfg_kw or {}))
    jm = JaxSAM2Model(cfg=jcfg, lora_rank=lora_rank, lora_alpha=float(max(lora_rank, 1)))
    sd, v = jax_variables(cfg, lora_rank, seed)
    back = sam2_from_jax(v)
    assert set(back) == set(sd)
    assert all(np.array_equal(back[k], sd[k]) for k in sd)  # the bridges invert each other
    port = make_sam2(back, cfg, "cpu", torch.float32, lora_rank, float(max(lora_rank, 1)))
    return jm, v, port


@pytest.fixture(scope="module")
def models():
    return {rank: build(lora_rank=rank) for rank in (0, 4)}


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def assert_close(got, want, rel=1e-4):
    """Within rel × max|want| (the module-parity bound)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=rel * float(np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("with_mask", [True, False])
def test_prompt_encoder_matches_jax(models, with_mask):
    jm, v, port = models[4]
    rng = np.random.default_rng(1)
    boxes = rng.random((3, 4)).astype(np.float32) * S
    s = jm.cfg.mask_input_size
    masks = rng.standard_normal((3, s, s, 1)).astype(np.float32) if with_mask else None
    pe = JaxPromptEncoder(jm.cfg)
    pv = {"params": v["params"]["prompt_encoder"]}
    sparse, dense = pe.apply(pv, jnp.asarray(boxes), None if masks is None else jnp.asarray(masks))
    got_s, got_d = port.model.sam_prompt_encoder(_t(boxes), None if masks is None else _t(masks))
    assert_close(got_s, sparse)
    assert_close(got_d, dense)
    assert_close(port.model.sam_prompt_encoder.dense_pe(), pe.apply(pv, method=pe.dense_pe))


def test_prompt_predictor_matches_jax(models):
    _, v, port = models[4]
    feats = np.random.default_rng(2).standard_normal((1, 5, 16, 16, 32)).astype(np.float32)
    boxes, prompts = JaxPromptPredictor(in_channels=32).apply(
        {"params": v["params"]["prompt_predictor"]}, jnp.asarray(feats))
    got_b, got_p = port.prompt_predictor(_t(feats))
    assert_close(got_b, boxes)
    assert_close(got_p, prompts)


@pytest.mark.parametrize("rank", [0, 4])
def test_mask_decoder_matches_jax(models, rank):
    jm, v, port = models[rank]
    cfg = jm.cfg
    e, d = cfg.embed_size, cfg.d_model
    rng = np.random.default_rng(3)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    args = (r(2, e, e, d), r(e, e, d), r(2, 3, d), r(2, e, e, d))
    high = (r(2, 4 * e, 4 * e, d), r(2, 2 * e, 2 * e, d))
    want = JaxMaskDecoder(cfg, lora_rank=rank, lora_alpha=float(max(rank, 1))).apply(
        {"params": v["params"]["mask_decoder"]}, *map(jnp.asarray, args),
        tuple(map(jnp.asarray, high)))
    got = port.model.sam_mask_decoder(*map(_t, args), tuple(map(_t, high)))
    for g, w in zip(got, want):
        assert_close(g, w)


def test_memory_encoder_matches_jax(models):
    jm, v, port = models[4]
    cfg = jm.cfg
    rng = np.random.default_rng(4)
    pix = rng.standard_normal((2, cfg.embed_size, cfg.embed_size, cfg.d_model)).astype(np.float32)
    masks = rng.standard_normal((2, S, S, 1)).astype(np.float32) * 3
    want = JaxMemoryEncoder(cfg).apply({"params": v["params"]["memory_encoder"]},
                                       jnp.asarray(pix), jnp.asarray(masks))
    assert_close(port.model.memory_encoder(_t(pix), _t(masks)), want)


def test_memory_attention_matches_jax(models):
    """Two spatial slots and 8 pointer tokens, one slot and two pointer
    tokens masked out; RoPE on the spatial tokens only."""
    jm, v, port = models[4]
    cfg = jm.cfg
    e2 = cfg.embed_size**2
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, cfg.embed_size, cfg.embed_size, cfg.d_model)).astype(np.float32)
    pos = rng.standard_normal((1, cfg.embed_size, cfg.embed_size, cfg.d_model)).astype(np.float32)
    m = 2 * e2 + 8
    mem = rng.standard_normal((2, m, cfg.mem_dim)).astype(np.float32)
    mem_pos = rng.standard_normal((2, m, cfg.mem_dim)).astype(np.float32)
    mask = np.ones((2, m), bool)
    mask[0, e2 : 2 * e2] = False
    mask[1, -2:] = False
    want = JaxMemoryAttention(cfg).apply(
        {"params": v["params"]["memory_attention"]}, jnp.asarray(feats), jnp.asarray(pos),
        jnp.asarray(mem), jnp.asarray(mem_pos), jnp.asarray(mask), 2 * e2)
    got = port.model.memory_attention(_t(feats), _t(pos), _t(mem), _t(mem_pos),
                                      torch.from_numpy(mask), 2 * e2)
    assert_close(got, want)


@pytest.mark.parametrize("repeat", [1, 3])
def test_axial_rope_matches_jax(repeat):
    x = np.random.default_rng(6).standard_normal((2, repeat * 16, 2, 8)).astype(np.float32)
    assert_close(axial_rope(_t(x), (4, 4), repeat), jax_axial_rope(jnp.asarray(x), (4, 4), repeat))


@pytest.mark.parametrize("sizes", [(4, 8), (8, 16), (16, 64), (5, 5), (7, 3)])
def test_align_corners_resize_matrix_matches_jax(sizes):
    np.testing.assert_allclose(align_corners_resize_matrix(*sizes),
                               jax_linear_resize_matrix(*sizes, align_corners=True), atol=1e-7)


def _track(jm, v, port, x, order=None, num_cond=None, backbone=None):
    """(port, JAX) outputs of one tracking pass; JAX's is jitted (one XLA
    compile per shape is quicker on the CPU than the eager scan)."""
    jo = None if order is None else jnp.asarray(order)
    jb = None if backbone is None else jax.tree_util.tree_map(jnp.asarray, backbone)
    jn = None if num_cond is None else jnp.asarray(num_cond)
    want = jax.jit(jm.apply)(v, jnp.asarray(x), jb, order=jo, num_cond=jn)
    tb = None if backbone is None else {k: [_t(a) for a in val] for k, val in backbone.items()}
    with torch.no_grad():
        got = port(_t(x)[..., None], tb, order=order, num_cond=num_cond)
    return got, want


@pytest.mark.parametrize("case", ["live", "ring_wrap", "multi_cond"])
def test_tracking_matches_jax(models, case):
    """The tracking pass's probabilities and prompts within atol 1e-4."""
    if case == "multi_cond":
        jm, v, port = build({"max_cond_slices": 3}, seed=7)
    else:
        jm, v, port = models[4]
    depth = {"live": 4, "ring_wrap": 7, "multi_cond": 6}[case]
    x = np.random.default_rng(8).random((1, depth, S, S)).astype(np.float32)
    order, num_cond = ([0, 3, 5, 1, 2, 4], 3) if case == "multi_cond" else (None, None)
    got, want = _track(jm, v, port, x, order, num_cond)
    np.testing.assert_allclose(got["preds"].numpy()[..., :, :], np.asarray(want["preds"]), atol=1e-4)
    np.testing.assert_allclose(got["prompts"].numpy(), np.asarray(jax.nn.sigmoid(want["prompts"])),
                               atol=1e-4)
    preds = np.asarray(want["preds"])
    assert preds.max() - preds.min() > 0.1, "the gate hid the masks"


def test_tracking_cached_backbone_matches_jax(models):
    """A cached pyramid (as ``sam_features`` files hold) in place of the
    live encoder."""
    jm, v, port = models[4]
    rng = np.random.default_rng(9)
    d, dm = 4, jm.cfg.d_model
    levels = [(16, 16), (8, 8), (4, 4)]
    backbone = {k: [rng.standard_normal((d, h, w, dm)).astype(np.float32) for h, w in levels]
                for k in ("backbone_fpn", "vision_pos_enc")}
    x = rng.random((1, d, S, S)).astype(np.float32)
    got, want = _track(jm, v, port, x, backbone=backbone)
    np.testing.assert_allclose(got["preds"].numpy(), np.asarray(want["preds"]), atol=1e-4)


def test_tracking_order_identity(models):
    """Natural order with one cond slice is the default call exactly; a
    permuted order keeps the slices in place and still matches JAX."""
    jm, v, port = models[4]
    x = np.random.default_rng(8).random((1, 4, S, S)).astype(np.float32)
    with torch.no_grad():
        base = port(_t(x)[..., None])["preds"]
        same = port(_t(x)[..., None], order=[0, 1, 2, 3], num_cond=1)["preds"]
    assert torch.equal(base, same)
    got, want = _track(jm, v, port, x, [0, 2, 1, 3], 1)
    np.testing.assert_allclose(got["preds"].numpy(), np.asarray(want["preds"]), atol=1e-4)
