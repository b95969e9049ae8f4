"""The port's SAM2 image encoder against the JAX package.

Weights are drawn with numpy, loaded into the JAX modules as they are and
into the port through ``cryovit_tpu_torch.convert.sam2_encoder_from_jax``;
inputs are numpy too. On the CPU the port's kernel wrappers run their plain
versions; the JAX side runs its Pallas kernels in interpret mode. Configs are
small (widths 8–144) so that the whole file stays well under a minute.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cryovit_tpu.models.sam2.config import HieraConfig as JaxHieraConfig
from cryovit_tpu.models.sam2.config import SAM2Config as JaxSAM2Config
from cryovit_tpu.models.sam2.convert import convert_encoder_state_dict
from cryovit_tpu.models.sam2.encoder import ImageEncoder as JaxImageEncoder
from cryovit_tpu.models.sam2.hiera import LOG2E, _qkv_pack_cols
from cryovit_tpu.models.sam2.hiera import Hiera as JaxHiera
from cryovit_tpu.ops import window_attention as jwa
from cryovit_tpu.run.sam_features import SamFeatureExtractor as JaxSamFeatureExtractor
from cryovit_tpu_torch.convert import sam2_encoder_from_jax, sam2_encoder_from_published
from cryovit_tpu_torch.io import write_mrc
from cryovit_tpu_torch.models.sam2 import hiera as port_hiera
from cryovit_tpu_torch.models.sam2.config import HieraConfig, SAM2Config
from cryovit_tpu_torch.models.sam2.encoder import (
    fold_rgb_patch_embed,
    make_image_encoder,
    random_encoder_state_dict,
)
from cryovit_tpu_torch.ops import window_attention as wa
from cryovit_tpu_torch.run.sam_features import (
    SAM2_CHECKPOINT,
    SamFeatureExtractor,
    make_sam_encoder_state,
    run_sam,
)

bf16 = torch.bfloat16

# the two configs of tests/test_sam2.py that open the JAX kernel gates on a
# 128² input (a 32×32 stage-1 grid): the fused window block (window 16, 256
# tokens) and the global attention kernel (block 1 global, 1024 tokens)
GATE_CONFIGS = {
    "window_block": dict(embed_dim=8, num_heads=1, stages=(2, 1, 1, 1),
                         window_spec=(16, 4, 4, 2), global_att_blocks=(4,)),
    "global": dict(embed_dim=8, num_heads=1, stages=(2, 1, 1, 1),
                   window_spec=(4, 4, 4, 2), global_att_blocks=(1,)),
    # head width 96 (Hiera-T's global blocks: 4 heads of 96)
    "global_96": dict(embed_dim=96, num_heads=1, stages=(2, 1, 1, 1),
                      window_spec=(4, 4, 4, 2), global_att_blocks=(1,)),
}
GATE_CALLS = {"window_block": (2, 2, 0), "global": (0, 0, 1), "global_96": (0, 0, 1)}  # per forward
# no gate: a window (3) that does not tile the 32×32 grid (zero-padded per
# block) and a run of two windowed blocks in stage 2 (window-persistent)
HIERA_CONFIGS = {**GATE_CONFIGS, "padded": dict(embed_dim=8, num_heads=1, stages=(2, 3, 2, 1),
                                                window_spec=(3, 2, 2, 2), global_att_blocks=())}


def randomize(variables, rng):
    """Every leaf redrawn with numpy: kernels ~ N(0, 1/fan_in), norm scales
    ~ 1 + N(0, 0.1²), biases and position embeddings ~ N(0, 0.1²)."""

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(x)
        if name == "kernel":
            return rng.standard_normal(shape).astype(np.float32) / np.sqrt(np.prod(shape[:-1]))
        noise = 0.1 * rng.standard_normal(shape).astype(np.float32)
        return noise + 1.0 if name == "scale" else noise

    return jax.tree_util.tree_map_with_path(leaf, variables)


def to_torch(sd, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v)).to(dtype) for k, v in sd.items()}


def assert_close_bf16(got, want):
    """The JAX package's tolerance between its kernel and XLA paths in bf16
    (``tests/test_sam2.py``): cosine > 0.9999 and max |diff| < 0.1."""
    a = np.asarray(got, dtype=np.float64).ravel()
    b = np.asarray(want, dtype=np.float64).ravel()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
    assert cos > 0.9999, cos
    assert np.abs(a - b).max() < 0.1, np.abs(a - b).max()


def _bf16(rng, *shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # bf16-exact


# ---- the three plain versions against the Pallas kernels ---------------------


def _block_weights(rng, c, heads):
    """Unpadded block weights in flax layout (in, out), bf16-exact."""
    return dict(
        g=1.0 + 0.1 * rng.standard_normal(c).astype(np.float32),
        b=0.1 * rng.standard_normal(c).astype(np.float32),
        kq=_bf16(rng, c, 3 * c, scale=c**-0.5), bq=_bf16(rng, 3 * c, scale=0.1),
        kp=_bf16(rng, c, c, scale=c**-0.5), bp=_bf16(rng, c, scale=0.1),
        k1=_bf16(rng, c, 4 * c, scale=c**-0.5), b1=_bf16(rng, 4 * c, scale=0.1),
        k2=_bf16(rng, 4 * c, c, scale=(4 * c) ** -0.5), b2=_bf16(rng, c, scale=0.1),
    )


def _jax_packed_attention_weights(w, heads, d):
    """The head-padded packing of ``hiera.MultiScaleBlock._fused_window_block``:
    scale·log2(e) folded into the q third, a ones column at lane d of every v
    head, the proj row-packed."""
    c, hd = w["kq"].shape[0], heads * d
    cols, ones_cols = _qkv_pack_cols(heads, d)
    scale = d**-0.5 * LOG2E
    kq = np.concatenate([w["kq"][:, :hd] * scale, w["kq"][:, hd:]], axis=1)
    wq = np.zeros((c, 3 * heads * 128), np.float32)
    wq[:, cols] = kq
    bq = np.concatenate([w["bq"][:hd] * scale, w["bq"][hd:]])
    bq_p = np.zeros(3 * heads * 128, np.float32)
    bq_p[cols] = bq
    bq_p[ones_cols] = 1.0
    rows = (np.arange(hd) // d) * 128 + np.arange(hd) % d
    wp = np.zeros((heads * 128, c), np.float32)
    wp[rows] = w["kp"]
    return wq, bq_p[None], wp


def test_window_block_attention_plain_matches_pallas(rng):
    """Two windows of 128 tokens, 2 heads of 72 (C = 144); both sides fold
    scale·log2(e) into the f32 q weights before the cast to bf16."""
    heads, d, n, t = 2, 72, 2, 128
    c = heads * d
    w = _block_weights(rng, c, heads)
    x = _bf16(rng, n, t, c)
    wq, bq_p, wp = _jax_packed_attention_weights(w, heads, d)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(np.array(a)).to(bf16)  # noqa: E731
    want = jwa.window_block_attention(
        jb(x), jnp.asarray(w["g"])[None], jnp.asarray(w["b"])[None], jb(wq), jb(bq_p), jb(wp),
        jb(w["bp"])[None], heads=heads, head_dim=d, interpret=True,
    )
    w_qkv, b_qkv = wa.fold_q_scale(torch.from_numpy(w["kq"].T), torch.from_numpy(w["bq"]), heads)
    got = wa.window_block_attention(
        tb(x), torch.from_numpy(w["g"]), torch.from_numpy(w["b"]), w_qkv.to(bf16),
        b_qkv.to(bf16), tb(w["kp"].T), tb(w["bp"]), heads,
    )
    assert got.dtype == bf16 and got.shape == (n, t, c)
    assert_close_bf16(got.float(), np.asarray(want, np.float32))


def test_window_block_mlp_plain_matches_pallas(rng):
    """Two windows of 128 tokens, C = 144, hidden 576."""
    c, n, t = 144, 2, 128
    w = _block_weights(rng, c, 2)
    x = _bf16(rng, n, t, c)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = jwa.window_block_mlp(
        jb(x), jnp.asarray(w["g"])[None], jnp.asarray(w["b"])[None], jb(w["k1"]),
        jb(w["b1"])[None], jb(w["k2"]), jb(w["b2"])[None], interpret=True,
    )
    tb = lambda a: torch.from_numpy(np.array(a)).to(bf16)  # noqa: E731
    got = wa.window_block_mlp(
        tb(x), torch.from_numpy(w["g"]), torch.from_numpy(w["b"]), tb(w["k1"].T), tb(w["b1"]),
        tb(w["k2"].T), tb(w["b2"]),
    )
    assert got.dtype == bf16 and got.shape == (n, t, c)
    assert_close_bf16(got.float(), np.asarray(want, np.float32))


def test_window_attention_plain_matches_pallas(rng):
    """3 windows of 64 tokens, 2 heads of 72, the same q pre-scaled by
    d^-½·log2(e) on both sides; the JAX kernel takes head-padded planes and
    a ones column in v, the port the unpadded q, k, v. Real lanes within
    the JAX package's tolerance for this kernel (atol = rtol = 0.02)."""
    heads, d, n, t = 2, 72, 3, 64
    q, k, v = (_bf16(rng, n, t, heads * d) for _ in range(3))
    q = np.asarray((jnp.asarray(q, jnp.bfloat16) * (d**-0.5 * LOG2E)).astype(jnp.float32))

    def planes(x, ones=False):
        out = np.zeros((n, t, heads * 128), np.float32)
        for h in range(heads):
            out[..., h * 128 : h * 128 + d] = x[..., h * d : (h + 1) * d]
            if ones:
                out[..., h * 128 + d] = 1.0
        return jnp.asarray(out, jnp.bfloat16)

    want = jwa.window_attention(
        planes(q), planes(k), planes(v, ones=True), head_dim=d, interpret=True,
    )
    want = np.asarray(want, np.float32)
    tq, tk, tv = (torch.from_numpy(np.array(a)).to(bf16) for a in (q, k, v))
    got = wa.window_attention(tq, tk, tv, heads).float().numpy()
    for h in range(heads):
        np.testing.assert_allclose(
            got[..., h * d : (h + 1) * d], want[..., h * 128 : h * 128 + d], atol=0.02, rtol=0.02
        )


# ---- Hiera and the encoder ----------------------------------------------------


@pytest.fixture(scope="module")
def hiera_models():
    """Per config: the JAX Hiera's own init variables (as
    ``tests/test_sam2.py`` runs them, whose bf16 tolerance the direct
    comparison below uses), the same tree randomized, and a 128² input."""
    rng = np.random.default_rng(7)
    out = {}
    for name, kwargs in HIERA_CONFIGS.items():
        x = rng.random((1, 128, 128)).astype(np.float32)
        model = JaxHiera(JaxHieraConfig(**kwargs), dtype=jnp.bfloat16)
        variables = jax.jit(model.init)(jax.random.key(0), jnp.asarray(x))
        out[name] = (kwargs, variables, randomize(variables, rng), x)
    return out


def _jax_kernel_path(kwargs, variables, x):
    """The JAX Hiera in bf16 with its window kernels in interpret mode."""
    jmodel = JaxHiera(JaxHieraConfig(**kwargs), dtype=jnp.bfloat16)
    try:
        jwa.set_window_kernel("interpret")
        return jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    finally:
        jwa.set_window_kernel(None)


def _port_trunk(variables, kwargs, dtype, window_persistent=True):
    """The port's Hiera with the JAX trunk's weights (as the encoder's
    ``trunk.*`` entries), the kernels' scales folded in f32, as
    ``make_image_encoder`` builds it."""
    sd = sam2_encoder_from_jax({"params": {"trunk": variables["params"]}})
    trunk = {k[len("trunk."):]: v for k, v in sd.items()}
    in_chans = trunk["patch_embed.proj.weight"].shape[1]
    model = port_hiera.Hiera(HieraConfig(**kwargs), in_chans, window_persistent)
    model.load_state_dict(to_torch(trunk), strict=True)
    model.fold_kernel_scales()
    for module in model.modules():  # LayerNorms and position embeddings stay f32
        if isinstance(module, (torch.nn.Linear, torch.nn.Conv2d, port_hiera.MultiScaleAttention)):
            module.to(dtype)
    return model.eval().requires_grad_(False)


@pytest.mark.parametrize("config", sorted(GATE_CONFIGS))
def test_hiera_bf16_matches_jax_kernel_path(hiera_models, config, monkeypatch):
    """bf16, the JAX kernels in interpret mode, the port's plain versions
    under the same gates (each gate's calls counted on the port side)."""
    kwargs, variables, _, x = hiera_models[config]
    want = _jax_kernel_path(kwargs, variables, x)

    calls = {"block": 0, "mlp": 0, "global": 0}

    def counted(key, fn):
        def wrapper(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(port_hiera, "window_block_attention",
                        counted("block", wa.window_block_attention))
    monkeypatch.setattr(port_hiera, "window_block_mlp", counted("mlp", wa.window_block_mlp))
    monkeypatch.setattr(port_hiera, "window_attention", counted("global", wa.window_attention))
    with torch.no_grad():
        got = _port_trunk(variables, kwargs, bf16)(torch.from_numpy(x))
    assert (calls["block"], calls["mlp"], calls["global"]) == GATE_CALLS[config]
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == bf16 and tuple(a.shape) == b.shape
        assert_close_bf16(a.float(), np.asarray(b, np.float32))


@pytest.mark.parametrize("config", sorted(GATE_CONFIGS))
def test_hiera_bf16_random_weights_as_close_to_f32_as_jax(hiera_models, config):
    """bf16 on randomized weights (biases and norm affines non-trivial),
    where two bf16 runs drift apart by more than the direct comparison's
    0.1: per stage output, the port's distance to the JAX f32 trunk is at
    most 1.25 times that of the JAX kernel path (max |diff|, both printed),
    and its cosine to f32 stays above 0.9999."""
    kwargs, _, variables, x = hiera_models[config]
    ref = jax.jit(JaxHiera(JaxHieraConfig(**kwargs)).apply)(variables, jnp.asarray(x))
    jax_bf16 = _jax_kernel_path(kwargs, variables, x)
    with torch.no_grad():
        got = _port_trunk(variables, kwargs, bf16)(torch.from_numpy(x))
    for level, (a, j, r) in enumerate(zip(got, jax_bf16, ref, strict=True)):
        a, j, r = (np.asarray(t, np.float64).ravel() for t in (a.float(), np.asarray(j, np.float32), r))
        port_dist, jax_dist = np.abs(a - r).max(), np.abs(j - r).max()
        print(f"{config} level {level}: max |bf16 - JAX f32| port {port_dist:.4f}, "
              f"JAX kernel path {jax_dist:.4f}")
        assert port_dist <= 1.25 * jax_dist, (port_dist, jax_dist)
        assert a @ r / (np.linalg.norm(a) * np.linalg.norm(r)) > 0.9999


def test_kernel_gates_need_the_folded_projection(hiera_models):
    """A bf16 trunk whose folded qkv copies were never made raises at the
    first kernel gate instead of running unscaled attention."""
    kwargs, _, variables, x = hiera_models["global"]
    model = _port_trunk(variables, kwargs, bf16)
    for blk in model.blocks:
        blk.attn.kernel_qkv_weight = blk.attn.kernel_qkv_bias = None
    with pytest.raises(RuntimeError, match="fold_kernel_scales"), torch.no_grad():
        model(torch.from_numpy(x))


@pytest.mark.parametrize("config", sorted(HIERA_CONFIGS))
def test_hiera_f32_matches_jax(hiera_models, config):
    """f32 takes no kernel gate on either side: the same math on randomized
    weights (biases, norm affines), reduction order only (atol 1e-4 on
    outputs of a few units)."""
    kwargs, _, variables, x = hiera_models[config]
    want = jax.jit(JaxHiera(JaxHieraConfig(**kwargs)).apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = _port_trunk(variables, kwargs, torch.float32)(torch.from_numpy(x))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, bf16])
def test_hiera_window_persistent_matches_per_block(hiera_models, dtype):
    """The window-persistent run loop is a layout transform: the same bits
    as partitioning per block (the JAX package's oracle for it)."""
    kwargs, _, variables, x = hiera_models["padded"]
    with torch.no_grad():
        fast = _port_trunk(variables, kwargs, dtype)(torch.from_numpy(x))
        slow = _port_trunk(variables, kwargs, dtype, window_persistent=False)(torch.from_numpy(x))
    for a, b in zip(fast, slow, strict=True):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def tiny_encoder():
    """``tiny_test``: the JAX encoder's init variables ("init", for the bf16
    comparisons, as above), the same tree randomized ("random", for f32) and
    a 64² 3-channel input."""
    rng = np.random.default_rng(8)
    cfg = JaxSAM2Config.tiny_test()
    x = rng.random((2, 64, 64, 3)).astype(np.float32)
    variables = jax.jit(JaxImageEncoder(cfg).init)(jax.random.key(0), jnp.asarray(x))
    return cfg, {"init": variables, "random": randomize(variables, rng)}, x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_image_encoder_matches_jax(tiny_encoder, dtype):
    """``tiny_test`` at 64², 3-channel input: f32 (randomized weights)
    within 1e-4; bf16 (init weights) within the bf16 tolerance; the position
    encodings equal in both."""
    cfg, weights, x = tiny_encoder
    variables = weights["random" if dtype == "f32" else "init"]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, bf16)
    want = jax.jit(JaxImageEncoder(cfg, dtype=jdt).apply)(variables, jnp.asarray(x))
    model = make_image_encoder(to_torch(sam2_encoder_from_jax(variables)), SAM2Config.tiny_test(),
                               device="cpu", dtype=tdt)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == {"backbone_fpn", "vision_pos_enc"}
    for a, b in zip(got["backbone_fpn"], want["backbone_fpn"], strict=True):
        assert a.dtype == tdt and tuple(a.shape) == b.shape
        if dtype == "f32":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)
        else:
            assert_close_bf16(a.float(), np.asarray(b, np.float32))
    for a, b in zip(got["vision_pos_enc"], want["vision_pos_enc"], strict=True):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


def test_sam_extractor_matches_jax_extractor(tiny_encoder):
    """``SamFeatureExtractor.extract`` on 3×48×48 slices (resized to 64²,
    a padded tail batch of 1 at batch size 2) against the JAX extractor, both
    in bf16 with the patch embed folded to one channel: fp16 ``(D, C, h, w)``
    pyramids within the bf16 tolerance (init weights), position encodings
    equal."""
    cfg, weights, _ = tiny_encoder
    variables = weights["init"]
    stack = np.random.default_rng(9).random((3, 48, 48)).astype(np.float32)
    want = JaxSamFeatureExtractor(variables, cfg=cfg, batch_size=2).extract(stack)
    sd = fold_rgb_patch_embed(to_torch(sam2_encoder_from_jax(variables)))
    encoder = make_image_encoder(sd, SAM2Config.tiny_test(), device="cpu", dtype=bf16)
    got = SamFeatureExtractor(encoder, batch_size=2).extract(stack)
    shapes = [(3, 32, 16, 16), (3, 32, 8, 8), (3, 32, 4, 4)]
    for key in ("backbone_fpn", "vision_pos_enc"):
        assert [a.shape for a in got[key]] == [b.shape for b in want[key]] == shapes
        assert all(a.dtype == np.float16 for a in got[key])
    for a, b in zip(got["backbone_fpn"], want["backbone_fpn"]):
        assert_close_bf16(a.astype(np.float32), b.astype(np.float32))
    for a, b in zip(got["vision_pos_enc"], want["vision_pos_enc"]):
        np.testing.assert_array_equal(a, b)


def test_published_checkpoint_loads_strictly_and_matches_the_jax_converter(tmp_path):
    """A published-style checkpoint (``image_encoder.*`` beside other
    modules' tensors): ``sam2_encoder_from_published`` loads strictly into
    the 3-channel encoder, inverting the JAX converter's params with
    ``sam2_encoder_from_jax`` gives back exactly the same tensors, and the
    extractor's loader reads it as ``sam2.1_hiera_large.pt`` under
    ``model_dir`` with the patch embed folded to one channel."""
    cfg = SAM2Config.tiny_test()
    port_sd = random_encoder_state_dict(cfg, torch.Generator().manual_seed(0))
    published = {f"image_encoder.{k}": v for k, v in port_sd.items()}
    published.update({"no_mem_embed": torch.zeros(1, 1, 32),
                      "sam_mask_decoder.iou_token.weight": torch.zeros(1, 32)})
    sd = sam2_encoder_from_published(published)
    assert set(sd) == set(port_sd)
    model = make_image_encoder(to_torch(sd), cfg, device="cpu", dtype=torch.float32)
    assert model.trunk.patch_embed.proj.in_channels == 3
    assert model.neck.convs[0].conv.in_channels == cfg.hiera.stage_dims[-1]  # convs.0: stride 32
    jax_params = convert_encoder_state_dict(
        {k: v.numpy() for k, v in published.items()}, JaxSAM2Config.tiny_test()
    )
    back = sam2_encoder_from_jax(jax_params)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)

    torch.save({"model": published}, tmp_path / SAM2_CHECKPOINT)
    loaded = make_sam_encoder_state(tmp_path, cfg, device="cpu")
    patch = "trunk.patch_embed.proj.weight"
    assert loaded[patch].shape == (cfg.hiera.embed_dim, 1, 7, 7)
    torch.testing.assert_close(loaded[patch], port_sd[patch].sum(1, keepdim=True))
    for k in set(port_sd) - {patch}:
        torch.testing.assert_close(loaded[k], port_sd[k], rtol=0, atol=0)
    with pytest.raises(FileNotFoundError, match=SAM2_CHECKPOINT):
        make_sam_encoder_state(tmp_path / "missing", cfg, device="cpu")


def test_run_sam_writes_the_hdf5_layout(tmp_path, rng):
    """``run_sam`` through an MRC file on the CPU: ``<stem>.hdf`` with the
    f32 ``data`` volume and fp16 ``sam_features/{backbone_fpn,
    vision_pos_enc}/{0,1,2}`` pyramids, channels first."""
    vol = (rng.random((3, 48, 48)) * 200).astype(np.float32)
    write_mrc(tmp_path / "v.mrc", vol)
    written = run_sam([tmp_path / "v.mrc"], tmp_path / "out", batch_size=2, random_init=True,
                      sam_cfg=SAM2Config.tiny_test(), device="cpu")
    assert [p.name for p in written] == ["v.hdf"]
    with h5py.File(written[0]) as f:
        np.testing.assert_array_equal(np.asarray(f["data"]), vol)
        for key in ("backbone_fpn", "vision_pos_enc"):
            for i, side in enumerate((16, 8, 4)):
                level = f[f"sam_features/{key}/{i}"]
                assert level.dtype == np.float16 and level.shape == (3, 32, side, side)
                assert np.isfinite(np.asarray(level)).all()


def test_cli_features_use_sam_on_the_cpu(tmp_path, rng, monkeypatch):
    """``cryovit-torch features --use-sam --device cpu`` with random weights,
    the encoder shrunk to ``tiny_test``; with ``--int8`` (the w8a8 mode) it
    writes the same layout, its pyramids within relative L2 0.05 of the
    default's (f32 products on the CPU)."""
    from cryovit_tpu_torch.cli.main import main

    monkeypatch.setattr(SAM2Config, "large", classmethod(lambda cls: cls.tiny_test()))
    tomos = tmp_path / "tomos"
    tomos.mkdir()
    write_mrc(tomos / "t.mrc", rng.integers(0, 255, size=(2, 40, 56)).astype(np.uint8))
    assert main(["features", str(tomos), str(tmp_path / "feats"), "--use-sam", "--random-init",
                 "--batch-size", "2", "--device", "cpu"]) == 0
    with h5py.File(tmp_path / "feats" / "t.hdf") as f:
        assert f["sam_features/backbone_fpn/0"].shape == (2, 32, 16, 16)
        assert f["sam_features/vision_pos_enc/2"].dtype == np.float16
    assert main(["features", str(tomos), str(tmp_path / "f2"), "--use-sam", "--int8",
                 "--random-init", "--batch-size", "2", "--device", "cpu"]) == 0
    with h5py.File(tmp_path / "feats" / "t.hdf") as f, h5py.File(tmp_path / "f2" / "t.hdf") as g:
        for i in range(3):
            want = np.asarray(f[f"sam_features/backbone_fpn/{i}"], np.float64)
            got = np.asarray(g[f"sam_features/backbone_fpn/{i}"], np.float64)
            assert got.shape == want.shape and not np.array_equal(got, want)
            assert np.linalg.norm(got - want) <= 0.05 * np.linalg.norm(want)


@pytest.mark.parametrize("shape", [(48, 48, 64, 64), (700, 600, 512, 512), (37, 53, 512, 300)])
def test_linear_resize_matches_jax_image_resize(rng, shape):
    """The extractor's resize: an upscale, a downscale (antialiased) and a
    mixed one against ``jax.image.resize(..., "linear")`` (f32; weights
    built in f64 here, in f32 there)."""
    from cryovit_tpu_torch.ops.resize import resize_linear_2d

    h, w, oh, ow = shape
    x = rng.random((2, h, w)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, oh, ow), "linear"))
    got = resize_linear_2d(torch.from_numpy(x), oh, ow).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
