"""The port's models and weight bridges against the JAX package.

Weights are drawn once with numpy, loaded into the JAX modules as they are
and into the port through ``cryovit_tpu_torch.convert``; inputs are numpy
too. On the CPU the port's kernel wrappers run their plain versions and the
JAX side runs its Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cryovit_tpu.models.cryovit import CryoVITModule
from cryovit_tpu.models.dinov2 import DinoV2Config as JaxDinoV2Config
from cryovit_tpu.models.dinov2 import make_dinov2 as jax_make_dinov2
from cryovit_tpu.ops.conv3d_dm import set_conv3d_kernel
from cryovit_tpu.train.torch_export import export_cryovit_state_dict
from cryovit_tpu_torch.convert import (
    cryovit_from_jax,
    dinov2_from_jax,
    dinov2_from_torch_hub,
)
from cryovit_tpu_torch.models.cryovit import make_cryovit, random_cryovit_state_dict
from cryovit_tpu_torch.models.dinov2 import DinoV2, DinoV2Config, make_dinov2
from cryovit_tpu_torch.run.dino_features import TORCH_HUB_WEIGHTS, load_dinov2_variables

# d = 64 heads, so the JAX side takes the pair-packed Pallas path
SMALL = dict(embed_dim=128, depth=2, num_heads=2, ffn_hidden=256, pos_grid=8)


def randomize(variables, rng):
    """Every leaf redrawn with numpy: kernels ~ N(0, 1/fan_in), norm scales
    ~ 1 + N(0, 0.1²), everything else (biases, LayerScale, tokens, position
    embeddings) ~ N(0, 0.1²)."""

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(x)
        if name.endswith("kernel"):
            spatial = int(np.prod(shape[:-2])) if len(shape) == 5 else 1
            return rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[-2] * spatial)
        noise = 0.1 * rng.standard_normal(shape).astype(np.float32)
        return noise + 1.0 if name == "scale" else noise

    return jax.tree_util.tree_map_with_path(leaf, variables)


def to_torch(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


# ---- DINOv2 -----------------------------------------------------------------


@pytest.mark.parametrize("scan_blocks", [False, True])
def test_dinov2_matches_jax_flash_pairs_path(rng, scan_blocks):
    """f32, 2 blocks of 2 heads x 64, a 4x5 patch grid (the 8x8 position grid
    is interpolated, 25 tokens pad to 32 on the JAX side); atol 1e-4:
    reduction order only."""
    jmodel = jax_make_dinov2(
        JaxDinoV2Config(**SMALL), dtype=jnp.float32, use_flash_attention=True,
        flash_interpret=True, scan_blocks=scan_blocks,
    )
    x = rng.random((2, 56, 70)).astype(np.float32)
    variables = randomize(jmodel.init(jax.random.key(0), jnp.asarray(x)), rng)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))

    model = make_dinov2(
        to_torch(dinov2_from_jax(variables)), DinoV2Config(**SMALL), device="cpu",
        dtype=torch.float32,
    )
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 20, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("normalize", [True, False])
def test_dinov2_from_torch_hub_matches_torch_clone(rng, normalize):
    """The hub layout (3-channel patch embed, mask_token) against the torch
    clone of DINOv2-with-registers in test_dinov2.py, fed RGB-replicated
    (optionally ImageNet-normalized) slices; atol 5e-4 as that file uses."""
    from test_dinov2 import IMAGENET_MEAN, IMAGENET_STD, TorchDino

    cfg = JaxDinoV2Config.tiny_test()
    with torch.random.fork_rng():
        torch.manual_seed(0)
        clone = TorchDino(cfg).eval()
    gray = rng.random((2, 3 * cfg.patch_size, 5 * cfg.patch_size)).astype(np.float32)
    x3 = np.repeat(gray[:, None], 3, axis=1)
    if normalize:
        x3 = (x3 - np.asarray(IMAGENET_MEAN)[None, :, None, None]) / np.asarray(
            IMAGENET_STD
        )[None, :, None, None]
    hub = dict(clone.state_dict())
    hub["mask_token"] = torch.zeros(1, cfg.embed_dim)
    with torch.no_grad():
        want = clone(torch.from_numpy(x3.astype(np.float32))).numpy()
        model = make_dinov2(
            to_torch(dinov2_from_torch_hub(hub, normalize=normalize)),
            DinoV2Config.tiny_test(), device="cpu", dtype=torch.float32,
        )
        got = model(torch.from_numpy(gray)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_hub_checkpoint_file_loads_through_the_extractor_loader(tmp_path):
    """``load_dinov2_variables`` reads the published checkpoint's file name
    from the model directory and folds it exactly as the converter does."""
    from test_dinov2 import TorchDino

    with torch.random.fork_rng():
        torch.manual_seed(1)
        hub = TorchDino(JaxDinoV2Config.tiny_test()).state_dict()
    torch.save(hub, tmp_path / TORCH_HUB_WEIGHTS)
    sd, is_random = load_dinov2_variables(tmp_path, cfg=DinoV2Config.tiny_test(), device="cpu")
    assert not is_random
    want = dinov2_from_torch_hub(hub)
    assert sd.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k])
    with pytest.raises(FileNotFoundError, match=TORCH_HUB_WEIGHTS):
        load_dinov2_variables(tmp_path / "empty", device="cpu")


def test_random_init_follows_flax_laws():
    """Seeded, deterministic, every parameter of the module, and the flax
    init laws: lecun-normal kernels, pos-embed N(0, 0.02), LayerScale 1e-5,
    unit norm scales, zero biases and tokens."""
    cfg = DinoV2Config(**{**SMALL, "depth": 1})
    sd, is_random = load_dinov2_variables(random_init=True, cfg=cfg, device="cpu", seed=3)
    again, _ = load_dinov2_variables(random_init=True, cfg=cfg, device="cpu", seed=3)
    assert is_random
    with torch.device("meta"):
        assert sd.keys() == DinoV2(cfg).state_dict().keys()
    for k in sd:
        torch.testing.assert_close(sd[k], again[k], rtol=0, atol=0)
    qkv = sd["blocks.0.attn.qkv.weight"]
    assert abs(qkv.std().item() * np.sqrt(128) - 1.0) < 0.05
    assert qkv.abs().max().item() <= 2.0 / 0.8796 / np.sqrt(128) + 1e-6
    assert abs(sd["pos_embed"].std().item() - 0.02) < 0.002
    assert torch.all(sd["blocks.0.ls1.gamma"] == 1e-5)
    assert torch.all(sd["blocks.0.norm2.weight"] == 1) and torch.all(sd["norm.bias"] == 0)
    assert torch.all(sd["cls_token"] == 0) and torch.all(sd["blocks.0.mlp.w3.bias"] == 0)


# ---- CryoVIT decoder --------------------------------------------------------


def _decoder_variables(rng, feats, dtype=jnp.float32):
    """Random decoder weights; the mask head's kernel is scaled up so the
    probabilities spread over (0, 1) instead of sitting at 0.5."""
    module = CryoVITModule(dtype=dtype, remat=False)
    variables = randomize(module.init(jax.random.key(0), jnp.asarray(feats)), rng)
    head = variables["params"]["Conv_2"]
    head["kernel"] = head["kernel"] * 40.0
    return module, variables


@pytest.fixture(scope="module")
def decoder_f32():
    """f32 decoder weights (initialised once for this file) and features:
    3 slices on a 2x3 patch grid of 1536 channels."""
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((1, 3, 2, 3, 1536)).astype(np.float32)
    return (*_decoder_variables(rng, feats), feats)


def test_cryovit_matches_jax_decoder_f32(decoder_f32):
    """f32 end to end: 3 slices, 2x3 patch grid of 1536 features → 32x48
    probabilities; atol 1e-4 (exact math, another reduction order)."""
    module, variables, feats = decoder_f32
    want = np.asarray(module.apply(variables, jnp.asarray(feats)))
    model = make_cryovit(to_torch(cryovit_from_jax(variables)), device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (1, 3, 32, 48)
    assert 0.01 < want.std()  # the probabilities are not saturated or flat
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_cryovit_matches_jax_decoder_bf16_with_interpret_kernels(rng):
    """bf16 with the JAX Pallas tail kernels in interpret mode (an 8x8 patch
    grid puts the mask head at W = 128, where they engage); atol 2e-2: bf16
    rounds at different places in the two packages."""
    feats = rng.standard_normal((1, 2, 8, 8, 1536)).astype(np.float32)
    module, variables = _decoder_variables(rng, feats, dtype=jnp.bfloat16)
    set_conv3d_kernel("interpret")
    try:
        want = np.asarray(module.apply(variables, jnp.asarray(feats)))
    finally:
        set_conv3d_kernel(None)
    model = make_cryovit(to_torch(cryovit_from_jax(variables)), device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    assert got.dtype == np.float32 and got.shape == (1, 2, 128, 128)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_cryovit_from_jax_equals_torch_export(decoder_f32):
    """Key for key and value for value the state dict the JAX package's own
    exporter writes (ConvTranspose taps flipped)."""
    _, variables, _ = decoder_f32
    got = cryovit_from_jax(variables)
    want = export_cryovit_state_dict(variables)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dinov2_from_jax_unstacks_scanned_params(rng):
    """The scanned layout (leading depth axis) and the per-block layout of
    the same weights convert to the same state dict."""
    cfg = JaxDinoV2Config(**SMALL)
    x = jnp.zeros((1, 28, 28))
    scanned = randomize(jax_make_dinov2(cfg, scan_blocks=True).init(jax.random.key(0), x), rng)
    p = scanned["params"]
    per_block = {k: v for k, v in p.items() if k != "blocks"}
    for i in range(cfg.depth):
        per_block[f"block{i}"] = jax.tree_util.tree_map(lambda a, i=i: a[i], p["blocks"])
    a, b = dinov2_from_jax(scanned), dinov2_from_jax({"params": per_block})
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_random_decoder_state_dict_loads_strictly():
    sd = random_cryovit_state_dict(torch.Generator().manual_seed(0), in_channels=64)
    model = make_cryovit(sd)
    assert model.layers[0].weight.shape == (1024, 64, 1, 1, 1)
    w = sd["layers.2.layers.1.weight"]  # (192, 1024, 3, 3, 3)
    assert abs(w.std().item() * np.sqrt(27 * 1024) - 1.0) < 0.05
