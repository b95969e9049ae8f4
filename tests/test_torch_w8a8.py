"""The port's w8a8 mode (``--int8``) against the JAX package's.

- ``ops/quant.py``: ``int8_quant`` bit for bit against JAX's (bf16 and f32
  inputs, all-zero rows on the 1e-12 floor, exact .5 ties) and the w8a8
  product against ``qeinsum``.
- DINOv2 (``DinoV2Config.tiny_test()``) with ``quant_int8`` on the pair path
  (JAX's ``flash_attention_pairs`` in interpret mode: its plain attention does
  not quantize qkv), ``pair_heads=False`` (w12 only) and ``fused_ln=True``.
- The Hiera trunk with ``quant_int8`` in the two configs of
  ``tests/test_torch_sam2.py`` that open the JAX kernel gates.
- The prequantized weights against on-the-fly quantization, and the CLI.

The model comparisons run in f32, where the port follows JAX to 1e-7 and
the int8 products are what sets the two modes apart. In bf16 two
implementations round at different places by as much as int8 moves the
output (tiny_test DINOv2: 0.0057 port against JAX, 0.0042 JAX int8 against
JAX bf16), so there the test checks which products are int8. Each limit is
at most a third of JAX's own int8-against-unquantized difference, and two
planted faults must read above it: a per-tensor weight scale in place of the
per-channel one, and the activation scales broadcast on the wrong axes (the
two token axes before the channels swapped).
"""

from functools import partial

import flax.linen.module as flax_module
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import SMALL, randomize, to_torch
from test_torch_sam2 import GATE_CONFIGS, _jax_kernel_path, assert_close_bf16
from test_torch_sam2 import randomize as randomize_hiera

import cryovit_tpu.models.sam2.hiera as jax_hiera
from cryovit_tpu.models.dinov2 import DinoV2 as JaxDinoV2
from cryovit_tpu.models.dinov2 import DinoV2Config as JaxDinoV2Config
from cryovit_tpu.models.sam2.config import HieraConfig as JaxHieraConfig
from cryovit_tpu.ops import flash_attention as jfa
from cryovit_tpu.ops import fused_norm as jfn
from cryovit_tpu.ops.quant import int8_quant as jax_int8_quant
from cryovit_tpu.ops.quant import qeinsum
from cryovit_tpu.run.sam_features import prequantize_trunk_int8
from cryovit_tpu_torch.cli.main import main
from cryovit_tpu_torch.convert import dinov2_from_jax, sam2_encoder_from_jax
from cryovit_tpu_torch.io import write_mrc
from cryovit_tpu_torch.models import dinov2 as port_dinov2
from cryovit_tpu_torch.models.cryovit import make_cryovit, random_cryovit_state_dict
from cryovit_tpu_torch.models.dinov2 import DinoV2Config, make_dinov2
from cryovit_tpu_torch.models.sam2 import hiera as port_hiera
from cryovit_tpu_torch.models.sam2.config import HieraConfig
from cryovit_tpu_torch.models.sam2.encoder import make_image_encoder
from cryovit_tpu_torch.ops import quant
from cryovit_tpu_torch.train.checkpoint import save_model

# relative L2 of the port's int8 output against JAX's, in f32 (measured:
# DINOv2 1.2e-7 on every path, Hiera 1.9e-7-2.9e-7; with another seed one
# Hiera activation rounded across a .5 boundary between the two packages'
# LayerNorms, 4.8e-4). JAX's own int8 output is 0.0019-0.0024 (DINOv2) and
# 0.0033-0.0076 (Hiera) from its unquantized one; the planted faults read
# 0.0035-0.075 (DINOv2) and 0.0058-0.14 (Hiera).
DINO_LIMIT = 2e-4
HIERA_LIMIT = 1e-3
# the int8 products of one forward per block: qkv (pair path) and w12
DINO_PRODUCTS = {"pair": 2, "head_major": 1, "fused_ln": 2}


def _rel(got, want):
    got, want = (np.asarray(a, np.float64).ravel() for a in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---- int8_quant and the product ---------------------------------------------------


def _tie_rows(rng, k):
    """Rows whose elements sit exactly on .5 ties of x / scale in f32 (the
    row's amax kept at 127·scale), and an all-zero row."""
    rows = []
    for amax in (127.0 * 0.013, 3.7, 1e-3):
        scale = np.float32(max(np.float32(amax), np.float32(1e-12))) * np.float32(1.0 / 127.0)
        ticks = rng.integers(-126, 126, size=k - 1) + 0.5
        vals = (ticks.astype(np.float32) * scale).astype(np.float32)
        exact = (vals / scale).astype(np.float32) == ticks.astype(np.float32)
        vals[~exact] = 0.0
        rows.append(np.concatenate([[np.float32(amax)], vals]))
    rows.append(np.zeros(k, np.float32))
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_quant_matches_jax_bit_for_bit(rng, dtype):
    """Per token (dim -1) and per output channel (dim 0) on random rows,
    exact .5 ties (half to even) and all-zero rows (the 1e-12 floor): the
    int8 values and f32 scales equal JAX's."""
    ties = _tie_rows(rng, 64)
    x = np.concatenate([rng.standard_normal((29, 64)).astype(np.float32) * 3, ties])
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    for axis in (-1, 0):
        want_q, want_s = jax_int8_quant(jx, axis=axis)
        got_q, got_s = quant.int8_quant(tx, axis)
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    q, s = quant.int8_quant(tx, -1)
    assert (q[-1] == 0).all() and s[-1].item() == np.float32(1e-12) * np.float32(1 / 127)
    if dtype == "float32":  # ties rounded to even on both sides
        ratio = x[29:32] / np.asarray(s[29:32])
        tie = np.abs(ratio - np.trunc(ratio)) == 0.5
        assert tie.sum() > 100 and (q[29:32].numpy()[tie] % 2 == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_matmul_matches_qeinsum(rng, dtype, with_bias):
    """``int8_matmul`` against JAX ``qeinsum`` (plus the bias in the compute
    dtype, as ``hiera._Dense`` adds it), bit for bit; the int8 values reach
    |acc| ~ 127²·K, past f32's exact integers."""
    m, k, n = 40, 1536, 24
    xq = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(n, k)).astype(np.int8)
    xq[0] = 127
    wq[0] = 127
    sx = (rng.random((m, 1)) * 0.1).astype(np.float32)
    sw = (rng.random((n,)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = qeinsum("mk,kn->mn", jnp.asarray(xq), jnp.asarray(wq.T), jnp.asarray(sx),
                   jnp.asarray(sw[None]), lambda s: s, lambda s: s, jdt)
    if with_bias:
        want = want + jnp.asarray(bias).astype(jdt)
    quant.reset_launch_count()
    got = quant.int8_matmul(torch.from_numpy(xq), torch.from_numpy(sx), torch.from_numpy(wq),
                            torch.from_numpy(sw), tdt,
                            torch.from_numpy(bias) if with_bias else None)
    assert quant.launch_count() == 1 and got.dtype == tdt and got.shape == (m, n)
    assert abs(int(xq[0].astype(np.int64) @ wq[0].astype(np.int64))) > 2**24
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("shape, problem", [
    ((16, 64, 32), "more than 16 rows"),
    ((32, 60, 32), "multiples of 8"),
    ((32, 64, 36), "multiples of 8"),
])
def test_int8_matmul_states_what_the_card_takes(shape, problem):
    """What ``torch._int_mm`` takes on CUDA (checked before the product, on
    CUDA tensors only): more than 16 rows, K and N multiples of 8."""
    m, k, n = shape
    with pytest.raises(ValueError, match=problem):
        quant._check_cuda_args(torch.zeros(m, k, dtype=torch.int8),
                               torch.zeros(n, k, dtype=torch.int8))
    quant._check_cuda_args(torch.zeros(32, 64, dtype=torch.int8),
                           torch.zeros(32, 64, dtype=torch.int8))


# ---- planted faults -----------------------------------------------------------------


def _per_tensor_weight(weight):
    """Fault: one scale for the whole weight."""
    wf = weight.float()
    scale = wf.abs().max().clamp_min(1e-12) * (1.0 / 127.0)
    wq = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return wq.contiguous(), scale.expand(weight.shape[0]).contiguous()


def _plant(monkeypatch, fault):
    if fault == "per_tensor_weight":
        for module in (port_dinov2, port_hiera):
            monkeypatch.setattr(module, "quantize_weight", _per_tensor_weight)
    else:  # the activation scales broadcast on the wrong axes
        honest = quant.int8_quant

        def swapped(x, dim):
            q, s = honest(x, dim)
            if dim == -1:
                s = s.transpose(-2, -3).reshape(s.shape)
            return q, s

        monkeypatch.setattr(quant, "int8_quant", swapped)


FAULTS = ("per_tensor_weight", "activation_axes")


# ---- DINOv2 ---------------------------------------------------------------------------

DINO_PATHS = {
    "pair": (dict(pair_attention_fn=partial(jfa.flash_attention_pairs, interpret=True)),
             dict(pair_heads=True)),
    "head_major": (dict(qkv_attention_fn=partial(jfa.flash_attention_bhnd, interpret=True)),
                   dict(pair_heads=False)),
    "fused_ln": (dict(pair_attention_fn=partial(jfa.flash_attention_pairs, interpret=True),
                      fused_ln_fn=partial(jfn.residual_layernorm, interpret=True)),
                 dict(pair_heads=True, fused_ln=True)),
}


@pytest.fixture(scope="module")
def dino():
    """tiny_test (2 blocks, 4 heads of 16), randomized weights, a 2×42×28
    input; per path the JAX f32 outputs with and without quant_int8."""
    rng = np.random.default_rng(5)
    cfg = JaxDinoV2Config.tiny_test()
    x = rng.random((2, 42, 28)).astype(np.float32)
    plain = JaxDinoV2(cfg=cfg, dtype=jnp.float32, residual_dtype=jnp.float32)
    variables = randomize(plain.init(jax.random.key(0), jnp.asarray(x)), rng)
    outs = {}
    for path, (jax_kw, _) in DINO_PATHS.items():
        runs = [np.asarray(JaxDinoV2(cfg=cfg, dtype=jnp.float32, residual_dtype=jnp.float32,
                                     quant_int8=q, **jax_kw).apply(variables, jnp.asarray(x)))
                for q in (True, False)]
        outs[path] = runs
    return x, variables, outs


def _port_dino(variables, dtype=torch.float32, **options):
    return make_dinov2(to_torch(dinov2_from_jax(variables)), DinoV2Config.tiny_test(),
                       device="cpu", dtype=dtype, quant_int8=True, **options)


@pytest.mark.parametrize("path", sorted(DINO_PATHS))
def test_dinov2_int8_matches_jax(dino, path):
    """f32, each path: the port within DINO_LIMIT relative L2 of JAX's
    int8 output, which lies at least 3× that from JAX's unquantized one;
    the int8 products per block as JAX quantizes them (qkv on the pair path
    only, w12 everywhere)."""
    x, variables, outs = dino
    want, unquantized = outs[path]
    assert _rel(want, unquantized) >= 3 * DINO_LIMIT
    model = _port_dino(variables, **DINO_PATHS[path][1])
    quant.reset_launch_count()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert quant.launch_count() == DINO_PRODUCTS[path] * model.cfg.depth
    assert got.shape == want.shape == (2, 6, 64)
    assert _rel(got, want) <= DINO_LIMIT, _rel(got, want)


@pytest.mark.parametrize("fault", FAULTS)
def test_dinov2_limit_catches_planted_faults(dino, monkeypatch, fault):
    """The pair path with a planted fault reads above DINO_LIMIT."""
    x, variables, outs = dino
    _plant(monkeypatch, fault)
    with torch.no_grad():
        got = _port_dino(variables, pair_heads=True)(torch.from_numpy(x)).numpy()
    assert _rel(got, outs["pair"][0]) > DINO_LIMIT


def test_dinov2_int8_weights_are_jax_on_the_fly_quantization(dino):
    """bf16 compute: w12's int8 values and scales are JAX's ``int8_quant``
    of the f32 parameter (JAX quantizes it as stored), qkv's those of the
    bf16-cast weight (JAX casts first; its q third is also scaled by the
    softmax fold there, which the port passes to the kernel instead), bit
    for bit; the state dict is unchanged."""
    _, variables, _ = dino
    model = _port_dino(variables, dtype=torch.bfloat16, pair_heads=True)
    blocks = variables["params"]
    assert set(model.state_dict()) == set(dinov2_from_jax(variables))
    for i, blk in enumerate(model.blocks):
        p = blocks[f"block{i}"]
        for buffers, kernel in (
            ((blk.mlp.w12_int8, blk.mlp.w12_int8_scale), jnp.asarray(p["mlp"]["w12"]["kernel"])),
            ((blk.attn.qkv_int8, blk.attn.qkv_int8_scale),
             jnp.asarray(p["attn"]["qkv"]["kernel"]).astype(jnp.bfloat16)),
        ):
            wq, sw = jax_int8_quant(kernel, axis=0)
            np.testing.assert_array_equal(buffers[0].numpy(), np.asarray(wq).T)
            np.testing.assert_array_equal(buffers[1].numpy(), np.asarray(sw)[0])


# ---- Hiera ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hiera():
    """Per gate config: randomized weights, a 128² input, the JAX Hiera's f32
    outputs with and without quant_int8, and the JAX init weights (the bf16
    comparison's, as in ``tests/test_torch_sam2.py``)."""
    rng = np.random.default_rng(9)
    out = {}
    for name, kwargs in GATE_CONFIGS.items():
        if name == "global_96":
            continue
        x = rng.random((1, 128, 128)).astype(np.float32)
        model = jax_hiera.Hiera(JaxHieraConfig(**kwargs))
        initial = jax.jit(model.init)(jax.random.key(0), jnp.asarray(x))
        variables = randomize_hiera(initial, rng)
        runs = [jax.jit(jax_hiera.Hiera(JaxHieraConfig(**kwargs), quant_int8=q).apply)(
            variables, jnp.asarray(x)) for q in (True, False)]
        out[name] = (kwargs, variables, x, runs, initial)
    return out


def _jax_quantized_projections(monkeypatch, run):
    """(block index, "qkv" or "fc1") of each JAX ``_Dense`` that quantized
    its input during ``run()``."""
    seen = []
    honest = jax_hiera.int8_quant

    def recording(x, axis):
        if axis == -1:
            path = flax_module._context.module_stack[-1].scope.path
            seen.append((int(path[0][len("block"):]), "qkv" if path[-1] == "qkv" else "fc1"))
        return honest(x, axis)

    monkeypatch.setattr(jax_hiera, "int8_quant", recording)
    out = run()
    monkeypatch.undo()
    return out, sorted(seen)


def _port_quantized_projections(model, x):
    """(block index, "qkv" or "fc1") of each int8 product of the port's
    trunk in one forward, by hooks on the attention and MLP modules."""
    seen, hooks = [], []
    for i, blk in enumerate(model.blocks):
        for what, module in (("qkv", blk.attn), ("fc1", blk.mlp)):
            before = {}

            def pre(m, args, before=before):
                before["n"] = quant.launch_count()

            def post(m, args, out, i=i, what=what, before=before):
                seen.extend([(i, what)] * (quant.launch_count() - before["n"]))

            hooks += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    return out, sorted(seen)


def _port_encoder_trunk(variables, kwargs, dtype):
    """The port's trunk as ``make_image_encoder(quant_int8=True)`` builds it
    (folded scales, cast, int8 weights from the f32 values)."""
    sd = sam2_encoder_from_jax({"params": {"trunk": variables["params"]}})
    neck = {f"neck.convs.{j}.conv.{p}": np.zeros((256, c, 1, 1) if p == "weight" else (256,),
                                                  np.float32)
            for j, c in enumerate(reversed(HieraConfig(**kwargs).stage_dims))
            for p in ("weight", "bias")}
    from cryovit_tpu_torch.models.sam2.config import SAM2Config

    cfg = SAM2Config(hiera=HieraConfig(**kwargs))
    return make_image_encoder({**sd, **neck}, cfg, device="cpu", dtype=dtype,
                              quant_int8=True).trunk


@pytest.mark.parametrize("config", ["global", "window_block"])
def test_hiera_int8_matches_jax(hiera, config, monkeypatch):
    """f32 (no kernel gate on either side): per stage output, the port
    within HIERA_LIMIT relative L2 of JAX's int8 output, which lies at least
    3× that from JAX's unquantized one; the same blocks' qkv and fc1 are
    int8 products on both sides."""
    kwargs, variables, x, (want, unquantized), _ = hiera[config]
    _, jax_seen = _jax_quantized_projections(monkeypatch, lambda: jax.jit(jax_hiera.Hiera(
        JaxHieraConfig(**kwargs), quant_int8=True).apply)(variables, jnp.asarray(x)))
    got, seen = _port_quantized_projections(_port_encoder_trunk(variables, kwargs,
                                                                torch.float32), x)
    assert seen == jax_seen and len(seen) == 2 * sum(kwargs["stages"])
    for level, (a, w, u) in enumerate(zip(got, want, unquantized, strict=True)):
        assert _rel(w, u) >= 3 * HIERA_LIMIT, (level, _rel(w, u))
        assert _rel(a.numpy(), w) <= HIERA_LIMIT, (level, _rel(a.numpy(), w))


@pytest.mark.parametrize("fault", FAULTS)
def test_hiera_limit_catches_planted_faults(hiera, monkeypatch, fault):
    """The window-block config with a planted fault reads above HIERA_LIMIT
    at some stage output."""
    kwargs, variables, x, (want, _), _ = hiera["window_block"]
    _plant(monkeypatch, fault)
    with torch.no_grad():
        got = _port_encoder_trunk(variables, kwargs, torch.float32)(torch.from_numpy(x))
    assert max(_rel(a.numpy(), w) for a, w in zip(got, want)) > HIERA_LIMIT


@pytest.mark.parametrize("config", ["global", "window_block"])
def test_hiera_int8_bf16_takes_the_kernel_gates_as_jax(hiera, config, monkeypatch):
    """bf16 on the JAX init weights, the JAX kernels in interpret mode: the
    blocks that take a kernel gate (fused window blocks; the global
    attention's qkv) stay bf16 on both sides, every other qkv and fc1 is an
    int8 product on both sides (6 and 9 products), JAX's int8 output
    differs from its bf16 one (at the last stage: the window-block config's
    first stage is all fused blocks), and the port's agrees with JAX's
    within the JAX package's bf16 tolerance between its kernel and XLA
    paths."""
    kwargs, _, x, _, variables = hiera[config]

    def run():
        try:
            jax_hiera_model = jax_hiera.Hiera(JaxHieraConfig(**kwargs), dtype=jnp.bfloat16,
                                              quant_int8=True)
            from cryovit_tpu.ops import window_attention as jwa

            jwa.set_window_kernel("interpret")
            return jax.jit(jax_hiera_model.apply)(variables, jnp.asarray(x))
        finally:
            jwa.set_window_kernel(None)

    want, jax_seen = _jax_quantized_projections(monkeypatch, run)
    got, seen = _port_quantized_projections(_port_encoder_trunk(variables, kwargs,
                                                                torch.bfloat16), x)
    assert seen == jax_seen and len(seen) == {"window_block": 6, "global": 9}[config]
    for a, w in zip(got, want, strict=True):
        assert_close_bf16(a.float(), np.asarray(w, np.float32))
    bf16 = _jax_kernel_path(kwargs, variables, x)
    assert not np.array_equal(np.asarray(want[-1], np.float32), np.asarray(bf16[-1], np.float32))


def test_hiera_int8_weights_are_jax_prequantized_weights(hiera):
    """Every block's int8 qkv and fc1 weights and scales equal the JAX
    ``prequantize_trunk_int8`` collection (which JAX's own test holds to
    on-the-fly quantization), bit for bit, though the trunk computes in
    bf16: they come from the f32 weights."""
    kwargs, variables, _, _, _ = hiera["window_block"]
    trunk = _port_encoder_trunk(variables, kwargs, torch.bfloat16)
    want = prequantize_trunk_int8(variables["params"])
    for i, blk in enumerate(trunk.blocks):
        for (wq, sw), key in (((blk.attn.qkv_int8, blk.attn.qkv_int8_scale),
                               want[f"block{i}"]["attn"]["qkv"]),
                              ((blk.mlp.fc1_int8, blk.mlp.fc1_int8_scale),
                               want[f"block{i}"]["mlp_fc1"])):
            assert sw.dtype == torch.float32
            np.testing.assert_array_equal(wq.numpy(), np.asarray(key["wq"]).T)
            np.testing.assert_array_equal(sw.numpy(), np.asarray(key["sw"])[0])


# ---- the CLI --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    """A 4×56×70 MRC tomogram and a CryoVIT ``.model`` for the small
    (128-wide) backbone."""
    root = tmp_path_factory.mktemp("w8a8_cli")
    rng = np.random.default_rng(3)
    (root / "tomos").mkdir()
    write_mrc(root / "tomos" / "t.mrc", rng.integers(0, 255, size=(4, 56, 70)).astype(np.int16))
    decoder = make_cryovit(random_cryovit_state_dict(torch.Generator().manual_seed(4),
                                                     in_channels=SMALL["embed_dim"]))
    save_model("w8a8", "mito", decoder, root / "w8a8.model")
    return root


@pytest.fixture
def small_backbone(monkeypatch):
    monkeypatch.setattr(DinoV2Config, "giant", classmethod(lambda cls: cls(**SMALL)))


def test_cli_features_int8_writes_features(cli_env, tmp_path, small_backbone):
    """``features --int8 --device cpu``: the reference layout, within
    relative L2 0.05 of the default's features and not equal to them."""
    tomos = str(cli_env / "tomos")
    for flags, out in (([], "plain"), (["--int8"], "int8")):
        assert main(["features", tomos, str(tmp_path / out), "--random-init", "--batch-size",
                     "3", "--device", "cpu", *flags]) == 0
    with h5py.File(tmp_path / "plain" / "t.hdf") as f, h5py.File(tmp_path / "int8" / "t.hdf") as g:
        want, got = (np.asarray(h["dino_features"], np.float64) for h in (f, g))
    assert got.shape == want.shape == (128, 4, 4, 5)
    assert not np.array_equal(got, want) and _rel(got, want) <= 0.05


def test_cli_infer_fused_int8_writes_masks(cli_env, tmp_path, small_backbone):
    """``infer --fused --int8 --device cpu`` writes uint8 masks; without
    ``--fused``, ``--int8`` raises the JAX package's error."""
    tomos, model = str(cli_env / "tomos"), str(cli_env / "w8a8.model")
    assert main(["infer", tomos, "--model", model, "--fused", "--int8", "--random-init",
                 "--result-folder", str(tmp_path / "masks"), "--device", "cpu"]) == 0
    with h5py.File(tmp_path / "masks" / "t.hdf") as f:
        masks = np.asarray(f["mito_preds"])
    assert masks.dtype == np.uint8 and masks.shape == (4, 56, 70)
    assert set(np.unique(masks)) <= {0, 1}
    with pytest.raises(ValueError, match="requires fused=True"):
        main(["infer", tomos, "--model", model, "--int8", "--device", "cpu"])
