"""The int8 internals of the port's pair attention (``flash_attention(quant=
...)``) against the JAX ``flash_attention_pairs(quant=...)``, and the port's
DINOv2 with ``pair_attention_fn`` against the JAX DinoV2 with the same field.

Inputs and weights are drawn with numpy; on the CPU the port runs its plain
version and the JAX side its Pallas kernel in interpret mode.

Plain random inputs cannot tell the int8 modes from bf16 (the JAX kernel's
own test sees 0.002 relative L2 between them), so the kernel-level inputs
carry outliers: q rows ≡ 3 (mod 64), key 7 and value row 11 scaled by 16.
The per-chunk q scale then moves the output by more than 3× the limit when
the chunk height is wrong.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import INT8_ROW_RMS, row_rms
from test_torch_models import randomize, to_torch

from cryovit_tpu.models.dinov2 import DinoV2 as JaxDinoV2
from cryovit_tpu.models.dinov2 import DinoV2Config as JaxDinoV2Config
from cryovit_tpu.ops import flash_attention as jfa
from cryovit_tpu_torch.convert import dinov2_from_jax
from cryovit_tpu_torch.models.dinov2 import DinoV2, DinoV2Config, assign_weights
from cryovit_tpu_torch.ops import flash_attention as fa

MODES = ("qk", "pv", "qkpv")
# port against JAX, relative L2 on the outlier inputs (measured: qk 0.016,
# pv 0.008, qkpv 0.019: the TPU kernel takes exp2 in bf16 of a bf16-rounded
# difference, the port in f32 before rounding p to bf16, which moves some
# p·127 across a rounding boundary). JAX int8 is 0.087-0.157 from JAX bf16.
KERNEL_LIMIT = 0.025


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16_np(x):
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def outliers():
    """B=2, N=520 (17 chunks of 32 rows), 4 heads of 64, true_len 515, q
    pre-scaled by 64^-½·log2 e (and its bias), as the JAX model passes it;
    bf16 values as f32 numpy arrays."""
    rng = np.random.default_rng(42)
    b, n, c, d = 2, 520, 256, 64
    q, k, v = (rng.standard_normal((b, n, c)) * 0.5 for _ in range(3))
    q *= 4
    q[:, 3::64] *= 16
    k[:, 7] *= 16
    v[:, 11] *= 16
    bias = rng.standard_normal((3, c)) * 0.1
    fold = d**-0.5 * jfa.LOG2E
    q, k, v, bias = (_bf16_np(x) for x in (q, k, v, bias))
    q, bias[0] = _bf16_np(q * fold), _bf16_np(bias[0] * fold)
    kw = dict(pre_scaled=True, exp2_bf16=True, channel_major=True, interpret=True,
              true_len=515, kv_bias=jnp.asarray(bias, jnp.bfloat16).reshape(3, 2, 128))
    args = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    bf16 = np.asarray(jfa.flash_attention_pairs(*args, **kw)[:, :515], np.float64)
    return dict(np=(q, k, v, bias), jax=(args, kw), bf16=bf16)


@pytest.mark.parametrize("quant", MODES)
def test_int8_attention_matches_jax(outliers, quant):
    """The port's plain int8 attention within KERNEL_LIMIT relative L2 of
    the JAX kernel, on inputs where JAX int8 is at least 3× that from JAX
    bf16. q is passed pre-scaled to both (the port's scale 1/log2 e), so the
    int8 values are the same."""
    args, kw = outliers["jax"]
    want = np.asarray(jfa.flash_attention_pairs(*args, quant=quant, **kw)[:, :515], np.float64)
    assert _rel(want, outliers["bf16"]) >= 3 * KERNEL_LIMIT
    q, k, v, bias = (torch.from_numpy(x).bfloat16() for x in outliers["np"])
    got = fa.flash_attention(q, k, v, bias, 4, 515, scale=1 / jfa.LOG2E, quant=quant)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert _rel(got.float().numpy()[:, :515], want) <= KERNEL_LIMIT


def _next_chunk_sq(scales):
    sq, sk, sv = scales
    return torch.cat([sq[..., 1:], sq[..., -1:]], dim=-1), sk, sv


def _sv_per_head(scales):
    sq, sk, sv = scales
    return sq, sk, sv.amax(dim=-1, keepdim=True).expand_as(sv)


@pytest.mark.parametrize("quant,fault", [("qk", _next_chunk_sq), ("qkpv", _next_chunk_sq),
                                         ("pv", _sv_per_head), ("qkpv", _sv_per_head)])
def test_int8_row_limit_catches_planted_faults(monkeypatch, quant, fault):
    """The limit that holds the int8 kernel to its plain version row by row
    (INT8_ROW_RMS) is far below what a fault in the scales does: q rows
    quantized with the next chunk's scale, or one v scale per head instead of
    per column, planted in the plain version, on the CUDA tests' outlier
    inputs (q ×4, rows ≡ 3 mod 64, key 7 and value row 11 ×16)."""
    rng = np.random.default_rng(7)
    b, n, heads = 1, 1029, 2  # 11 q chunks of 96 rows
    c = heads * fa.HEAD_DIM
    qkv = rng.standard_normal((b, n, 3 * c))
    qkv[..., :c] *= 4
    qkv[:, 3::64, :c] *= 16
    qkv[:, 7, c : 2 * c] *= 16
    qkv[:, 11, 2 * c :] *= 16
    qkv = torch.from_numpy(qkv).bfloat16()
    q, k, v = qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :]
    bias = torch.from_numpy(rng.standard_normal((3, c)) * 0.5).bfloat16()
    want = fa.flash_attention(q, k, v, bias, heads, quant=quant)
    real = fa.attention_int8_scales_reference
    monkeypatch.setattr(fa, "attention_int8_scales_reference",
                        lambda *a, **kw: fault(real(*a, **kw)))
    got = fa.flash_attention(q, k, v, bias, heads, quant=quant)
    assert row_rms(got, want) >= 3 * INT8_ROW_RMS


def _outlier_inputs(rng, b, n, heads):
    """q, k, v (bf16 column views of one projection) and bias with the
    CUDA tests' outliers: q ×4, rows ≡ 3 (mod 64) ×16, key 7 and value row 11
    ×16."""
    c = heads * fa.HEAD_DIM
    qkv = rng.standard_normal((b, n, 3 * c))
    qkv[..., :c] *= 4
    qkv[:, 3::64, :c] *= 16
    qkv[:, 7, c : 2 * c] *= 16
    qkv[:, 11, 2 * c :] *= 16
    qkv = torch.from_numpy(qkv).bfloat16()
    bias = torch.from_numpy(rng.standard_normal((3, c)) * 0.5).bfloat16()
    return qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :], bias


def test_pv_key_positions_follow_the_wgmma_fragments():
    """The int8 Vᵀ key order, derived here from the PTX ISA's fragment
    layouts: thread t of a row quad holds the s32 scores of keys 8m + 2t + e
    (n-tile m, e = 0, 1) of each 32-key step, the kernel packs n-tiles 0, 1
    into A registers 0, 1 and n-tiles 2, 3 into registers 2, 3 (low byte
    first), and the 8-bit A fragment's register j holds k indices
    16·(j // 2) + 4t .. + 3. Key and k index must meet in Vᵀ."""
    want = {}
    for t in range(4):
        for m in range(4):
            for e in range(2):
                reg = 2 * (m // 2)  # the row-g register of that pair of n-tiles
                byte = 2 * (m % 2) + e
                want[8 * m + 2 * t + e] = 16 * (reg // 2) + 4 * t + byte
    pos = fa.pv_key_positions(96)
    assert pos[:32].tolist() == [want[j] for j in range(32)]
    assert (pos[32:64] - 32).tolist() == pos[:32].tolist() == (pos[64:] - 64).tolist()
    assert sorted(pos.tolist()) == list(range(96))


def _attention_from_operands(q, bias, heads, true_len, quant, scales, k_op, v_op):
    """The plain int8 attention (``_int8_attention``'s formulas) recomputed
    from the pre-pass's operands: the padding cut off and Vᵀ's keys put back
    in order through pv_key_positions."""
    b, n, c = q.shape
    d = c // heads
    kv_len = n if true_len is None else true_len
    scale_log2 = d**-0.5 * fa._LOG2E
    sq, sk, sv = scales
    qh = (q + bias[0]).float().reshape(b, n, heads, d)
    keys = k_op[:, :, :kv_len].float().transpose(1, 2).contiguous()  # (B, kv, H, D)
    if "qk" in quant:
        sq_rows = sq[:, :, torch.arange(n) // fa.q_chunk_rows(n)]
        qi = torch.round(qh * (1.0 / sq_rows.transpose(1, 2)[..., None].clamp_min(1e-20)))
        s = torch.einsum("bqhd,bkhd->bhqk", qi, keys)
        s = s * ((sq_rows * sk[:, :, None]) * scale_log2)[..., None]
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", qh, keys) * scale_log2
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True)).to(torch.bfloat16).float()
    if "pv" in quant:
        order = fa.pv_key_positions(v_op.shape[-1])
        vi = v_op[..., order][..., :kv_len].double().permute(0, 3, 1, 2)  # (B, kv, H, D)
        pi = torch.round(p * 127.0).double()
        num = torch.einsum("bhqk,bkhd->bqhd", pi, vi).float() * (sv * fa._INV127)[:, None]
        denom = (pi.sum(dim=-1) * 127.0).float() * fa._ONES_DEQUANT
        out = num * (1.0 / denom.transpose(1, 2))[..., None]
    else:
        vals = v_op[:, :, :kv_len].float().transpose(1, 2)
        denom = p.sum(dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, vals) * (1.0 / denom.transpose(1, 2))[..., None]
    return out.reshape(b, n, c).to(q.dtype)


@pytest.mark.parametrize("quant", MODES)
@pytest.mark.parametrize("n,true_len", [(200, 195), (256, None)])
def test_int8_operands_rebuild_the_plain_attention_bit_for_bit(quant, n, true_len):
    """The plain twin of the pre-pass's K and V operands: int8 where the
    mode quantizes (else bf16 with the bias), keys padded to KEY_TILE, zero
    at or past true_len, int8 Vᵀ in pv_key_positions order; the plain
    attention recomputed from them equals flash_attention_reference bit for
    bit (N not a multiple of 64 with a ragged true_len, and a whole one)."""
    rng = np.random.default_rng(11)
    heads = 2
    q, k, v, bias = _outlier_inputs(rng, 2, n, heads)
    kv_len = n if true_len is None else true_len
    n_pad = -(-n // fa.KEY_TILE) * fa.KEY_TILE
    scales = fa.attention_int8_scales_reference(q, k, v, bias, heads, true_len, quant)
    k_op, v_op = fa.attention_int8_operands(q, k, v, bias, heads, true_len, quant)
    k_dtype = torch.int8 if "qk" in quant else torch.bfloat16
    assert k_op.dtype == k_dtype and k_op.shape == (2, heads, n_pad, fa.HEAD_DIM)
    if "pv" in quant:
        assert v_op.dtype == torch.int8 and v_op.shape == (2, heads, fa.HEAD_DIM, n_pad)
        past = v_op[..., fa.pv_key_positions(n_pad)[kv_len:]]
    else:
        assert v_op.dtype == torch.bfloat16 and v_op.shape == (2, heads, n_pad, fa.HEAD_DIM)
        past = v_op[:, :, kv_len:]
    assert not k_op[:, :, kv_len:].float().any() and not past.float().any()
    if "qk" in quant:
        assert k_op.abs().max() == 127  # the scale's own element
    got = _attention_from_operands(q, bias, heads, true_len, quant, scales, k_op, v_op)
    want = fa.flash_attention_reference(q, k, v, bias, heads, true_len, quant=quant)
    assert torch.equal(got, want)


def test_q_chunks_follow_the_tpu_block_choice():
    """The rows sharing a q scale are the JAX wrapper's automatic chunks
    under quant (``_auto_blocks(n, chq=32)``) at every length, and the int8
    path ends where JAX's does: 5856 tokens fit one key block, 5857 not."""
    for n in list(range(1, 1400)) + list(range(1400, 5857, 37)) + [4101, 5856]:
        bq, _, qc = jfa._auto_blocks(n, chq=32)
        assert fa.q_chunk_rows(n) == bq // qc, n
    assert [fa.q_chunk_rows(n) for n in (1029, 4101, 520)] == [96, 160, 32]
    with pytest.raises(NotImplementedError):
        jfa.flash_attention_pairs(*(jnp.zeros((1, 5857, 128), jnp.bfloat16),) * 3,
                                  channel_major=True, quant="qk", interpret=True)
    with pytest.raises(NotImplementedError, match="single-K-block"):
        fa.q_chunk_rows(5857)


def test_q_scales_take_the_padded_rows_of_the_last_chunk():
    """Rows from N to the last chunk's end are the TPU kernel's zero pad
    plus b_q: a q bias larger than every real row sets that chunk's scale
    and no other; k and v scales ignore the keys at or past true_len."""
    b, n, c = 1, 40, 128  # chunks of 64 rows: rows 40..63 are padding
    q = torch.full((b, n, c), 0.5)
    q[..., 5] = -2.0  # q + b_q is 0 there: only the padding rows see the bias
    k = torch.full((b, n, c), 0.25)
    k[:, 30:] = 8.0  # past true_len
    v = torch.ones(b, n, c)
    v[:, 30:] = 8.0
    bias = torch.zeros(3, c)
    bias[0, 5] = 2.0  # head 0 only
    assert fa.q_chunk_rows(n) == 64
    sq, sk, sv = fa.attention_int8_scales_reference(q, k, v, bias, 2, true_len=30)
    assert sq.shape == (1, 2, 1) and sk.shape == (1, 2) and sv.shape == (1, 2, 64)
    torch.testing.assert_close(sq[0, :, 0] * 127, torch.tensor([2.0, 0.5]))
    torch.testing.assert_close(sk * 127, torch.full((1, 2), 0.25))
    torch.testing.assert_close(sv * 127, torch.ones(1, 2, 64))
    sq, sk, sv = fa.attention_int8_scales_reference(q, k, v, bias, 2, true_len=30, quant="pv")
    assert sq.numel() == sk.numel() == 0 and sv.shape == (1, 2, 64)


def test_quant_modes_are_checked():
    """An unknown mode raises on every device; so does a length past the
    single-key-block limit, in every mode; no int8 call falls back to bf16."""
    q = torch.zeros(1, 8, 128)
    bias = torch.zeros(3, 128)
    for bad in ("int8", "kq", "QK"):
        with pytest.raises(ValueError, match="unknown quant mode"):
            fa.flash_attention(q, q, q, bias, 2, quant=bad)
        with pytest.raises(ValueError, match="unknown quant mode"):
            fa.flash_attention(q.to("meta"), q, q, bias, 2, quant=bad)
    long = torch.zeros(1, 5857, 64)
    for quant in MODES:
        with pytest.raises(NotImplementedError, match="single-K-block"):
            fa.flash_attention(long, long, long, torch.zeros(3, 64), 1, quant=quant)
    with pytest.raises(ValueError, match="needs a quant mode"):
        fa.attention_int8_scales(q, q, q, bias, 2, quant="")
    with pytest.raises(ValueError, match="needs a quant mode"):
        fa.attention_int8_operands(q, q, q, bias, 2, quant="")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.int8_pass_clocks(q, q, q, bias, 2, "qk")


# ---- the model: DinoV2(pair_attention_fn=partial(flash_attention, quant=m)) -


CFG = dict(embed_dim=128, depth=2, num_heads=2, ffn_hidden=112, pos_grid=4)
# port against JAX on the features, relative L2 (measured 4.6e-6 to 7.5e-6
# in f32: the folded q scale rounds differently); JAX int8 is 3.1e-4 to
# 4.6e-4 from JAX f32, a q chunk of 32 rows instead of 160 3.5e-4 to 4.4e-4
MODEL_LIMIT = 5e-5


@pytest.fixture(scope="module")
def dino_weights():
    """f32 weights of CFG, LayerScale 0.5 (the drawn ~0.1 keeps the blocks'
    updates small), and two 378×238 slices: 27×17 patches, 464 tokens, 3 q
    chunks of 160 rows. 464 is a multiple of 16, so the JAX model pads no
    token rows (the port never does) and both see the same chunks."""
    rng = np.random.default_rng(0)
    x = rng.random((2, 378, 238)).astype(np.float32)
    jmodel = JaxDinoV2(cfg=JaxDinoV2Config(**CFG), dtype=jnp.float32,
                       pair_attention_fn=partial(jfa.flash_attention_pairs, interpret=True))
    variables = randomize(jmodel.init(jax.random.key(0), jnp.asarray(x)), rng)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: np.full_like(a, 0.5) if "gamma" in str(path[-1]) else a, variables)
    f32 = np.asarray(jmodel.apply(variables, jnp.asarray(x)), np.float64)
    return x, variables, f32


@pytest.mark.parametrize("quant", MODES)
def test_dinov2_int8_attention_matches_jax(dino_weights, quant):
    """``DinoV2(pair_attention_fn=partial(flash_attention, quant=m))``, built
    on the meta device and given the weights as ``make_dinov2`` does, against
    the JAX ``DinoV2(pair_attention_fn=partial(flash_attention_pairs,
    quant=m, interpret=True))`` on the same f32 weights."""
    x, variables, f32 = dino_weights
    jmodel = JaxDinoV2(cfg=JaxDinoV2Config(**CFG), dtype=jnp.float32,
                       pair_attention_fn=partial(jfa.flash_attention_pairs, quant=quant,
                                                 interpret=True))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)), np.float64)
    assert _rel(want, f32) >= 3 * MODEL_LIMIT
    with torch.device("meta"):
        model = DinoV2(DinoV2Config(**CFG), pair_attention_fn=partial(fa.flash_attention,
                                                                      quant=quant))
    model = assign_weights(model, to_torch(dinov2_from_jax(variables)), "cpu", torch.float32)
    assert all(blk.attn.pair_attention_fn.keywords == {"quant": quant} for blk in model.blocks)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).double().numpy()
    assert got.shape == want.shape == (2, 27 * 17, 128)
    assert _rel(got, want) <= MODEL_LIMIT
