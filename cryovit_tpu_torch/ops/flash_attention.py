"""Multi-head attention for DINOv2, on one Hopper kernel body
(``csrc/attention_sm90.cu``: wgmma products on TMA-loaded tiles, shared with
the Hiera global attention) with three wrappers.

- :func:`flash_attention`: counterpart of
  ``cryovit_tpu/ops/flash_attention.py:flash_attention_pairs`` in its
  channel-major form. q, k and v arrive in the qkv projection's natural
  ``(B, N, H·D)`` layout (column views of one fused projection are fine),
  the biases are added inside, keys at or past ``true_len`` are excluded,
  and the output comes back as ``(B, N, H·D)`` — no transposes around the
  call. The TPU kernel's head pairing into 128-lane planes and its token pad
  to ``preferred_len`` are TPU layout devices and have no counterpart here:
  the CUDA kernel masks its own ragged tail.
- :func:`flash_attention_bhnd`: counterpart of ``flash_attention_bhnd``
  (Pallas ``_flash_kernel``) on head-major ``(B, H, N, D)``: no bias, the
  softmax denominator summed from the f32 probabilities.
- :func:`flash_attention_bnhd`: counterpart of the JAX package's
  ``flash_attention`` (the same ``_flash_kernel``) on ``(B, N, H, D)``; the
  port's name ``flash_attention`` already belongs to the first wrapper.

Each wrapper takes its plain PyTorch version (``*_reference``) for CPU
tensors, launches the kernel for CUDA tensors or raises, and raises on any
other device. The TPU block sizes (``block_q``, ``block_k``) and
``interpret`` have no meaning here and are not arguments.

:func:`flash_attention`'s ``quant`` modes (``"qk"``, ``"pv"``, ``"qkpv"``)
are the JAX ``flash_attention_pairs(quant=...)`` int8 internals, run by a
``wgmma`` + TMA body on the int8 tensor cores (``csrc/attention_int8_sm90.cu``,
entry ``cryovit_flash_attention_int8``) after a two-launch pre-pass: the
scales (:func:`attention_int8_scales`), then K and V as the body's operands,
biased, quantized where the mode says and written once per head
(:func:`attention_int8_operands`; under ``pv`` V is stored transposed, its
keys permuted as :func:`pv_key_positions` says). Their q scales are taken per
chunk of q rows whose height is the TPU kernel's automatic chunk
(:func:`q_chunk_rows`): part of the numerics, not a tiling choice here.
"""

from __future__ import annotations

import ctypes

import torch

from cryovit_tpu_torch import kernels

__all__ = [
    "HEAD_DIM",
    "KEY_TILE",
    "QUANT_MODES",
    "attention_int8_operands",
    "attention_int8_operands_reference",
    "attention_int8_scales",
    "attention_int8_scales_reference",
    "flash_attention",
    "flash_attention_bhnd",
    "flash_attention_bhnd_reference",
    "flash_attention_bnhd",
    "flash_attention_bnhd_reference",
    "flash_attention_reference",
    "int8_pass_clocks",
    "pv_key_positions",
    "q_chunk_rows",
]

HEAD_DIM = 64  # the head width the CUDA kernel is built for (ViT-g: 24 x 64)
_LOG2E = 1.4426950408889634
QUANT_MODES = ("", "qk", "pv", "qkpv")
# keys per tile of the int8 kernel: its K and V operands hold the keys padded
# to a multiple of it
KEY_TILE = 64
_INV127 = 1.0 / 127.0
# the dequantization factor of V's ones column: its scale 1·(1/127) times
# 1/127, in f32
_ONES_DEQUANT = float(torch.tensor(_INV127) * _INV127)


# The TPU wrapper's automatic block choice, copied from
# cryovit_tpu/ops/flash_attention.py (_round_up, _best_block, _pick_q_chunks,
# _best_block_chunked, _auto_blocks): under quant it fixes the rows that
# share one q scale and the longest sequence the int8 path takes.
def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _best_block(n: int, lo: int = 256, hi: int = 1088) -> int:
    best_waste, best = None, lo
    for b in range(lo, hi + 1, 16):
        waste = _round_up(n, b) - n
        if best_waste is None or waste < best_waste or (waste == best_waste and b > best):
            best_waste, best = waste, b
    return best


def _pick_q_chunks(bq: int, ch_cap: int, chq: int = 16) -> int:
    for c in range(1, bq // chq + 1):
        if bq % c == 0 and (bq // c) % chq == 0 and bq // c <= ch_cap:
            return c
    return 1


def _best_block_chunked(
    n: int, ch_cap: int, lo: int = 256, hi: int = 1088, chq: int = 16
) -> tuple[int, int]:
    best_key, best = None, (min(_round_up(n, chq), hi), 1)
    for ch_min in (min(_round_up(128, chq), ch_cap), chq):
        for bq in range(lo, hi + 1, chq):
            waste = _round_up(n, bq) - n
            for c in range(1, bq // chq + 1):
                ch = bq // c
                if bq % c == 0 and ch % chq == 0 and ch_min <= ch <= ch_cap:
                    key = (waste, -ch, -bq)
                    if best_key is None or key < best_key:
                        best_key, best = key, (bq, c)
                    break  # first divisor = largest chunk for this bq
        if best_key is not None:
            return best
    return best


def _auto_blocks(n: int, chq: int = 16) -> tuple[int, int, int]:
    nk_full = _round_up(n, chq)
    ch_cap = max(chq, min(320, (4_500_000 // (nk_full * 6)) // chq * chq))
    if n <= 1280:
        bq, bk = _round_up(n, chq), nk_full
        qc = _pick_q_chunks(bq, ch_cap, chq)
    elif ch_cap >= 128:
        bq, qc = _best_block_chunked(n, ch_cap, chq=chq)
        bk = nk_full
    else:
        bq, bk = _best_block(n), _best_block(n)
        qc = 1
    return bq, bk, qc


def q_chunk_rows(n: int) -> int:
    """Rows of q that share one int8 scale for ``n`` tokens: the TPU
    kernel's automatic chunk height under quant (``_auto_blocks(n, chq=32)``;
    1029 tokens: 96, 4101: 160). Chunks count from row 0. Raises
    ``NotImplementedError`` where the JAX wrapper does: when the keys do not
    fit one block (from 5857 tokens)."""
    bq, bk, qc = _auto_blocks(n, chq=32)
    if _round_up(n, bk) != bk:
        raise NotImplementedError(
            f"int8 attention internals support the single-K-block path only: {n} tokens "
            "do not fit one key block"
        )
    return bq // qc


def _check_quant(quant: str) -> None:
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}; expected one of {QUANT_MODES}")


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    num_heads: int,
    true_len: int | None = None,
    scale: float | None = None,
    quant: str = "",
) -> torch.Tensor:
    """Plain attention: ``softmax(scale·(q+bq)(k+bk)ᵀ)(v+bv)`` per head.

    q, k, v: ``(B, N, H·D)``; bias: ``(3, H·D)`` rows q, k, v; keys at or
    past ``true_len`` (default N) are excluded; ``scale`` defaults to
    D^-½. The biases are added in the input dtype, the softmax runs in f32
    and the probabilities are rounded to v's dtype before the product with
    v, as in the kernel. Returns ``(B, N, H·D)`` in q's dtype.

    ``quant`` (one of :data:`QUANT_MODES`) takes the int8 internals of the
    JAX ``flash_attention_pairs(quant=...)`` (:func:`_int8_attention`)."""
    _check_quant(quant)
    if quant:
        return _int8_attention(q, k, v, bias, num_heads, true_len, scale, quant)
    b, n, c = q.shape
    kv_len = n if true_len is None else true_len
    scale = (c // num_heads) ** -0.5 if scale is None else scale
    qh = _biased_heads(q, bias[0], num_heads)
    kh = _biased_heads(k, bias[1], num_heads)[:, :kv_len]
    vh = _biased_heads(v, bias[2], num_heads)[:, :kv_len]
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vh)
    return out.reshape(b, n, c).to(q.dtype)


def _int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """The symmetric int8 scale of a tensor part: ``max|x| · (1/127)`` (f32)."""
    return amax * _INV127


def _to_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``round(x · 1/max(scale, 1e-20))``, half to even, no clip (|x| ≤
    127·scale), as f32 values; the reciprocal is taken first, as the TPU
    kernel does."""
    return torch.round(x * (1.0 / scale.clamp_min(1e-20)))


def _biased_heads(x: torch.Tensor, bias_row: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``(B, N, H·D)`` + bias, added in x's dtype, as f32 ``(B, N, H, D)``."""
    b, n, c = x.shape
    return (x + bias_row).float().reshape(b, n, num_heads, c // num_heads)


def attention_int8_scales_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    num_heads: int,
    true_len: int | None = None,
    quant: str = "qkpv",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The f32 int8 scales of :func:`flash_attention`'s ``quant`` modes:

    - ``sq`` ``(B, H, ⌈N/ch⌉)`` under ``qk``: one per chunk of
      ``ch = q_chunk_rows(N)`` rows of q + b_q from row 0. Rows from N up
      to the last chunk's end are the TPU kernel's zero pad plus b_q, so
      |b_q| enters the last chunk's max;
    - ``sk`` ``(B, H)`` under ``qk``: over the keys below ``true_len``;
    - ``sv`` ``(B, H, D)`` under ``pv``: per column of v + b_v over the
      keys below ``true_len`` (the ones column that carries the softmax
      denominator has the exact scale 1/127 and needs no entry).

    Each is ``max|·| · (1/127)`` of the bf16 sums; a mode's unused scales
    are empty."""
    _check_quant(quant)
    b, n, c = q.shape
    kv_len = n if true_len is None else true_len
    ch = q_chunk_rows(n)  # raises beyond the single-key-block limit, in every mode
    empty = q.new_empty(0, dtype=torch.float32)
    sq = sk = sv = empty
    if "qk" in quant:
        pad = _round_up(n, ch) - n
        qp = torch.cat([q, q.new_zeros(b, pad, c)], dim=1)
        qh = _biased_heads(qp, bias[0], num_heads)
        chunks = qh.reshape(b, -1, ch, num_heads, c // num_heads)
        sq = _int8_scale(chunks.abs().amax(dim=(2, 4))).transpose(1, 2).contiguous()
        kh = _biased_heads(k, bias[1], num_heads)[:, :kv_len]
        sk = _int8_scale(kh.abs().amax(dim=(1, 3)))
    if "pv" in quant:
        vh = _biased_heads(v, bias[2], num_heads)[:, :kv_len]
        sv = _int8_scale(vh.abs().amax(dim=1))
    return sq, sk, sv


def _int8_attention(q, k, v, bias, num_heads, true_len, scale, quant):
    """The JAX single-K-block kernel's int8 numerics, in f32 around exact
    integer products (int8·int8 sums of 64 terms are exact in f32; P·V's
    sums over keys are taken in float64, exact below 2^53):

    - ``qk``: s = f32(Σ qi·ki) · ((sq·sk) · scale·log2 e), with qi, ki the
      int8 values of q + b_q (per-chunk scale) and k + b_k (per-head scale);
    - the exact row max m over the keys below ``true_len``, p = 2^(s − m),
      rounded to v's dtype;
    - ``pv``: pi = round(127 p), vi the int8 values of v + b_v (per-column
      scale); out = f32(Σ pi·vi) · (sv/127) over the denominator
      f32(127 Σ pi) · (1/127)² (V's ones column, whose int8 value is 127);
    - otherwise out = Σ p·v / Σ p in f32, from the rounded p."""
    b, n, c = q.shape
    d = c // num_heads
    kv_len = n if true_len is None else true_len
    scale_log2 = (d**-0.5 if scale is None else scale) * _LOG2E
    sq, sk, sv = attention_int8_scales_reference(q, k, v, bias, num_heads, true_len, quant)
    qh = _biased_heads(q, bias[0], num_heads)
    kh = _biased_heads(k, bias[1], num_heads)[:, :kv_len]
    vh = _biased_heads(v, bias[2], num_heads)[:, :kv_len]
    if "qk" in quant:
        sq_rows = sq[:, :, torch.arange(n, device=q.device) // q_chunk_rows(n)]  # (B, H, N)
        qi = _to_int8(qh, sq_rows.transpose(1, 2)[..., None])
        ki = _to_int8(kh, sk[:, None, :, None])
        s = torch.einsum("bqhd,bkhd->bhqk", qi, ki)
        s = s * ((sq_rows * sk[:, :, None]) * scale_log2)[..., None]
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale_log2
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True)).to(v.dtype).float()
    if "pv" in quant:
        pi = torch.round(p * 127.0).double()
        vi = _to_int8(vh, sv[:, None]).double()
        num = torch.einsum("bhqk,bkhd->bqhd", pi, vi).float() * (sv * _INV127)[:, None]
        denom = (pi.sum(dim=-1) * 127.0).float() * _ONES_DEQUANT
        out = num * (1.0 / denom.transpose(1, 2))[..., None]
    else:
        denom = p.sum(dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, vh) * (1.0 / denom.transpose(1, 2))[..., None]
    return out.reshape(b, n, c).to(q.dtype)


def pv_key_positions(n_keys: int, device=None) -> torch.Tensor:
    """Where key j sits in a row of the int8 Vᵀ operand (``n_keys`` a
    multiple of 32): within each 32-key step, key ``8m + 2t + e`` (m, t, e
    in 0..3, 0..3, 0..1) goes to ``16·(m // 2) + 4t + 2·(m % 2) + e``. In the
    kernel, thread t of a row quad holds the scores of keys 8m + 2t + e of
    the step, and the 8-bit ``wgmma`` A fragment takes k indices 4t..4t+3
    and 16+4t..16+4t+3 from it (``csrc/attention_int8_sm90.cu:pv_slot``):
    Vᵀ stored in that order makes both operands agree on the order of the
    sum, which is exact."""
    j = torch.arange(n_keys, device=device)
    w = j % 32
    m, t, e = w // 8, (w // 2) % 4, w % 2
    return j - w + 16 * (m // 2) + 4 * t + 2 * (m % 2) + e


def attention_int8_operands_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    num_heads: int,
    true_len: int | None = None,
    quant: str = "qkpv",
    scales: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 kernel's K and V operands, as the pre-pass writes them:
    keys padded with zeros to ``n_pad = KEY_TILE·⌈N/KEY_TILE⌉``, keys at or
    past ``true_len`` zero too.

    - K ``(B, H, n_pad, D)``: under ``qk`` int8 ``round((k + b_k) / sk)``
      (:func:`_int8_attention`'s ki), else bf16 ``k + b_k``;
    - V: under ``pv`` int8 ``round((v + b_v) / sv)`` per column, transposed
      to ``(B, H, D, n_pad)`` with its keys at :func:`pv_key_positions`,
      else bf16 ``v + b_v`` ``(B, H, n_pad, D)``.

    ``scales`` are ``(sq, sk, sv)`` as :func:`attention_int8_scales_reference`
    returns them for the same arguments (computed when None)."""
    _check_quant(quant)
    if not quant:
        raise ValueError("attention_int8_operands needs a quant mode")
    b, n, c = k.shape
    kv_len = n if true_len is None else true_len
    n_pad = _round_up(n, KEY_TILE)
    if scales is None:
        scales = attention_int8_scales_reference(q, k, v, bias, num_heads, true_len, quant)
    _, sk, sv = scales

    def padded(x):  # (B, kv_len, H, D) → (B, H, n_pad, D), zero past kv_len
        x = torch.cat([x, x.new_zeros(b, n_pad - kv_len, *x.shape[2:])], dim=1)
        return x.transpose(1, 2).contiguous()

    kh = _biased_heads(k, bias[1], num_heads)[:, :kv_len]
    vh = _biased_heads(v, bias[2], num_heads)[:, :kv_len]
    if "qk" in quant:
        k_op = padded(_to_int8(kh, sk[:, None, :, None]).to(torch.int8))
    else:
        k_op = padded(kh.to(torch.bfloat16))
    if "pv" in quant:
        vi = padded(_to_int8(vh, sv[:, None]).to(torch.int8)).transpose(2, 3)
        v_op = torch.empty_like(vi)
        v_op[..., pv_key_positions(n_pad, vi.device)] = vi
    else:
        v_op = padded(vh.to(torch.bfloat16))
    return k_op, v_op


def _check_cuda_args(q, k, v, bias, num_heads, kv_len) -> None:
    tensors = {"q": q, "k": k, "v": v, "bias": bias}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the attention kernel takes bf16; {name} is {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, N, C) shape: {q.shape}, {k.shape}, {v.shape}")
    b, n, c = q.shape
    if c != num_heads * HEAD_DIM:
        raise ValueError(f"the kernel needs head dim {HEAD_DIM}: C={c}, heads={num_heads}")
    if k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError("q, k and v must share strides")
    if q.stride(2) != 1 or q.stride(1) % 8 or q.stride(0) % 8 or q.stride(1) < c:
        raise ValueError(f"unsupported q/k/v strides {q.stride()}: the kernels (TMA loads in "
                         "bf16) need a unit column stride and row and batch strides that are "
                         "multiples of 8")
    if tuple(bias.shape) != (3, c) or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous (3, {c}) tensor, got {tuple(bias.shape)}")
    if not 1 <= kv_len <= n:
        raise ValueError(f"true_len={kv_len} outside [1, {n}]")
    if b > 65535 or num_heads > 65535:
        raise ValueError("batch and heads must each be at most 65535")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    num_heads: int,
    true_len: int | None = None,
    scale: float | None = None,
    quant: str = "",
) -> torch.Tensor:
    """Attention as :func:`flash_attention_reference` computes it.

    On a CUDA device the Hopper kernel runs: bf16 q/k/v/bias, head dim 64,
    q/k/v sharing strides with a unit column stride (views of one fused qkv
    output qualify) and, for its TMA loads, 16-byte aligned bases and row
    and batch strides that are multiples of 8. A ``quant`` mode runs
    :func:`attention_int8_scales` and then the int8 kernel, up to the
    single-key-block limit of :func:`q_chunk_rows`. Anything they cannot
    take raises; they never fall back."""
    _check_quant(quant)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, num_heads, true_len, scale, quant)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    b, n, c = q.shape
    kv_len = n if true_len is None else true_len
    scale_log2 = float((HEAD_DIM**-0.5 if scale is None else scale) * _LOG2E)
    _check_cuda_args(q, k, v, bias, num_heads, kv_len)
    lib = kernels.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    if quant:
        _launch_int8(q, k, v, bias, num_heads, kv_len, scale_log2, quant, out)
        return out
    rc = lib.cryovit_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, n, num_heads, q.stride(1), q.stride(0), kv_len,
        scale_log2, stream,
    )
    kernels.check(rc, "flash_attention")
    kernels.count_launch("flash_attention")
    return out


def _mode(quant: str) -> int:
    """The kernels' mode bits: 1 for int8 Q·Kᵀ, 2 for int8 P·V."""
    return ("qk" in quant) | ("pv" in quant) << 1


def _launch_int8(q, k, v, bias, num_heads, kv_len, scale_log2, quant, out, clocks=None):
    """The pre-pass (scales, then operands) and the int8 attention into
    ``out``; ``clocks``: None, or a zeroed int64 tensor of 2 that receives the
    SM clocks of consumer warpgroup 0 in pass 1 and pass 2, summed over the
    blocks (see :func:`int8_pass_clocks`)."""
    b, n, _ = q.shape
    scales = _launch_scales(q, k, v, bias, num_heads, kv_len, quant)
    k_op, v_op = _launch_operands(k, v, bias, num_heads, kv_len, quant, scales)
    sq, sk, sv = scales
    rc = kernels.load_library().cryovit_flash_attention_int8(
        q.data_ptr(), bias.data_ptr(), sq.data_ptr(), sk.data_ptr(), sv.data_ptr(),
        k_op.data_ptr(), v_op.data_ptr(), out.data_ptr(),
        None if clocks is None else clocks.data_ptr(), b, n, num_heads, q.stride(1),
        q.stride(0), kv_len, q_chunk_rows(n), sq.shape[-1],
        k_op.shape[2], scale_log2, _mode(quant), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(rc, "flash_attention_int8")
    kernels.count_launch("flash_attention_int8")


def _launch_operands(k, v, bias, num_heads, kv_len, quant, scales):
    b, n, _ = k.shape
    n_pad = _round_up(n, KEY_TILE)
    dev = k.device
    k_op = torch.empty((b, num_heads, n_pad, HEAD_DIM), device=dev,
                       dtype=torch.int8 if "qk" in quant else torch.bfloat16)
    if "pv" in quant:
        v_op = torch.empty((b, num_heads, HEAD_DIM, n_pad), device=dev, dtype=torch.int8)
    else:
        v_op = torch.empty((b, num_heads, n_pad, HEAD_DIM), device=dev, dtype=torch.bfloat16)
    _, sk, sv = scales
    rc = kernels.load_library().cryovit_attention_int8_operands(
        k.data_ptr(), v.data_ptr(), bias.data_ptr(), sk.data_ptr(), sv.data_ptr(),
        k_op.data_ptr(), v_op.data_ptr(), b, num_heads, k.stride(1), k.stride(0), kv_len, n_pad,
        _mode(quant), torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(rc, "flash_attention_int8_operands")
    kernels.count_launch("flash_attention_int8_operands")
    return k_op, v_op


def _launch_scales(q, k, v, bias, num_heads, kv_len, quant):
    b, n, _ = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    empty = torch.empty(0, **f32)
    ch = q_chunk_rows(n)
    sq, sk, sv = empty, empty, empty
    if "qk" in quant:
        sq = torch.empty((b, num_heads, -(-n // ch)), **f32)
        sk = torch.empty((b, num_heads), **f32)
    if "pv" in quant:
        sv = torch.empty((b, num_heads, HEAD_DIM), **f32)
    rc = kernels.load_library().cryovit_attention_int8_scales(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), sq.data_ptr(), sk.data_ptr(),
        sv.data_ptr(), b, n, num_heads, q.stride(1), q.stride(0), kv_len, ch,
        -(-n // ch), _mode(quant), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(rc, "flash_attention_int8_scales")
    kernels.count_launch("flash_attention_int8_scales")
    return sq, sk, sv


def attention_int8_scales(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    num_heads: int,
    true_len: int | None = None,
    quant: str = "qkpv",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int8 scales of :func:`attention_int8_scales_reference`; on a
    CUDA device one launch of the pre-pass kernel that :func:`flash_attention`
    runs before its int8 kernel, with the same argument checks."""
    _check_quant(quant)
    if not quant:
        raise ValueError("attention_int8_scales needs a quant mode")
    if q.device.type == "cpu":
        return attention_int8_scales_reference(q, k, v, bias, num_heads, true_len, quant)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    kv_len = q.shape[1] if true_len is None else true_len
    _check_cuda_args(q, k, v, bias, num_heads, kv_len)
    return _launch_scales(q, k, v, bias, num_heads, kv_len, quant)


def attention_int8_operands(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    num_heads: int,
    true_len: int | None = None,
    quant: str = "qkpv",
    scales: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The K and V operands of :func:`attention_int8_operands_reference`;
    on a CUDA device one launch of the operand pre-pass that
    :func:`flash_attention` runs between its scale pre-pass and its int8
    kernel, on ``scales`` (the scale pre-pass runs first when None), with
    the same argument checks."""
    _check_quant(quant)
    if not quant:
        raise ValueError("attention_int8_operands needs a quant mode")
    if q.device.type == "cpu":
        return attention_int8_operands_reference(q, k, v, bias, num_heads, true_len, quant, scales)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    kv_len = q.shape[1] if true_len is None else true_len
    _check_cuda_args(q, k, v, bias, num_heads, kv_len)
    if scales is None:
        scales = _launch_scales(q, k, v, bias, num_heads, kv_len, quant)
    return _launch_operands(k, v, bias, num_heads, kv_len, quant, scales)


def int8_pass_clocks(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    num_heads: int,
    quant: str,
    true_len: int | None = None,
) -> tuple[int, int]:
    """A measurement aid: one :func:`flash_attention` call on CUDA tensors
    whose kernel also sums, over its blocks, the SM clocks its first
    consumer warpgroup spends in pass 1 (Q·Kᵀ and the row max; 0 without
    int8 P·V) and in pass 2 (the rest). Their shares split the kernel's
    time between the passes."""
    _check_quant(quant)
    if not quant or q.device.type != "cuda":
        raise ValueError("int8_pass_clocks needs a quant mode and CUDA tensors")
    b, n, c = q.shape
    kv_len = n if true_len is None else true_len
    _check_cuda_args(q, k, v, bias, num_heads, kv_len)
    clocks = torch.zeros(2, dtype=torch.int64, device=q.device)
    out = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    _launch_int8(q, k, v, bias, num_heads, kv_len, float(HEAD_DIM**-0.5 * _LOG2E), quant, out,
                 clocks)
    p1, p2 = clocks.tolist()
    return p1, p2


def flash_attention_bhnd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Plain ``_flash_kernel`` math on head-major ``(B, H, N, D)``: f32
    scores scaled by D^-½, ``exp`` of the max-shifted scores, the
    denominator summed from those f32 probabilities, the probabilities
    rounded to v's dtype for the product with v. Returns ``(B, H, N, D)`` in
    q's dtype, laid out as ``(B, N, H, D)`` in memory like the kernel's
    output."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()).mul_(q.shape[-1] ** -0.5)
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()).div_(denom)
    return out.to(q.dtype).transpose(1, 2).contiguous().transpose(1, 2)


def flash_attention_bnhd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Plain ``_flash_kernel`` math on ``(B, N, H, D)``, inputs cast to
    ``dtype`` first as the JAX ``flash_attention`` does; ``(B, N, H, D)`` in
    ``dtype``."""
    q, k, v = (t.to(dtype).transpose(1, 2) for t in (q, k, v))
    return flash_attention_bhnd_reference(q, k, v).transpose(1, 2)


def _check_bhnd_args(q, k, v) -> None:
    for name, t in {"q": q, "k": k, "v": v}.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the attention kernel takes bf16; {name} is {t.dtype}")
        if t.data_ptr() % 16 or t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError(
                f"{name} needs 16-byte aligned rows for TMA (unit last stride, the others "
                f"multiples of 8): strides {t.stride()}"
            )
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one (B, H, N, D) shape: {q.shape}, {k.shape}, {v.shape}"
        )
    b, h, n, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the kernel needs head dim {HEAD_DIM}, got {d}")
    if n < 1 or b > 65535 or h > 65535:
        raise ValueError(f"unsupported shape {tuple(q.shape)}")


def _launch_bhnd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str) -> torch.Tensor:
    """The kernel on ``(B, H, N, 64)`` views: output written in
    ``(B, N, H, 64)`` memory and returned as a ``(B, H, N, 64)`` view."""
    _check_bhnd_args(q, k, v)
    b, h, n, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    lib = kernels.load_library()
    rc = lib.cryovit_flash_attention_strided(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, h,
        (ctypes.c_longlong * 12)(*strides), float(d**-0.5 * _LOG2E),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(rc, name)
    kernels.count_launch(name)
    return out


def flash_attention_bhnd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention on head-major ``(B, H, N, D)`` q, k, v →
    ``(B, H, N, D)``, as :func:`flash_attention_bhnd_reference` computes it.

    On a CUDA device the Hopper kernel runs: bf16, head dim 64, strides that
    TMA takes (a unit last stride, the others multiples of 8, 16-byte
    aligned bases; permuted views of one ``(B, N, 3, H, D)`` projection
    qualify, and are not copied). The result
    is a ``(B, H, N, D)`` view of ``(B, N, H, D)`` memory, so
    ``out.transpose(1, 2).reshape(B, N, H·D)`` is free. Anything the kernel
    cannot take raises; it never falls back."""
    if q.device.type == "cpu":
        return flash_attention_bhnd_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return _launch_bhnd(q, k, v, "flash_attention_bhnd")


def flash_attention_bnhd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Attention on ``(B, N, H, D)`` q, k, v cast to ``dtype`` →
    ``(B, N, H, D)`` contiguous in ``dtype``: the JAX package's
    ``flash_attention`` (named apart here because :func:`flash_attention` is
    the channel-major wrapper). On a CUDA device ``dtype`` must be bf16 and
    the same kernel as :func:`flash_attention_bhnd` runs on the transposed
    views, without copies."""
    if q.device.type == "cpu":
        return flash_attention_bnhd_reference(q, k, v, dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    q, k, v = (t.to(dtype).transpose(1, 2) for t in (q, k, v))
    return _launch_bhnd(q, k, v, "flash_attention_bnhd").transpose(1, 2)
