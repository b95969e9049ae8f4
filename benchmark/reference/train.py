"""Plain training steps for the benchmark's check: the masked soft Dice loss
(VivianDLi/CryoVIT ``src/cryovit/models/losses.py``), and AdamW
(``torch.optim.AdamW``, β 0.9 / 0.999, ε 1e-8, decoupled weight decay) in
float32 with TF32 off, from the same initial weights and crops as the
program.

``fp8_operands`` is the control's precision, as float8 training runs it:
every product's input and weight rounded to float8 e4m3 with a per-tensor
scale (its largest magnitude to 448), and the gradient that flows back
through each of them rounded to float8 e5m2 (its largest magnitude to
57344).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_exact():
    """float32 products with TF32 off, restored on exit."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = top / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(dtype).to(t.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8_operands(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)


def dice_loss(probs: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """``1 − 2·Σ(y·p) / (Σy + Σp + 1e-3)`` over the labelled voxels (y > −1)."""
    mask = (label > -1).to(probs.dtype)
    y = label.to(probs.dtype) * mask
    p = probs * mask
    return 1.0 - 2.0 * (y * p).sum() / (y.sum() + p.sum() + 1e-3)


def run_steps(model: torch.nn.Module, inputs, labels, opt: dict, first_steps: int) -> dict:
    """``first_steps`` AdamW steps of ``model`` on ``inputs[i]`` /
    ``labels[i]``. Returns each step's loss, each leaf's gradient norm at
    the first step, and each leaf's change after the last step."""
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    adam = torch.optim.AdamW(params.values(), lr=opt["lr"], betas=tuple(opt["betas"]),
                             eps=opt["eps"], weight_decay=opt["weight_decay"], foreach=False)
    losses, grads = [], {}
    with float32_exact():
        for i in range(first_steps):
            adam.zero_grad(set_to_none=True)
            loss = dice_loss(model(inputs[i]), labels[i])
            loss.backward()
            if i == 0:
                grads = {k: p.grad.norm().item() for k, p in params.items()}
            adam.step()
            losses.append(loss.item())
    change = {k: (p.detach() - start[k]).norm().item() for k, p in params.items()}
    return {"losses": losses, "grad_norms": grads, "change_norms": change}
