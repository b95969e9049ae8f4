"""Training steps (``Trainer.train_step`` as ``run/train_model.build_trainer``
and ``build_model`` set it up): one optimizer step a unit, on crops staged
on the device and cycled.

Set-up builds the trainer, the model family and its AdamW from the
configuration's recipe, draws the initial weights on the device from the
seed (f32 masters) and the traffic's crops, and warms up every shape of
the step through the window's own call. It then puts that same trainer
back to the drawn weights, with AdamW's state cleared. The window's first
steps, each on a different crop, are the ones the check compares: each
step's loss, each leaf's first gradient as AdamW holds it after the first
step, and each leaf's change after the last of them, all read on the
device as the window runs, with no synchronize. The window runs on from
there, one ``synchronize`` at its end.

The check runs the plain reference's steps from the same weights on the
same crops (``reference/train.py``) and compares (``harness/checks.py``).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from harness import checks, clock, files
from harness import traffic as T
from harness import weights as W
from reference import train as R
from reference.cryovit import CryoVIT

UNITS = {"train_step_ms": "ms"}


def _draw(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    with torch.device("meta"):
        shapes = W.shapes_of(CryoVIT(cfg))
    return W.draw(shapes, cfg["init"]["decoder"], T.generator(seed, 1, device), torch.float32)


def _crops(cfg: dict, mix: dict, seed: int, device):
    """The crops as the program takes them (``(1, D, H, W, C)``: features on
    the patch grid) and their labels ``(1, D, H, W)``."""
    gen = T.generator(seed, 2, device)
    data, labels = [], []
    g = mix["side"] // 16
    for _ in range(mix["crops"]):
        _, label = T.blob_volume(gen, mix["depth"], mix["side"], mix)
        x = torch.empty((1, mix["depth"], g, g, cfg["embed_dim"]), device=device)
        x.normal_(generator=gen)
        data.append(x)
        labels.append(label[None])
    return data, labels


def _as_reference_input(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)  # (1, D, H, W, C) -> (1, C, D, H, W)


class Job:
    def __init__(self, cell: dict, seed: int, device, control: bool = False,
                 fault: str | None = None):
        from cryovit_tpu_torch.config import TrainConfig
        from cryovit_tpu_torch.run.train_model import build_model, build_trainer

        self.cfg, self.mix, self.seed, self.device = cell["config_spec"], cell["traffic_spec"], seed, device
        self.control = control
        cfg, mix = self.cfg, self.mix
        opt = cfg["optimizer"]
        recipe = TrainConfig.for_model(cfg["family"], label_key="mito", random_seed=seed % 2**31)
        recipe = dataclasses.replace(
            recipe,
            model=dataclasses.replace(recipe.model, lr=opt["lr"], weight_decay=opt["weight_decay"]),
            trainer=dataclasses.replace(recipe.trainer, precision=cfg["precision"]))
        self.trainer = trainer = build_trainer(recipe, device)
        model = build_model(recipe)
        module = model.build_module(_draw(cfg, seed, device), device,
                                    in_channels=cfg["embed_dim"])
        trainer.model, trainer.module, trainer.optimizer = model, module, model.make_optimizer(module)
        clock.mark("trainer built, weights drawn")
        self.data, self.labels = _crops(cfg, mix, seed, device)
        clock.mark("crops drawn")

        self.params = dict(module.named_parameters())
        self.initial = {k: v.detach().clone() for k, v in module.state_dict().items()}
        self.step, self.checked = 0, 0
        for _ in range(mix["warmup_steps"]):
            self._unit()
        # the drawn weights again (copied in place: AdamW keeps its
        # parameters) and AdamW from its first step
        module.load_state_dict(self.initial)
        trainer.optimizer.state.clear()
        self.step, self.checked = 0, mix["first_steps"]
        self._losses, self._grads, self._change = [], {}, {}
        # a fault acts on the window's steps alone
        if fault == "unchanged_state":
            trainer.optimizer.step = lambda *a, **k: None
        elif fault == "half_batch":
            compute_losses = model.compute_losses

            def half(y_pred, y_true, mask, aux=None, mesh=None):
                mask = mask.clone()
                mask[:, mask.shape[1] // 2:] = False
                return compute_losses(y_pred, y_true, mask, aux=aux, mesh=mesh)

            model.compute_losses = half
        elif fault is not None:
            raise ValueError(f"no fault {fault!r} for training")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        clock.mark("warmed up")

    def spans(self):
        """No span: the train cells' readers take kernels by name."""

    def _unit(self) -> dict:
        i = self.step % len(self.data)
        self.step += 1
        logs = self.trainer.train_step(self.data[i], self.labels[i])
        if self.step <= self.checked:
            self._read(logs["train_total"])
        return logs

    def _read(self, loss: torch.Tensor) -> None:
        """A checked step's readings, kept on the device: its loss; after
        the first, each leaf's gradient as AdamW's first moment holds it;
        after the last, each leaf's change from the drawn weights."""
        self._losses.append(loss)
        if self.step == 1:
            state, beta1 = self.trainer.optimizer.state, self.cfg["optimizer"]["betas"][0]
            self._grads = {k: (state[p]["exp_avg"] / (1 - beta1)).norm() if p in state else
                           torch.zeros((), device=self.device) for k, p in self.params.items()}
        if self.step == self.checked:
            self._change = {k: (p.detach() - self.initial[k]).norm()
                            for k, p in self.params.items()}

    def window(self, seconds: float | None = None, units: int | None = None) -> dict:
        """Train steps until ``units`` are done, or until the host's clock
        passes ``seconds``; then one synchronize."""
        n = 0
        t0 = time.perf_counter()
        while True:
            self._unit()
            n += 1
            if (units is not None and n >= units) or (
                    seconds is not None and time.perf_counter() - t0 >= seconds):
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        return {"units": n, "elapsed_s": elapsed,
                "metrics": {"train_step_ms": 1e3 * elapsed / n}}

    def work(self, window: dict) -> dict:
        flops = files.load_module("flops", self.cfg["name"])
        work = flops.train_work(self.cfg, self.mix["depth"], self.mix["side"], window["units"])
        work["steps"] = window["units"]
        return work

    def finish_units(self) -> None:
        """Run on, untimed, until the checked steps are done (a short
        window may close before them), and take their readings to the host."""
        while self.step < self.checked:
            self._unit()
        self.readings = {"losses": [float(v) for v in self._losses],
                         "grad_norms": {k: float(v) for k, v in self._grads.items()},
                         "change_norms": {k: float(v) for k, v in self._change.items()}}

    def release(self) -> None:
        del self.trainer, self.params, self.initial, self._grads, self._change
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, operands) -> dict:
        with torch.device("meta"):
            model = CryoVIT(self.cfg)
        model.load_state_dict(_draw(self.cfg, self.seed, self.device), assign=True)
        model.round_operands = operands
        steps = self.mix["first_steps"]
        inputs = [_as_reference_input(x) for x in self.data[:steps]]
        return R.run_steps(model.train(), inputs, self.labels[:steps], self.cfg["optimizer"],
                           steps)

    def check(self) -> dict[str, float]:
        """``loss_gap``, ``grad_gap`` and ``update_gap``
        (``checks.train_gaps``); the control puts the reference with float8
        operands in the program's place."""
        prog = self._reference(R.fp8_operands) if self.control else self.readings
        values, self.worst_leaves = checks.train_gaps(prog, self._reference(lambda t: t))
        return values

    def close(self) -> None:
        pass
