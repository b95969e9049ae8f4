"""Fused inference (``run/infer_model.fused_predictions`` through a
``FusedDinoCryoVIT``): tomogram files in, probabilities on the host out.

Set-up draws the backbone's and the decoder's weights on the device from
the seed, in the compute dtype, hands them to the port's constructors
(``make_dinov2``, ``make_cryovit``), writes the traffic's tomograms as MRC
files under ``TMPDIR`` in a seeded order, and warms up every shape the
traffic uses: the backbone at the slice batch and each tail batch, the
decoder at each depth. The window is one closed-loop stream cycling the
files; it closes at the end of the first whole cycle of them completed
after ``--seconds``, so that every window holds the same work.

The check: one tomogram of the first cycle, drawn from the seed, against
the plain reference (``reference/infer.py``), which reads the same file and
redraws the same weights.
"""

from __future__ import annotations

import itertools
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from harness import checks, clock, files
from harness import traffic as T
from harness import weights as W
from harness.trace import BACKBONE_SPAN
from reference.cryovit import CryoVIT as RefDecoder
from reference.dinov2 import DinoV2 as RefBackbone

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
UNITS = {"slices_per_s": "slices/s"}


def _draw(cfg: dict, seed: int, device, dtype):
    with torch.device("meta"):
        shapes_b = W.shapes_of(RefBackbone(cfg))
        shapes_d = W.shapes_of(RefDecoder(cfg))
    backbone = W.draw(shapes_b, cfg["init"]["backbone"], T.generator(seed, 1, device), dtype)
    decoder = W.draw(shapes_d, cfg["init"]["decoder"], T.generator(seed, 2, device), dtype)
    return backbone, decoder


class Job:
    def __init__(self, cell: dict, seed: int, device, control: bool = False,
                 fault: str | None = None):
        from cryovit_tpu_torch.data.transforms import dino_device_preprocess
        from cryovit_tpu_torch.models.cryovit import make_cryovit
        from cryovit_tpu_torch.models.dinov2 import DinoV2Config, make_dinov2
        from cryovit_tpu_torch.models.fused import FusedDinoCryoVIT
        from cryovit_tpu_torch.run.infer_model import fused_predictions

        self.cfg, self.mix, self.seed, self.device = cell["config_spec"], cell["traffic_spec"], seed, device
        cfg, mix = self.cfg, self.mix
        dtype = DTYPES[cfg["precision"]]
        bsd, dsd = _draw(cfg, seed, device, dtype)
        dino = DinoV2Config(
            patch_size=cfg["patch_size"], embed_dim=cfg["embed_dim"], depth=cfg["depth"],
            num_heads=cfg["num_heads"], ffn_hidden=cfg["ffn_hidden"],
            num_registers=cfg["num_register_tokens"],
            pos_grid=cfg["img_size"] // cfg["patch_size"],
            layer_norm_eps=cfg["layer_norm_eps"], in_channels=cfg["in_chans"])
        self.control = control
        backbone = make_dinov2(bsd, dino, device, dtype)
        decoder = make_cryovit(dsd, device, dtype)
        del bsd, dsd
        self.fused = FusedDinoCryoVIT(backbone, decoder, slice_batch=mix["slice_batch"])
        clock.mark("weights drawn and handed to the program")

        self.dir = Path(tempfile.mkdtemp(prefix="bench-tomograms-"))
        self.depths = T.order(seed, 3, list(mix["depths"]) * mix["copies"])
        gen = T.generator(seed, 4, device)
        self.paths = []
        for i, d in enumerate(self.depths):
            vol, _ = T.blob_volume(gen, d, mix["side"], mix)
            path = self.dir / f"tomogram_{i:02d}.mrc"
            T.write_mrc_int8(path, vol)
            self.paths.append(path)
        del vol
        clock.mark("tomograms written")
        self.check_index = int(np.random.default_rng(T.sub_seed(seed, 5)).integers(len(self.paths)))

        side, sb = mix["side"], mix["slice_batch"]
        grid = side // 16
        with torch.inference_mode():
            for b in sorted({sb} | {d % sb for d in self.depths} - {0}):
                backbone(dino_device_preprocess(torch.zeros((b, side, side), device=device)))
            for d in sorted(set(self.depths)):
                decoder(torch.zeros((1, d, grid, grid, cfg["embed_dim"]), device=device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        clock.mark("warmed up")

        if fault == "altered_answer":
            segment = self.fused.segment

            def altered(slices):
                probs = segment(slices).clone()
                probs[probs.shape[0] // 2] = 1.0 - probs[probs.shape[0] // 2]
                return probs

            self.fused.segment = altered
        elif fault is not None:
            raise ValueError(f"no fault {fault!r} for fused inference")
        self.stream = fused_predictions(itertools.cycle(self.paths), self.fused)
        self.done = 0
        self.kept = None
        self._hooks = []

    def spans(self):
        """The benchmark's span around the backbone's forward (traced runs)."""
        from torch.profiler import record_function

        backbone = self.fused.backbone
        stack = []

        def enter(module, args):
            rf = record_function(BACKBONE_SPAN)
            rf.__enter__()
            stack.append(rf)

        def leave(module, args, out):
            stack.pop().__exit__(None, None, None)

        self._hooks = [backbone.register_forward_pre_hook(enter),
                       backbone.register_forward_hook(leave)]

    def _unit(self) -> int:
        result = next(self.stream)
        if self.done == self.check_index:
            self.kept = result.preds[0]
        self.done += 1
        return result.data[0].shape[0]

    def window(self, seconds: float | None = None, units: int | None = None) -> dict:
        """Tomograms until ``units`` are done, or until the first whole
        cycle of the files completed after ``seconds``; each is complete
        (its probabilities on the host) when the stream yields it."""
        first = self.done
        slices = 0
        t0 = time.perf_counter()
        while True:
            slices += self._unit()
            t_last = time.perf_counter()
            n = self.done - first
            if units is not None:
                if n >= units:
                    break
            elif t_last - t0 >= seconds and n % len(self.paths) == 0:
                break
        depths = [self.depths[i % len(self.depths)] for i in range(first, self.done)]
        return {"units": n, "depths": depths, "elapsed_s": t_last - t0,
                "metrics": {"slices_per_s": slices / (t_last - t0)}}

    def work(self, window: dict) -> dict:
        flops = files.load_module("flops", self.cfg["name"])
        work = flops.infer_work(self.cfg, window["depths"], self.mix["side"], self.mix["slice_batch"])
        work["slices"] = sum(window["depths"])
        return work

    def finish_units(self) -> None:
        """Run on, untimed, until the checked tomogram is done (a short
        window may close before it)."""
        while self.kept is None:
            self._unit()

    def release(self) -> None:
        for h in self._hooks:
            h.remove()
        self.stream.close()
        del self.stream, self.fused
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, operands) -> np.ndarray:
        from reference import infer
        from reference.dinov2 import round_operands

        cfg = self.cfg
        with torch.device("meta"):
            backbone, decoder = RefBackbone(cfg), RefDecoder(cfg)
        bsd, dsd = _draw(cfg, self.seed, self.device, DTYPES[cfg["precision"]])
        backbone.load_state_dict({k: v.float() for k, v in bsd.items()}, assign=True)
        decoder.load_state_dict({k: v.float() for k, v in dsd.items()}, assign=True)
        del bsd, dsd
        round_operands(backbone, operands)
        decoder.round_operands = operands
        return infer.segment(self.paths[self.check_index], backbone.eval(), decoder.eval(),
                             self.device)

    def check(self) -> dict[str, float]:
        """``prob_gap`` of the checked tomogram (``checks.slice_gap``); the
        control puts the reference with float8 operands in the program's
        place."""
        from reference.train import fp8_operands

        probs = self._reference(fp8_operands) if self.control else self.kept
        return {"prob_gap": checks.slice_gap(probs, self._reference(lambda t: t))}

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
