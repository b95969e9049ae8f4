"""``cryovit-torch`` command-line interface (port of ``cryovit_tpu/cli/main.py``).

The verbs and flags follow the JAX package's ``cryovit``. Ported so far:
``features`` (DINOv2 extraction, and SAM2 pyramids with ``--use-sam``),
``train`` (CryoVIT on DINOv2 features) and ``infer --fused`` (raw tomograms
→ masks). ``evaluate`` and file-based ``infer`` exit with a "not yet
ported" message.

Every verb runs on the GPU unless ``--device cpu`` asks for the CPU (the
port's counterpart of ``JAX_PLATFORMS=cpu``); without a GPU the default
raises rather than falling back to the CPU.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

__all__ = ["main"]

_NOT_PORTED = 2


def _parser() -> argparse.ArgumentParser:
    from cryovit_tpu_torch import __version__
    from cryovit_tpu_torch.types import ModelType

    parser = argparse.ArgumentParser(
        prog="cryovit-torch",
        description="Cryo-electron tomogram segmentation (DINOv2 features + "
        "CryoVIT) on PyTorch and hand-written Hopper kernels.",
    )
    parser.add_argument("--version", action="version", version=f"cryovit_tpu_torch {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("features", help="Compute DINOv2 (or SAM2) features for a set of tomograms.")
    p.add_argument("tomograms", help="Folder or .txt manifest of tomograms to process.")
    p.add_argument("result_folder", help="Folder where the DINO features are saved.")
    p.add_argument("--batch-size", type=int, default=64, help="Slices per extraction step.")
    p.add_argument("--use-sam", action="store_true",
                   help="Extract SAM2 feature pyramids instead of DINOv2.")
    p.add_argument("--random-init", action="store_true", help=argparse.SUPPRESS)

    p = sub.add_parser("infer", help="Segment tomograms with a trained model.")
    p.add_argument("tomograms", help="Folder or .txt manifest of tomograms.")
    p.add_argument("--model", required=True, help="Path to the trained .model file.")
    p.add_argument("--result-folder", default=None)
    p.add_argument("--threshold", type=float, default=0.5,
                   help="Probability threshold for binary segmentation.")
    p.add_argument("--fused", action="store_true",
                   help="Run the fused DINOv2+decoder pipeline directly on raw "
                        "tomograms (CryoVIT models; no feature files needed).")
    p.add_argument("--random-init", action="store_true", help=argparse.SUPPRESS)

    p = sub.add_parser("train", help="Train a segmentation model on annotated tomograms.")
    p.add_argument("train_data", help="Folder or .txt manifest of training tomograms.")
    p.add_argument("train_labels", help="Folder or .txt manifest of label files.")
    p.add_argument("label_key", help="Name of the label to train on.")
    p.add_argument("--labels", nargs="+", required=True,
                   help="Label names in ascending-value order.")
    p.add_argument("--validation-data", default=None)
    p.add_argument("--validation-labels", default=None)
    p.add_argument("--name", default=None, help="Name for the trained model.")
    p.add_argument("--model", default=ModelType.CRYOVIT.value,
                   choices=[m.value for m in ModelType])
    p.add_argument("--result-folder", default=None)
    p.add_argument("--ckpt", default=None,
                   help="Fine-tune from a .model or weights.pt file.")
    p.add_argument("--num-epochs", type=int, default=50)
    p.add_argument("--log-training", action="store_true",
                   help="Log training curves to TensorBoard.")
    p.add_argument("--export-torch", action="store_true",
                   help="Also write <name>.torch.model (the same reference-format "
                        "artifact, under the JAX package's file name for it).")

    p = sub.add_parser("evaluate", help="evaluate (not yet ported to cryovit_tpu_torch)")
    p.add_argument("args", nargs=argparse.REMAINDER)

    for p in sub.choices.values():
        p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                       help="Where to run: the GPU (default) or the CPU.")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")

    if args.command == "evaluate" or (args.command == "infer" and not args.fused):
        verb = "infer without --fused" if args.command == "infer" else args.command
        print(
            f"cryovit-torch: {verb} is not yet ported to cryovit_tpu_torch; "
            "use the JAX package's `cryovit` for it.",
            file=sys.stderr,
        )
        return _NOT_PORTED

    from cryovit_tpu_torch.io import load_files_from_path

    if args.command == "features":
        if args.use_sam:
            from cryovit_tpu_torch.run.sam_features import run_sam as run
        else:
            from cryovit_tpu_torch.run.dino_features import run_dino as run

        tomo_path = Path(args.tomograms)
        if not tomo_path.exists():
            raise FileNotFoundError(f"Tomograms path {tomo_path} does not exist.")
        result = Path(args.result_folder)
        result.mkdir(parents=True, exist_ok=True)
        run(
            load_files_from_path(tomo_path), result,
            batch_size=args.batch_size, random_init=args.random_init, device=args.device,
        )
        return 0

    if args.command == "train":
        from cryovit_tpu_torch.run.train_model import run_training

        if args.label_key not in args.labels:
            raise ValueError(f"label_key {args.label_key!r} must be one of --labels {args.labels}")
        run_training(
            train_data=load_files_from_path(Path(args.train_data)),
            train_labels=load_files_from_path(Path(args.train_labels)),
            labels=args.labels,
            label_key=args.label_key,
            model_name=args.name or f"{args.model}_{args.label_key}",
            result_dir=Path(args.result_folder or "."),
            val_data=(load_files_from_path(Path(args.validation_data))
                      if args.validation_data else None),
            val_labels=(load_files_from_path(Path(args.validation_labels))
                        if args.validation_labels else None),
            model_type=args.model,
            num_epochs=args.num_epochs,
            ckpt_path=Path(args.ckpt) if args.ckpt else None,
            log_training=args.log_training,
            export_torch=args.export_torch,
            device=args.device,
        )
        return 0

    from cryovit_tpu_torch.run.infer_model import run_inference

    written = run_inference(
        data=load_files_from_path(Path(args.tomograms)),
        model_path=Path(args.model),
        result_dir=Path(args.result_folder or "."),
        threshold=args.threshold,
        fused=True,
        random_init=args.random_init,
        device=args.device,
    )
    print(f"wrote {len(written)} segmentations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
