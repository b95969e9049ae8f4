"""``cryovit-torch`` command-line interface (port of ``cryovit_tpu/cli/main.py``).

The verbs and flags follow the JAX package's ``cryovit``: ``features``
(DINOv2 extraction, and SAM2 pyramids with ``--use-sam``), ``train``
(CryoVIT on DINOv2 features, or ``--model unet3d`` / ``--model sam2`` on
raw voxels; ``--model medsam`` is refused up front, its Hiera-T hitting
ROADMAP C2; ``--ckpt`` fine-tunes from a ``.model``, a ``weights.pt`` or
the JAX package's ``weights.msgpack``), ``evaluate`` (a ``.model`` against
labelled files → metrics CSVs) and ``infer`` (feature or voxel files →
masks, SAM2 artifacts included, or raw tomograms → masks with ``--fused``,
CryoVIT only).

``features -v`` also writes each tomogram's DINOv2 PCA maps (PNGs under
``<result_folder>/dino_images``), computed on the device.

``--int8`` on ``features`` (with or without ``--use-sam``) and on ``infer
--fused`` takes the opt-in w8a8 mode: the backbone's qkv and first MLP
projections as int8 products with per-token activation and per-channel
weight scales; ``infer --int8`` without ``--fused`` is refused, as in the
JAX package.

A ``.model`` is read in either format: the reference torch format (which
the port writes, and the JAX package's ``--export-torch``) or the JAX
package's own (flax msgpack weights, decoded without flax; MedSAM's is
refused, ROADMAP C2).

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
    p.add_argument("-v", "--visualize", action="store_true",
                   help="Save PCA visualizations of DINO features (slower).")
    p.add_argument("--use-sam", action="store_true",
                   help="Extract SAM2 feature pyramids instead of DINOv2.")
    p.add_argument("--int8", action="store_true",
                   help="w8a8 projection products (opt-in; int8 weights and "
                        "activations, per-channel and per-token scales).")
    p.add_argument("--random-init", action="store_true", help=argparse.SUPPRESS)

    p = sub.add_parser("evaluate", help="Evaluate a trained model against labels.")
    p.add_argument("test_data", help="Folder or .txt manifest of test tomograms.")
    p.add_argument("test_labels", help="Folder or .txt manifest of label files.")
    p.add_argument("model", help="Path to the trained .model file.")
    p.add_argument("--labels", nargs="+", required=True,
                   help="Label names in ascending-value order.")
    p.add_argument("--result-folder", default=None)
    p.add_argument("-v", "--visualize", action="store_true",
                   help="Also save prediction HDF5s.")

    p = sub.add_parser("infer", help="Segment tomograms with a trained model.")
    p.add_argument("tomograms", help="Folder or .txt manifest of tomograms.")
    p.add_argument("--model", required=True, help="Path to the trained .model file.")
    p.add_argument("--result-folder", default=None)
    p.add_argument("--threshold", type=float, default=0.5,
                   help="Probability threshold for binary segmentation.")
    p.add_argument("--fused", action="store_true",
                   help="Run the fused DINOv2+decoder pipeline directly on raw "
                        "tomograms (CryoVIT models; no feature files needed).")
    p.add_argument("--int8", action="store_true",
                   help="With --fused: w8a8 backbone projections "
                        "(see features --int8).")
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
                   help="Fine-tune from a .model, weights.pt or weights.msgpack file.")
    p.add_argument("--num-epochs", type=int, default=50)
    p.add_argument("--log-training", action="store_true",
                   help="Log training curves to TensorBoard.")
    p.add_argument("--export-torch", action="store_true",
                   help="Also write <name>.torch.model (the same reference-format "
                        "artifact, under the JAX package's file name for it).")

    for p in sub.choices.values():
        p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                       help="Where to run: the GPU (default) or the CPU.")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")

    from cryovit_tpu_torch.io import load_files_from_path

    if args.command == "features":
        if args.use_sam:  # -v draws DINOv2 maps only, as in the JAX package
            from cryovit_tpu_torch.run.sam_features import run_sam as run

            extra = {}
        else:
            from cryovit_tpu_torch.run.dino_features import run_dino as run

            extra = {"visualize": args.visualize}

        tomo_path = Path(args.tomograms)
        if not tomo_path.exists():
            raise FileNotFoundError(f"Tomograms path {tomo_path} does not exist.")
        result = Path(args.result_folder)
        result.mkdir(parents=True, exist_ok=True)
        run(
            load_files_from_path(tomo_path), result,
            batch_size=args.batch_size, random_init=args.random_init, device=args.device,
            quant_int8=args.int8, **extra,
        )
        return 0

    if args.command == "train":
        from cryovit_tpu_torch.config import TrainConfig
        from cryovit_tpu_torch.run.train_model import build_model, run_training

        config = TrainConfig.for_model(args.model, args.label_key)
        build_model(config)  # refuses MedSAM's Hiera-T (ROADMAP C2) before any file is read
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
            config=config,
            ckpt_path=Path(args.ckpt) if args.ckpt else None,
            log_training=args.log_training,
            export_torch=args.export_torch,
            device=args.device,
        )
        return 0

    if args.command == "evaluate":
        from cryovit_tpu_torch.run.eval_model import run_evaluation

        csv_dir = run_evaluation(
            test_data=load_files_from_path(Path(args.test_data)),
            test_labels=load_files_from_path(Path(args.test_labels)),
            labels=args.labels,
            model_path=Path(args.model),
            result_dir=Path(args.result_folder or "."),
            visualize=args.visualize,
            device=args.device,
        )
        print(f"metrics written under {csv_dir}")
        return 0

    from cryovit_tpu_torch.run.infer_model import run_inference

    written = run_inference(
        data=load_files_from_path(Path(args.tomograms)),
        model_path=Path(args.model),
        result_dir=Path(args.result_folder or "."),
        threshold=args.threshold,
        fused=args.fused,
        random_init=args.random_init,
        device=args.device,
        quant_int8=args.int8,
    )
    print(f"wrote {len(written)} segmentations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
