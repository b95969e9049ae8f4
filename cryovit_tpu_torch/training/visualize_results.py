"""Figure dispatcher (port of ``cryovit_tpu/training/visualize_results.py``).

Usage:
    python -m cryovit_tpu_torch.training.visualize_results \
        --exp_type single --exp_dir <results> --result_dir <figures> [--sample S]

``--exp_type`` selects the processor; the experiment-name tables are the JAX
package's. ``dino_pca`` runs its PCA on the GPU unless ``--device cpu``
asks for the CPU; the other types draw on the host.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from cryovit_tpu_torch._logging_config import setup_logging

MODEL_NAMES = {"cryovit": "CryoViT", "unet3d": "3D U-Net", "sam2": "SAM2"}
LABELS = ["mito", "cristae", "microtubule", "granule", "bacteria", "mito_membrane"]


def _single_names(groups=("AD", "HD", "RGC", "Algae")):
    return {
        g: {
            f"single_{g.lower()}_{mk}_mito": [mv, g]
            for mk, mv in MODEL_NAMES.items()
        }
        for g in groups
    }


def _multi_names():
    out = {}
    for a, b in [("hd", "healthy"), ("neuron", "fibro_cancer")]:
        group = f"{a}_vs_{b}"
        names = {}
        for mk, mv in MODEL_NAMES.items():
            names[f"{a}_to_{b}_{mk}_mito"] = [mv, "forward"]
            names[f"{b}_to_{a}_{mk}_mito"] = [mv, "backward"]
        out[group] = names
    return out


def _label_names():
    return {
        "labels": {
            f"fractional_{mk}_{lb}": [mv, lb]
            for mk, mv in MODEL_NAMES.items()
            for lb in LABELS
        }
    }


def _fractional_names():
    return {
        lb: {f"fractional_{mk}_{lb}": [mv] for mk, mv in MODEL_NAMES.items()}
        for lb in LABELS[:-1]
    }


def _sparse_names():
    return {
        "sparse": {
            f"fractional_cryovit_mito_{s.lower()}": [f"CryoViT with {s} Labels", s]
            for s in ("Sparse", "Dense")
        }
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--exp_type",
        required=True,
        choices=[
            "dino_pca", "segmentations", "single", "multi",
            "multi_label", "multi_label_sample", "fractional", "sparse",
        ],
    )
    parser.add_argument("--exp_dir", type=Path, required=True)
    parser.add_argument("--result_dir", type=Path, required=True)
    parser.add_argument("--sample", default=None)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="Where dino_pca runs its PCA: the GPU (default) or the CPU.")
    args = parser.parse_args(argv)
    setup_logging("INFO")

    import cryovit_tpu_torch.visualization as viz

    if args.exp_type == "dino_pca":
        viz.process_samples(args.exp_dir, args.result_dir, sample=args.sample,
                            device=args.device)
    elif args.exp_type == "segmentations":
        viz.process_experiment(args.exp_dir, args.result_dir)
    elif args.exp_type == "single":
        viz.process_single_experiment(
            "single", "all", _single_names(), args.exp_dir, args.result_dir
        )
    elif args.exp_type == "multi":
        viz.process_multi_experiment(
            "multi", "all", _multi_names(), args.exp_dir, args.result_dir
        )
    elif args.exp_type == "multi_label":
        viz.process_multi_label_experiment(
            "multi_label", "all", _label_names(), args.exp_dir, args.result_dir
        )
    elif args.exp_type == "multi_label_sample":
        viz.process_multi_label_sample_experiment(
            "multi_label_sample", "all", _label_names(), args.exp_dir, args.result_dir
        )
    elif args.exp_type == "fractional":
        viz.process_fractional_experiment(
            "fractional", "all", _fractional_names(), args.exp_dir, args.result_dir
        )
    elif args.exp_type == "sparse":
        viz.process_sparse_experiment(
            "sparse", "all", _sparse_names(), args.exp_dir, args.result_dir
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
