"""Analysis and figures (port of ``cryovit_tpu/visualization``): the DINOv2
PCA maps (computed on the device; numpy, torch and the standard library
only), the experiment figures and statistics, and the overlay videos. The
plotting stack those last two need (pandas, matplotlib, seaborn, cv2) is
imported where it is used, never at import time."""

from cryovit_tpu_torch.visualization.dino_pca import export_pca, process_samples
from cryovit_tpu_torch.visualization.experiments import (
    process_fractional_experiment,
    process_multi_experiment,
    process_multi_label_experiment,
    process_multi_label_sample_experiment,
    process_single_experiment,
    process_sparse_experiment,
)
from cryovit_tpu_torch.visualization.segmentations import process_experiment
from cryovit_tpu_torch.visualization.utils import (
    compute_stats,
    merge_experiments,
    significance_test,
)

__all__ = [
    "export_pca",
    "process_samples",
    "process_single_experiment",
    "process_multi_experiment",
    "process_multi_label_experiment",
    "process_multi_label_sample_experiment",
    "process_fractional_experiment",
    "process_sparse_experiment",
    "process_experiment",
    "merge_experiments",
    "significance_test",
    "compute_stats",
]
