"""Experiment-result figures (port of ``cryovit_tpu/visualization/experiments.py``):
seaborn box + strip comparisons of per-tomogram Dice scores across models,
labels and training fractions, with paired-significance annotations and
summary-statistics CSVs; the six ``process_*_experiment`` entry points.

Each entry point first imports the plotting stack (pandas, matplotlib,
seaborn) and raises an ``ImportError`` naming a missing package before it
reads or writes anything.
"""

from __future__ import annotations

import functools
import logging
from pathlib import Path

from typing import TYPE_CHECKING

from cryovit_tpu_torch.visualization._plotting import (
    annotate_pvalues,
    box_strip_plot,
    pyplot,
    require,
    save_figure,
    set_theme,
)
from cryovit_tpu_torch.visualization.utils import (
    compute_stats,
    merge_experiments,
    significance_test,
)

if TYPE_CHECKING:
    import pandas as pd

logger = logging.getLogger(__name__)

__all__ = [
    "process_single_experiment",
    "process_multi_experiment",
    "process_multi_label_experiment",
    "process_multi_label_sample_experiment",
    "process_fractional_experiment",
    "process_sparse_experiment",
]

_MODEL_PAIRS = [("CryoVIT", "3D U-Net"), ("CryoVIT", "SAM2"), ("3D U-Net", "SAM2")]


def _plotting_stack() -> None:
    require("pandas", "matplotlib", "seaborn")


def _pairwise_stats(
    df: pd.DataFrame,
    result_dir: Path,
    prefix: str,
    group_key: str,
    pairs: list[tuple[str, str]],
    key: str = "model",
) -> dict[tuple, float]:
    """Per-group paired tests for each model pair → {(group, A, B): p}."""
    pvalues: dict[tuple, float] = {}
    present = set(df[key].unique())
    for a, b in pairs:
        if a not in present or b not in present:
            continue
        test_fn = functools.partial(
            significance_test, model_A=a, model_B=b, key=key, test_fn="wilcoxon"
        )
        try:
            ps = compute_stats(
                df,
                group_keys=[group_key, key],
                file_name=str(result_dir / f"{prefix}_{a}_{b}_stats.csv"),
                test_fn=test_fn,
            )
        except (ValueError, AssertionError) as e:
            logger.warning("stats failed for %s vs %s: %s", a, b, e)
            continue
        for group, p in ps.items():
            pvalues[(group, a, b)] = float(p)
    return pvalues


def _comparison_figure(
    dfs: dict[str, pd.DataFrame],
    result_dir: Path,
    name: str,
    x: str,
    hue: str,
    pairs: list[tuple[str, str]],
    title: str,
    prefix: str,
) -> None:
    plt = pyplot()
    set_theme()
    result_dir = Path(result_dir)
    result_dir.mkdir(parents=True, exist_ok=True)
    widths = [max(df[x].nunique(), 1) for df in dfs.values()]
    fig, axes = plt.subplots(
        1,
        len(dfs),
        figsize=(max(6, 3 * sum(widths)), 6),
        sharey="row",
        gridspec_kw={"width_ratios": widths},
        squeeze=False,
    )
    for ax, (group, df) in zip(axes[0], dfs.items(), strict=True):
        pvalues = _pairwise_stats(
            df, result_dir, f"{group.lower()}_{prefix}", x, pairs, key=hue
        )
        box_strip_plot(df, x=x, hue=hue, ax=ax)
        annotate_pvalues(ax, df, x, pairs, pvalues)
        ax.set_title(group)
    fig.suptitle(title)
    fig.supxlabel(x.replace("_", " ").title())
    fig.supylabel("Dice Score")
    fig.tight_layout(rect=(0.01, 0.01, 1.0, 1.0))
    save_figure(fig, result_dir, name)
    plt.close(fig)


def process_single_experiment(
    exp_type: str,
    exp_group: str,
    exp_names: dict[str, dict[str, list[str]]],
    exp_dir: Path,
    result_dir: Path,
) -> None:
    """Per-sample model comparison."""
    _plotting_stack()
    dfs = {
        group: merge_experiments(Path(exp_dir), names, keys=["model", "group"])
        for group, names in exp_names.items()
    }
    _comparison_figure(
        dfs,
        result_dir,
        f"{exp_group.lower()}_{exp_type}",
        x="sample",
        hue="model",
        pairs=_MODEL_PAIRS,
        title="Model Comparison on Individual Samples",
        prefix=exp_type,
    )


def process_multi_experiment(
    exp_type: str,
    exp_group: str,
    exp_names: dict[str, dict[str, list[str]]],
    exp_dir: Path,
    result_dir: Path,
) -> None:
    """Domain-shift forward/backward comparison grids."""
    _plotting_stack()
    dfs = {
        group: merge_experiments(Path(exp_dir), names, keys=["model", "group"])
        for group, names in exp_names.items()
    }
    _comparison_figure(
        dfs,
        result_dir,
        f"{exp_group.lower()}_{exp_type}",
        x="sample",
        hue="model",
        pairs=_MODEL_PAIRS,
        title="Generalization Across Samples",
        prefix=exp_type,
    )


def process_multi_label_experiment(
    exp_type: str,
    exp_group: str,
    exp_names: dict[str, dict[str, list[str]]],
    exp_dir: Path,
    result_dir: Path,
) -> None:
    """Multi-label (mito/cristae/...) comparison."""
    _plotting_stack()
    dfs = {
        group: merge_experiments(Path(exp_dir), names, keys=["model", "label"])
        for group, names in exp_names.items()
    }
    _comparison_figure(
        dfs,
        result_dir,
        f"{exp_group.lower()}_{exp_type}",
        x="label",
        hue="model",
        pairs=_MODEL_PAIRS,
        title="Model Comparison Across Labels",
        prefix=exp_type,
    )


def process_multi_label_sample_experiment(
    exp_type: str,
    exp_group: str,
    exp_names: dict[str, dict[str, list[str]]],
    exp_dir: Path,
    result_dir: Path,
) -> None:
    """Per-sample × label breakdown."""
    _plotting_stack()
    dfs = {
        group: merge_experiments(Path(exp_dir), names, keys=["model", "label"])
        for group, names in exp_names.items()
    }
    _comparison_figure(
        dfs,
        result_dir,
        f"{exp_group.lower()}_{exp_type}",
        x="sample",
        hue="label",
        pairs=[],
        title="Label Performance per Sample",
        prefix=exp_type,
    )


def process_fractional_experiment(
    exp_type: str,
    exp_group: str,
    exp_names: dict[str, dict[str, list[str]]],
    exp_dir: Path,
    result_dir: Path,
) -> None:
    """Dice vs fraction-of-training-data curves."""
    _plotting_stack()
    plt = pyplot()
    (sns,) = require("seaborn")
    set_theme()
    result_dir = Path(result_dir)
    result_dir.mkdir(parents=True, exist_ok=True)
    for group, names in exp_names.items():
        df = merge_experiments(Path(exp_dir), names, keys=["model"])
        if "split_id" not in df.columns:
            raise ValueError("fractional results need a split_id (fraction) column")
        df["fraction"] = df["split_id"] * 10  # split_id 1..10 → 10%..100%
        fig, ax = plt.subplots(figsize=(8, 6))
        sns.lineplot(
            df, x="fraction", y="dice_metric", hue="model",
            errorbar=("ci", 95), marker="o", ax=ax,
        )
        for a, b in _MODEL_PAIRS:
            if {a, b} <= set(df["model"].unique()):
                test_fn = functools.partial(
                    significance_test, model_A=a, model_B=b, test_fn="wilcoxon"
                )
                try:
                    compute_stats(
                        df,
                        group_keys=["split_id", "model"],
                        file_name=str(
                            result_dir / f"{group.lower()}_{exp_type}_{a}_{b}_stats.csv"
                        ),
                        test_fn=test_fn,
                    )
                except (ValueError, AssertionError) as e:
                    logger.warning("fractional stats failed: %s", e)
        ax.set_xlabel("Fraction of Training Data (%)")
        ax.set_ylabel("Dice Score")
        ax.set_title(f"Data Efficiency — {group}")
        save_figure(fig, result_dir, f"{group.lower()}_{exp_type}")
        plt.close(fig)


def process_sparse_experiment(
    exp_type: str,
    exp_group: str,
    exp_names: dict[str, dict[str, list[str]]],
    exp_dir: Path,
    result_dir: Path,
) -> None:
    """Sparse vs dense annotation comparison."""
    _plotting_stack()
    dfs = {
        group: merge_experiments(Path(exp_dir), names, keys=["model", "annotation"])
        for group, names in exp_names.items()
    }
    _comparison_figure(
        dfs,
        result_dir,
        f"{exp_group.lower()}_{exp_type}",
        x="sample",
        hue="annotation",
        pairs=[],
        title="Sparse vs Dense Annotations",
        prefix=exp_type,
    )
