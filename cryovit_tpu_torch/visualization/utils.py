"""Statistics of experiment results (port of ``cryovit_tpu/visualization/utils.py``):
merge per-sample metric CSVs, paired significance tests on Dice scores, and
summary-statistics tables with p-values.

pandas and scipy are imported where they are used (the GPU machine has
scipy but no pandas); a missing one raises an ``ImportError`` naming it.
"""

from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING, Callable

from cryovit_tpu_torch.visualization._plotting import require

if TYPE_CHECKING:
    import pandas as pd

__all__ = ["merge_experiments", "significance_test", "compute_stats"]


def merge_experiments(
    exp_dir: Path,
    exp_names: dict[str, list[str]],
    keys: list[str] | None = None,
) -> pd.DataFrame:
    """Concatenate the per-sample CSVs of several experiments into one frame,
    tagging each with label columns; also writes each experiment's combined
    CSV next to its directory."""
    (pd,) = require("pandas")
    exp_dir = Path(exp_dir)
    if not exp_dir.exists():
        raise ValueError(f"The directory {exp_dir} does not exist")
    keys = keys or ["model"]
    merged = []
    for exp_name, labels in exp_names.items():
        files = sorted((exp_dir / exp_name).glob("*.csv"))
        if not files:
            raise ValueError(f"no result CSVs under {exp_dir / exp_name}")
        exp_df = pd.concat([pd.read_csv(f) for f in files], ignore_index=True)
        exp_df.to_csv(exp_dir / f"{exp_name}.csv", index=False)
        for key, val in zip(keys, labels, strict=True):
            exp_df[key] = val
        merged.append(exp_df)
    return pd.concat(merged, ignore_index=True)


def significance_test(
    df: pd.DataFrame,
    model_A: str,
    model_B: str,
    key: str = "model",
    test_fn: str = "wilcoxon",
) -> float:
    """Paired two-sided test on the Dice scores of two models."""
    (stats,) = require("scipy.stats")
    score_a = df[df[key] == model_A].sort_values("tomo_name").dice_metric
    score_b = df[df[key] == model_B].sort_values("tomo_name").dice_metric
    assert len(score_a) == len(score_b), (
        f"paired test needs equal counts: {model_A}={len(score_a)}, "
        f"{model_B}={len(score_b)}"
    )
    if test_fn == "wilcoxon":
        _, pvalue = stats.wilcoxon(score_a, score_b, method="exact", alternative="two-sided")
    elif test_fn == "ttest_rel":
        _, pvalue = stats.ttest_rel(score_a, score_b, alternative="two-sided")
    else:
        raise ValueError(f"Unknown test function: {test_fn}")
    return float(pvalue)


def compute_stats(
    df: pd.DataFrame, group_keys: list[str], file_name: str, test_fn: Callable
) -> pd.Series:
    """Summary table (median, mean ± std, quartiles, p-value) per group,
    written to ``file_name``; returns the p-values."""
    (pd,) = require("pandas")
    grouped = df.groupby(group_keys, sort=False)["dice_metric"].agg(
        mean="mean",
        std="std",
        median="median",
        Q1=lambda x: x.quantile(0.25),
        Q3=lambda x: x.quantile(0.75),
    )
    transforms = {
        "Median Dice Score": lambda row: f"{row['median']:.2f}",
        "Mean Dice Score ± Std": lambda row: f"{row['mean']:.2f} ± {row['std']:.2f}",
        "Dice Score Quartiles (Q1 - Q3)": lambda row: f"{row['Q1']:.2f} - {row['Q3']:.2f}",
    }
    values = {col: grouped.apply(fn, axis=1) for col, fn in transforms.items()}
    stats_df = pd.DataFrame.from_dict(values).unstack(level=-1)

    pvalues = df.groupby(group_keys[0]).apply(test_fn, include_groups=False)
    stats_df["p-value"] = pvalues.apply(lambda x: f"{x:.2e}")[stats_df.index]

    if group_keys[0] != "split_id":
        counts = df[group_keys[0]].value_counts(ascending=True)
        stats_df = stats_df.loc[counts.index]
    stats_df.reset_index(names=group_keys[0]).to_csv(file_name, index=False)
    return pvalues
