"""Plotting helpers of the experiment figures (port of
``cryovit_tpu/visualization/_plotting.py``): a box + strip plot of Dice
scores, bracket-and-star p-value annotations drawn by hand (the reference's
``statannotations`` is not a dependency), and SVG + PNG output.

The plotting stack (matplotlib, seaborn and its pandas, cv2) is optional:
:func:`require` imports a package where a figure needs it and raises an
``ImportError`` naming it when it is missing, so nothing returns quietly.
"""

from __future__ import annotations

import importlib
from pathlib import Path

__all__ = ["annotate_pvalues", "box_strip_plot", "require", "save_figure", "set_theme"]


def require(*names: str) -> list:
    """The named modules, imported; a missing one raises an ``ImportError``
    that names it."""
    modules = []
    for name in names:
        try:
            modules.append(importlib.import_module(name))
        except ImportError as e:
            raise ImportError(
                f"{name} is not installed: cryovit_tpu_torch.visualization needs it here "
                f"({e})"
            ) from e
    return modules


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend."""
    (matplotlib,) = require("matplotlib")
    matplotlib.use("Agg")
    (plt,) = require("matplotlib.pyplot")
    return plt


def set_theme() -> None:
    (sns,) = require("seaborn")
    sns.set_theme(style="darkgrid")


def _stars(p: float) -> str:
    if p <= 1e-4:
        return "****"
    if p <= 1e-3:
        return "***"
    if p <= 1e-2:
        return "**"
    if p <= 5e-2:
        return "*"
    return "ns"


def box_strip_plot(df, x: str, hue: str, ax, y: str = "dice_metric",
                   order: list | None = None, hue_order: list | None = None):
    """Box + strip plot of Dice scores grouped by ``x`` and coloured by
    ``hue``."""
    (sns,) = require("seaborn")
    sns.boxplot(
        df, x=x, y=y, hue=hue, ax=ax, order=order, hue_order=hue_order,
        showfliers=False, linewidth=1.0,
    )
    sns.stripplot(
        df, x=x, y=y, hue=hue, ax=ax, order=order, hue_order=hue_order,
        dodge=True, size=3, palette="dark:black", alpha=0.5, legend=False,
    )
    ax.set_xlabel("")
    ax.set_ylabel("")
    return ax


def annotate_pvalues(ax, df, x: str, pairs: list[tuple], pvalues: dict[tuple, float],
                     y: str = "dice_metric") -> None:
    """Bracket + star annotations for group pairs at each x position: a key
    ``(x value, A, B)`` at that position, ``(A, B)`` across the axis."""
    if not pvalues:
        return
    x_labels = [t.get_text() for t in ax.get_xticklabels()]
    y_max = float(df[y].max()) if len(df) else 1.0
    step = 0.06
    for i, (pair, p) in enumerate(pvalues.items()):
        if len(pair) == 3:
            xv = pair[0]
            if str(xv) not in x_labels:
                continue
            xi = x_labels.index(str(xv))
            x0, x1 = xi - 0.2, xi + 0.2
        else:
            x0, x1 = 0, len(x_labels) - 1
        h = y_max + step * (i % 3 + 1)
        ax.plot([x0, x0, x1, x1], [h, h + 0.01, h + 0.01, h], lw=0.8, c="0.3")
        ax.text((x0 + x1) / 2, h + 0.012, _stars(p), ha="center", fontsize=7)


def save_figure(fig, result_dir: Path, name: str) -> None:
    result_dir = Path(result_dir)
    result_dir.mkdir(parents=True, exist_ok=True)
    fig.savefig(result_dir / f"{name}.svg")
    fig.savefig(result_dir / f"{name}.png", dpi=300)
