"""The numbers that decide ``correct``, each compared with its limit in the
cell's file (``workloads/<cell>.json``, ``checks``)."""

from __future__ import annotations

import statistics

import numpy as np

# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding (a bias under a norm): Adam moves it by round-off
NEGLIGIBLE_GRAD = 1e-3


def slice_gap(probs: np.ndarray, ref: np.ndarray) -> float:
    """The worst slice's root-mean-square gap between the program's and
    the reference's probabilities, over the spread (standard deviation) of
    the reference's probabilities over the whole tomogram."""
    diff = probs.astype(np.float64) - ref.astype(np.float64)
    rms = np.sqrt((diff ** 2).reshape(diff.shape[0], -1).mean(axis=1))
    return float(rms.max() / ref.astype(np.float64).std())


def loss_gap(losses: list[float], ref: list[float]) -> float:
    """The largest gap of a step's loss, over the reference's loss."""
    return max(abs(a - b) / abs(b) for a, b in zip(losses, ref, strict=True))


def counted_leaves(ref_grads: dict[str, float]) -> list[str]:
    median = statistics.median(ref_grads.values())
    return [k for k, g in ref_grads.items() if g >= NEGLIGIBLE_GRAD * median]


def worst_leaf_gap(norms: dict[str, float], ref: dict[str, float],
                   leaves: list[str]) -> tuple[float, str]:
    """The worst counted leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    counted leaf, whichever is larger; and that leaf."""
    median = statistics.median(ref[k] for k in leaves)
    return max((abs(norms.get(k, 0.0) - ref[k]) / max(ref[k], median), k) for k in leaves)


def train_gaps(prog: dict, ref: dict) -> tuple[dict[str, float], dict[str, str]]:
    """``loss_gap``, ``grad_gap`` (the first step's gradients) and
    ``update_gap`` (the change after the first steps) of two runs' readings
    (``reference.train.run_steps``' keys), and the worst leaf of the last two."""
    leaves = counted_leaves(ref["grad_norms"])
    grad, grad_leaf = worst_leaf_gap(prog["grad_norms"], ref["grad_norms"], leaves)
    update, update_leaf = worst_leaf_gap(prog["change_norms"], ref["change_norms"], leaves)
    values = {"loss_gap": loss_gap(prog["losses"], ref["losses"]), "grad_gap": grad,
              "grad_gap_median": median_leaf_gap(prog["grad_norms"], ref["grad_norms"], leaves),
              "update_gap": update}
    return values, {"grad_gap": grad_leaf, "update_gap": update_leaf}


def median_leaf_gap(norms: dict[str, float], ref: dict[str, float], leaves: list[str]) -> float:
    """The median over the counted leaves of :func:`worst_leaf_gap`'s
    per-leaf gap: steady from seed to seed where the worst leaf is one small
    leaf's noise."""
    median = statistics.median(ref[k] for k in leaves)
    return statistics.median(abs(norms.get(k, 0.0) - ref[k]) / max(ref[k], median)
                             for k in leaves)
