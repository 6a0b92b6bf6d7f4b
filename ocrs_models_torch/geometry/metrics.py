"""Box-match metrics between predicted and target word quads (the port's
copy of ``ocrs_models_tpu/geometry/metrics.py``).

The reference's match rules: a prediction matches a target at IoU above
0.5; targets merged into one prediction each cover more than half of it;
a split target is covered more than half by several predictions. Pairs
whose axis-aligned boxes do not overlap are skipped.
"""

from __future__ import annotations

import numpy as np

from .polygon import convex_intersection_area, polygon_area


def box_match_metrics(pred: np.ndarray, target: np.ndarray) -> dict[str, float]:
    """Precision, recall, merged and split fractions of two quad sets.

    :param pred: ``Nx4x2`` array of predicted quads.
    :param target: ``Mx4x2`` array of target quads.
    """
    pred = np.asarray(pred, dtype=np.float64).reshape(-1, 4, 2)
    target = np.asarray(target, dtype=np.float64).reshape(-1, 4, 2)
    n_pred, n_target = len(pred), len(target)

    pred_areas = np.array([abs(polygon_area(p)) for p in pred])
    target_areas = np.array([abs(polygon_area(t)) for t in target])

    intersection = np.zeros((n_pred, n_target))
    if n_pred and n_target:
        p_min = pred.min(axis=1)  # [N, 2]
        p_max = pred.max(axis=1)
        t_min = target.min(axis=1)
        t_max = target.max(axis=1)
        overlap = (
            (p_min[:, None, 0] < t_max[None, :, 0])
            & (t_min[None, :, 0] < p_max[:, None, 0])
            & (p_min[:, None, 1] < t_max[None, :, 1])
            & (t_min[None, :, 1] < p_max[:, None, 1])
        )
        for i, j in zip(*np.nonzero(overlap)):
            intersection[i, j] = convex_intersection_area(pred[i], target[j])

    union = pred_areas[:, None] + target_areas[None, :] - intersection
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, intersection / union, 0.0)

    good = iou > 0.5
    # Each prediction matches at most one target at IoU>0.5.
    matches = int(np.count_nonzero(good.any(axis=1)))

    merged_boxes = 0
    split_boxes = 0
    if n_pred and n_target:
        with np.errstate(divide="ignore", invalid="ignore"):
            cover_t = np.where(
                target_areas[None, :] > 0, intersection / target_areas[None, :], 0.0
            )
            cover_p = np.where(
                pred_areas[:, None] > 0, intersection / pred_areas[:, None], 0.0
            )
        # Targets merged together in a single prediction.
        covered_per_pred = (cover_t > 0.5).sum(axis=1)
        merged_boxes = int(covered_per_pred[covered_per_pred > 1].sum())
        # Targets split across multiple predictions.
        covered_per_target = (cover_p > 0.5).sum(axis=0)
        split_boxes = int(np.count_nonzero(covered_per_target > 1))

    return {
        "precision": matches / n_pred if n_pred > 0 else 1.0,
        "recall": matches / n_target if n_target > 0 else 1.0,
        "merged_frac": merged_boxes / n_target if n_target > 0 else 0.0,
        "split_frac": split_boxes / n_target if n_target > 0 else 0.0,
    }
