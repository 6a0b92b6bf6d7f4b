"""Accuracy statistics of the three tasks (the port's copy of
``ocrs_models_tpu/utils/metrics.py``): the recognizer's character error
rate, the layout model's line-start and line-end precision and recall, and
the means of the detector's box-match metrics."""

from __future__ import annotations

import numpy as np

from .text import ctc_greedy_decode_text, decode_text, levenshtein


class RecognitionAccuracyStats:
    """Running character error rate over batches."""

    def __init__(self, alphabet: str):
        self.alphabet = alphabet
        self.total_chars = 0
        self.char_errors = 0

    def update(self, targets, target_lengths, preds, pred_lengths) -> None:
        """
        :param targets: ``[N, L]`` target class indices (0-padded).
        :param target_lengths: ``[N]`` valid target lengths.
        :param preds: ``[N, T]`` per-step argmax class indices.
        :param pred_lengths: ``[N]`` CTC input lengths.
        """
        for y, y_len, x, x_len in zip(np.asarray(targets), np.asarray(target_lengths),
                                      np.asarray(preds), np.asarray(pred_lengths)):
            target_text = decode_text(y[:y_len], self.alphabet)
            pred_text = ctc_greedy_decode_text(x[:x_len], self.alphabet)
            self.char_errors += levenshtein(target_text, pred_text)
            self.total_chars += int(y_len)

    def char_error_rate(self) -> float:
        return self.char_errors / max(self.total_chars, 1)

    def stats_dict(self) -> dict:
        return {"char_error_rate": self.char_error_rate()}


def f1_score(precision: float, recall: float) -> float:
    if precision + recall == 0:
        return 0.0
    return 2 * (precision * recall) / (precision + recall)


def precision_recall(preds: np.ndarray, targets: np.ndarray) -> tuple[float, float]:
    """Precision and recall of boolean arrays (0/0 counts as 0)."""
    preds = np.asarray(preds, dtype=bool)
    targets = np.asarray(targets, dtype=bool)
    true_results = np.logical_and(preds, targets).sum()
    precision = float(true_results / preds.sum()) if preds.sum() else 0.0
    recall = float(true_results / targets.sum()) if targets.sum() else 0.0
    return precision, recall


def layout_counts(probs, targets, threshold: float = 0.5) -> np.ndarray:
    """``[true, predicted, target]`` line starts, then the same for line
    ends, of a batch of ``[..., 2]`` probabilities and targets: what
    :func:`precision_recall` divides."""
    probs = np.asarray(probs)
    targets = np.asarray(targets)
    out = []
    for c in (0, 1):
        pred, tgt = probs[..., c] >= threshold, targets[..., c] > 0.5
        out += [np.logical_and(pred, tgt).sum(), pred.sum(), tgt.sum()]
    return np.asarray(out, np.int64)


class LayoutAccuracyStats:
    """Line-start and line-end precision and recall, averaged over the
    batches given to :meth:`update`."""

    def __init__(self):
        self.totals = np.zeros(4)  # ls_prec, ls_rec, le_prec, le_rec
        self.updates = 0

    def update(self, probs, targets, threshold: float = 0.5) -> None:
        self.update_counts(layout_counts(probs, targets, threshold))

    def update_counts(self, counts) -> None:
        """One batch from its :func:`layout_counts` (summed across the
        ranks that each hold a slice of it)."""
        tp_s, pred_s, tgt_s, tp_e, pred_e, tgt_e = (float(c) for c in counts)
        self.updates += 1
        self.totals += np.array([tp_s / pred_s if pred_s else 0.0, tp_s / tgt_s if tgt_s else 0.0,
                                 tp_e / pred_e if pred_e else 0.0, tp_e / tgt_e if tgt_e else 0.0])

    def stats_dict(self) -> dict:
        t = self.totals / max(self.updates, 1)
        return {
            "line_start_precision": t[0],
            "line_start_recall": t[1],
            "line_end_precision": t[2],
            "line_end_recall": t[3],
        }

    def summary(self) -> str:
        s = self.stats_dict()
        return (
            f"line start prec/recall {s['line_start_precision']:.3f}/"
            f"{s['line_start_recall']:.3f} line end prec/recall "
            f"{s['line_end_precision']:.3f}/{s['line_end_recall']:.3f}"
        )


def get_metric_means(metrics_dicts: list[dict]) -> dict:
    """Mean of each key over a list of metric dicts (a missing key counts 0)."""
    if not metrics_dicts:
        return {}
    keys = set(k for md in metrics_dicts for k in md)
    return {k: float(np.mean([md.get(k, 0.0) for md in metrics_dicts])) for k in keys}


def format_metrics(metrics: dict) -> dict:
    return {k: f"{v:.3f}" for k, v in metrics.items()}
