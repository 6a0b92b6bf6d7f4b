"""Recognition accuracy statistics (the port's copy of
``RecognitionAccuracyStats`` in ``ocrs_models_tpu/utils/metrics.py``)."""

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
