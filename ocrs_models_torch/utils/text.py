"""Text decode utilities (counterpart of ``ocrs_models_tpu/utils/text.py``).

Class index 0 is the CTC blank; class ``i > 0`` is ``alphabet[i - 1]``.
:func:`ctc_greedy_decode_batch` runs on the device in plain torch ops, so a
recognition chunk costs one small integer fetch instead of a ``[N, T, C]``
log-prob round trip.
"""

from __future__ import annotations

import numpy as np
import torch


def decode_text(indices, alphabet: str) -> str:
    """Decode class indices to a string, skipping blanks (class 0)."""
    return "".join(alphabet[i - 1] for i in np.asarray(indices).tolist() if i > 0)


def ctc_greedy_decode_batch(
    class_ids: torch.Tensor, lengths: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy CTC decode with static shapes.

    :param class_ids: ``[N, T]`` integer per-step argmax class ids.
    :param lengths: ``[N]`` valid lengths of each sequence.
    :return: ``(decoded, decoded_lengths)``: ``decoded`` is ``[N, T]`` with
        the kept ids left-packed and zero-padded (repeats collapsed, blanks
        dropped); ``decoded_lengths`` is ``[N]``.
    """
    n, t = class_ids.shape
    pos = torch.arange(t, device=class_ids.device)[None, :]
    valid = pos < lengths[:, None]
    prev = torch.cat([class_ids.new_full((n, 1), -1), class_ids[:, :-1]], dim=1)
    keep = (class_ids != prev) & (class_ids != 0) & valid
    # Left-pack kept entries: destination = exclusive cumsum of keep; the
    # dropped ones park in an extra column that is cut off.
    dest = torch.where(keep, torch.cumsum(keep, dim=1) - 1, t)
    decoded = class_ids.new_zeros((n, t + 1))
    decoded.scatter_(1, dest, torch.where(keep, class_ids, 0))
    return decoded[:, :t], keep.sum(dim=1)
