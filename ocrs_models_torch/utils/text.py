"""Text decode utilities (counterpart of ``ocrs_models_tpu/utils/text.py``).

Class index 0 is the CTC blank; class ``i > 0`` is ``alphabet[i - 1]``;
characters outside the alphabet encode as ``unknown_char``.
:func:`ctc_greedy_decode_batch` runs on the device in plain torch ops, so a
recognition chunk costs one small integer fetch instead of a ``[N, T, C]``
log-prob round trip. :func:`ctc_beam_search_decode` is a prefix beam search
on the host, for one sequence.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=8)
def _char_to_index(alphabet: str) -> dict[str, int]:
    return {ch: i + 1 for i, ch in enumerate(alphabet)}


def encode_text(text: str, alphabet: str, unknown_char: str = "?") -> np.ndarray:
    """Encode ``text`` as a ``[len(text)]`` int32 array of class indices."""
    table = _char_to_index(alphabet)
    unknown = table[unknown_char]
    return np.array([table.get(ch, unknown) for ch in text], dtype=np.int32)


def decode_text(indices, alphabet: str) -> str:
    """Decode class indices to a string, skipping blanks (class 0)."""
    return "".join(alphabet[i - 1] for i in np.asarray(indices).tolist() if i > 0)


def ctc_greedy_decode_text(indices, alphabet: str) -> str:
    """Greedy CTC decode: collapse adjacent repeats, then drop blanks."""
    chars = []
    last = None
    for cls in np.asarray(indices).tolist():
        if cls == last:
            continue
        last = cls
        if cls != 0:
            chars.append(alphabet[cls - 1])
    return "".join(chars)


def levenshtein(a: str, b: str) -> int:
    """Edit distance between two strings: the dynamic programme one row at
    a time in numpy, the left-to-right dependency of a row resolved with a
    running minimum."""
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    bn = np.frombuffer(b.encode("utf-32-le"), dtype=np.uint32)
    steps = np.arange(len(bn) + 1)
    prev = steps.astype(np.int64)
    for i, ch in enumerate(a):
        cur = np.empty_like(prev)
        cur[0] = i + 1
        # cur[j+1] = min(prev[j+1] + 1, prev[j] + (a[i] != b[j]), cur[j] + 1)
        np.minimum(prev[1:] + 1, prev[:-1] + (bn != ord(ch)), out=cur[1:])
        prev = np.minimum(cur, np.minimum.accumulate(cur - steps) + steps)
    return int(prev[-1])


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


def ctc_beam_search_decode(log_probs, alphabet: str, beam_width: int = 10) -> str:
    """CTC prefix beam search over per-step log-probabilities, on the host
    (the JAX package's, operation for operation, so ties break alike).

    :param log_probs: ``[T, C]`` log-probabilities (numpy array or tensor on
        any device), class 0 = blank.
    :param beam_width: number of prefixes kept per step.
    :return: the most probable label string.
    """
    if isinstance(log_probs, torch.Tensor):
        # numpy has no bfloat16: widen it (exactly) to float32 first.
        log_probs = log_probs.detach().cpu()
        if log_probs.dtype == torch.bfloat16:
            log_probs = log_probs.float()
        log_probs = log_probs.numpy()
    log_probs = np.asarray(log_probs)
    t_len, n_classes = log_probs.shape
    NEG = -1e30

    def logsum(a, b):
        if a <= NEG:
            return b
        if b <= NEG:
            return a
        m = max(a, b)
        return m + np.log(np.exp(a - m) + np.exp(b - m))

    # prefix tuple -> (log p ending in blank, log p ending in non-blank)
    beams: dict[tuple, tuple[float, float]] = {(): (0.0, NEG)}
    for t in range(t_len):
        lp = log_probs[t]
        # Blank and the top classes of this step are the only extensions.
        top = np.argpartition(-lp, min(beam_width, n_classes - 1))[: beam_width + 1]
        candidates = set(int(c) for c in top) | {0}
        new_beams: dict[tuple, tuple[float, float]] = {}

        def add(prefix, pb, pnb):
            opb, opnb = new_beams.get(prefix, (NEG, NEG))
            new_beams[prefix] = (logsum(opb, pb), logsum(opnb, pnb))

        for prefix, (pb, pnb) in beams.items():
            total = logsum(pb, pnb)
            for c in candidates:
                p = float(lp[c])
                if c == 0:
                    add(prefix, total + p, NEG)
                    continue
                last = prefix[-1] if prefix else None
                if c == last:
                    # A repeat extends only the blank-ended path; the
                    # non-blank-ended one collapses into the same prefix.
                    add(prefix + (c,), NEG, pb + p)
                    add(prefix, NEG, pnb + p)
                else:
                    add(prefix + (c,), NEG, total + p)
        beams = dict(
            sorted(new_beams.items(), key=lambda kv: logsum(*kv[1]), reverse=True)[:beam_width]
        )
    best = max(beams.items(), key=lambda kv: logsum(*kv[1]))[0]
    return "".join(alphabet[c - 1] for c in best)
