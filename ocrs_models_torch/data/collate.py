"""Batch collation of the three tasks (the port's copy of
``ocrs_models_tpu/data/collate.py``).

Widths bucket up to multiples of ``width_step``; CTC-incompatible samples
are kept but masked with ``sample_weight`` 0, and the batch pads to a
multiple of ``batch_multiple`` with zero-weight rows, as in the JAX
package. The one difference is the image layout: NCHW ``[N, 1, H, W]``,
the port's model input (detection masks too).
"""

from __future__ import annotations

import numpy as np

from ..config import round_up


def ctc_input_and_target_compatible(input_len: int, target: np.ndarray) -> bool:
    """CTC requires ``input_len >= target_len + #adjacent-repeats`` (repeats
    need a separating blank)."""
    target = np.asarray(target)
    target_len = len(target)
    min_input_len = max(1, target_len)
    if target_len > 1:
        min_input_len += int(np.count_nonzero(target[1:] == target[:-1]))
    return input_len >= min_input_len


def collate_recognition(
    samples: list[dict],
    width_step: int = 256,
    downsample: int = 4,
    batch_multiple: int = 1,
    max_width: int = 800,
) -> dict:
    """Collate text-line samples into a padded recognition batch.

    Each sample: ``{"image": [64, W, 1] float32, "text": [L] int32}`` (the
    JAX package's sample layout). Returns numpy arrays: ``image``
    ``[N, 1, 64, Wmax]`` (NCHW), ``text`` ``[N, Lmax]``, ``text_len``
    ``[N]``, ``image_width`` ``[N]``, ``sample_weight`` ``[N]``.
    """
    widths = [s["image"].shape[1] for s in samples]
    text_lens = [len(s["text"]) for s in samples]

    wmax = min(round_up(max(widths), width_step), round_up(max_width, width_step))
    lmax = round_up(max(max(text_lens), 1), width_step // downsample)

    n = round_up(len(samples), batch_multiple)
    h = samples[0]["image"].shape[0]
    images = np.zeros((n, 1, h, wmax), dtype=np.float32)
    text = np.zeros((n, lmax), dtype=np.int32)
    text_len = np.zeros((n,), dtype=np.int32)
    image_width = np.full((n,), wmax, dtype=np.int32)
    weight = np.zeros((n,), dtype=np.float32)

    for i, s in enumerate(samples):
        w = widths[i]
        images[i, 0, :, :w] = s["image"][:, :wmax, 0]
        tl = text_lens[i]
        text[i, :tl] = s["text"][:lmax]
        text_len[i] = tl
        image_width[i] = min(w, wmax)
        if ctc_input_and_target_compatible(min(w, wmax) // downsample, s["text"]):
            weight[i] = 1.0

    return {
        "image": images,
        "text": text,
        "text_len": text_len,
        "image_width": image_width,
        "sample_weight": weight,
    }


def collate_detection(samples: list[dict], batch_multiple: int = 1) -> dict:
    """Collate fixed-size detection samples.

    Each sample: ``{"image": [H, W, 1], "mask": [H, W, 1]}`` (the JAX
    package's sample layout) and an optional ``"path"``. Returns ``image``
    and ``mask`` ``[N, 1, H, W]`` float32 (NCHW), ``sample_weight`` ``[N]``,
    ``n_valid`` and, where a sample has one, ``path``. Rows padding the
    batch to ``batch_multiple`` repeat the last sample with weight 0.
    """
    n = round_up(len(samples), batch_multiple)
    last = len(samples) - 1
    rows = [samples[min(i, last)] for i in range(n)]
    image = np.stack([r["image"][..., 0] for r in rows])[:, None].astype(np.float32)
    mask = np.stack([r["mask"][..., 0] for r in rows])[:, None].astype(np.float32)
    weight = np.zeros((n,), np.float32)
    weight[: len(samples)] = 1.0
    batch = {"image": image, "mask": mask, "sample_weight": weight, "n_valid": len(samples)}
    paths = [s.get("path") for s in samples]
    if any(p is not None for p in paths):
        batch["path"] = paths
    return batch


def collate_layout(samples: list[tuple], batch_multiple: int = 1) -> dict:
    """Collate ``(boxes [W, 4], labels [W, 2])`` tuples, already padded to a
    fixed word count by the dataset. The batch pads to a multiple of
    ``batch_multiple`` by repeating the last sample, with weight 0."""
    n = round_up(len(samples), batch_multiple)
    last = len(samples) - 1
    boxes = np.stack([samples[min(i, last)][0] for i in range(n)]).astype(np.float32)
    labels = np.stack([samples[min(i, last)][1] for i in range(n)]).astype(np.float32)
    weight = np.zeros((n,), np.float32)
    weight[: len(samples)] = 1.0
    return {"boxes": boxes, "labels": labels, "sample_weight": weight, "n_valid": len(samples)}
