"""Dataset preview CLI: render samples to PNG files for a look at the
pipeline (the port's copy of ``python -m ocrs_models_tpu.data``).

Detection masks are overlaid in red on their pages (``det-{i}.png``),
recognition line crops are named by their decoded text
(``rec-{i}-{text}.png``), layout boxes are coloured by their labels
(``layout-{i}.png``). Every file is written by ``utils.render.write_png``.
It runs on the host only.

Usage:
    python -m ocrs_models_torch.data <type> <root_dir> <out_dir> [--max-images N]
    types: hiertext, hiertext-rec, ddi, web-layout,
           synthetic, synthetic-rec, synthetic-layout, synthetic-doc
    (root_dir is read by hiertext, hiertext-rec, ddi and web-layout)
"""

from __future__ import annotations

import os
import re
from argparse import ArgumentParser

import numpy as np

from ..config import DEFAULT_ALPHABET
from ..utils.image import untransform_image
from ..utils.render import draw_word_boxes, write_png
from ..utils.text import decode_text

DATASET_TYPES = ["hiertext", "hiertext-rec", "ddi", "web-layout",
                 "synthetic", "synthetic-rec", "synthetic-layout", "synthetic-doc"]


def save_detection(sample: dict, path: str) -> None:
    """The page with its text pixels tinted red."""
    img = untransform_image(sample["image"][..., 0])
    mask = np.asarray(sample["mask"])[..., 0] > 0.5
    rgb = np.stack([img] * 3, axis=-1)
    rgb[mask] = (0.4 * rgb[mask] + 0.6 * np.array([255, 0, 0])).astype(np.uint8)
    write_png(path, rgb)


def main(argv=None):
    parser = ArgumentParser(description="Preview dataset samples.")
    parser.add_argument("dataset_type", choices=DATASET_TYPES)
    parser.add_argument("root_dir")
    parser.add_argument("out_dir")
    parser.add_argument("--max-images", type=int, default=10)
    args = parser.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    n = args.max_images

    if args.dataset_type in ("hiertext", "ddi", "synthetic"):
        if args.dataset_type == "hiertext":
            from .hiertext import HierTextDetection

            ds = HierTextDetection(args.root_dir, train=True, max_images=n)
        elif args.dataset_type == "ddi":
            from .ddi100 import DDI100

            ds = DDI100(args.root_dir, train=True, max_images=n)
        else:
            from .synthetic import SyntheticDetection

            ds = SyntheticDetection(size=n)
        for i in range(min(n, len(ds))):
            save_detection(ds[i], f"{args.out_dir}/det-{i}.png")

    elif args.dataset_type in ("hiertext-rec", "synthetic-rec"):
        if args.dataset_type == "hiertext-rec":
            from .hiertext import HierTextRecognition

            ds = HierTextRecognition(args.root_dir, train=True, max_images=n)
        else:
            from .synthetic import SyntheticRecognition

            ds = SyntheticRecognition(size=n)
        for i in range(min(n, len(ds))):
            sample = ds[i]
            text = decode_text(sample["text"], DEFAULT_ALPHABET)
            safe = re.sub(r"[^A-Za-z0-9_-]+", "_", text)[:48] or "blank"
            write_png(f"{args.out_dir}/rec-{i}-{safe}.png",
                      untransform_image(sample["image"][..., 0]))

    else:  # web-layout / synthetic-layout / synthetic-doc
        if args.dataset_type == "web-layout":
            from .web_layout import WebLayout

            ds = WebLayout(args.root_dir, train=True, max_images=n, normalize_coords=False,
                           padded_size=None)
        elif args.dataset_type == "synthetic-doc":
            from .layout_synth import SyntheticDocLayout

            ds = SyntheticDocLayout(size=n, normalize_coords=False)
        else:
            from .synthetic import SyntheticLayout

            ds = SyntheticLayout(size=n)
        for i in range(min(n, len(ds))):
            boxes, labels = ds[i]
            w = int(boxes[:, 2].max()) + 20 if len(boxes) else 100
            h = int(boxes[:, 3].max()) + 20 if len(boxes) else 100
            draw_word_boxes(f"{args.out_dir}/layout-{i}.png", w, h, boxes, labels=labels)

    print(f"Wrote previews to {args.out_dir}")


if __name__ == "__main__":
    main()
