"""Layout model evaluation and preview CLI (the port's counterpart of
``ocrs_models_tpu/training/eval_layout.py``).

A scraper-schema word-box JSON (what ``data/layout_synth.write_corpus`` or
the layout scraper writes) -> one layout model forward -> the boxes drawn
as a PNG, coloured by predicted labels or by one class's probabilities.

Usage:
    python -m ocrs_models_torch.training.eval_layout <word_box_file> <out.png> \\
        --checkpoint text-layout-checkpoint.pt \\
        [--colors labels|line-start-probs|line-end-probs]

``--checkpoint`` takes the port's checkpoints and the JAX trainer's
``--export x.pt``. ``main(argv, device="cuda")`` runs on the GPU and raises
without one; tests pass ``device="cpu"``.
"""

from __future__ import annotations

import json
from argparse import ArgumentParser

import numpy as np
import torch

from ..device import resolve_device
from ..models import LayoutModel
from ..utils.render import draw_word_boxes
from .steps import numerics


def word_box_tensor(
    word_boxes: list[list[float]],
    img_width: int,
    img_height: int,
    normalize_coords: bool = False,
) -> np.ndarray:
    """``[left, top, right, bottom]`` rows -> model input array ``[W, 4]``."""
    x = np.asarray(word_boxes, dtype=np.float32).reshape(-1, 4)
    if normalize_coords:
        x = x / np.array([img_width, img_height, img_width, img_height]) - 0.5
    return x


def main(argv=None, device: str | torch.device = "cuda"):
    parser = ArgumentParser("Evaluate text layout model and preview results.")
    parser.add_argument("word_box_file")
    parser.add_argument("output_file")
    parser.add_argument("--checkpoint", required=True, type=str)
    parser.add_argument(
        "--colors", choices=["labels", "line-start-probs", "line-end-probs"]
    )
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    model = LayoutModel(return_probs=True)
    ckpt = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["model_state"], strict=True)
    model = model.to(dev).eval()

    with open(args.word_box_file) as f:
        wb = json.load(f)
    img_width = wb["resolution"]["width"]
    img_height = wb["resolution"]["height"]
    word_list = [
        [float(c) for c in word["coords"]]
        for para in wb["paragraphs"]
        for word in para["words"]
    ]
    boxes = word_box_tensor(word_list, img_width, img_height)
    with torch.no_grad(), numerics():
        probs = model(torch.from_numpy(boxes[None]).to(dev))[0].cpu().numpy()

    labels = prob_vec = None
    match args.colors:
        case "labels":
            labels = probs > 0.5
            print(
                f"Words {len(word_list)} predicted line starts "
                f"{int(labels[:, 0].sum())} line ends {int(labels[:, 1].sum())}"
            )
        case "line-start-probs":
            prob_vec = probs[:, 0]
        case "line-end-probs":
            prob_vec = probs[:, 1]

    draw_word_boxes(args.output_file, img_width, img_height, boxes, labels, prob_vec)


if __name__ == "__main__":
    main()
