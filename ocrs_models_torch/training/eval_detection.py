"""Single-image detection inference CLI (the port's counterpart of
``ocrs_models_tpu/training/eval_detection.py``).

Load a checkpoint, resize the page to the training size, one forward,
binarize at 0.5, upsample the mask to the page's size by nearest
neighbour, extract the word quads, expand them by ``SHRINK_DISTANCE``, and
write ``<out>-input.png``, ``-text-probs.png`` (both at the training size),
``-text-regions.png`` and ``-text-words.png`` (at the page's size); print
the forward's time and the number of words.

Usage:
    python -m ocrs_models_torch.training.eval_detection \\
        text-detection-checkpoint.pt page.png out

The JAX CLI reads its page with PIL; this one reads a JPEG or an 8-bit PNG
through ``data.imageio.read_grey`` (the pixels of PIL's ``convert("L")``)
or a ``.npy`` array of pixel values in 0-255 (``[H, W]``, ``[H, W, 1]`` or
``[H, W, 3]``, RGB converted to grey as PIL's ``convert("L")`` does). ``model`` takes the port's checkpoints and the
JAX trainer's ``--export x.pt``. ``main(argv, device="cuda")`` runs on the
GPU and raises without one; tests pass ``device="cpu"``.
"""

from __future__ import annotations

import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch

from ..config import SHRINK_DISTANCE, DetectionTrainConfig
from ..data.imageio import read_grey, rgb_to_grey
from ..data.resize import resize
from ..device import resolve_device
from ..geometry import expand_quads, extract_cc_quads
from ..models import DetectionModel
from ..utils.render import draw_quads, to_grey, write_png
from .steps import numerics


def read_grey_page(path: str) -> np.ndarray:
    """A page as ``[H, W]`` float32 grey values in 0-255."""
    if not path.endswith(".npy"):
        return read_grey(path).astype(np.float32)
    arr = np.load(path)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim == 3 and arr.shape[-1] == 3:
        arr = rgb_to_grey(arr)  # PIL's convert("L")
    if arr.ndim != 2:
        raise ValueError(f"{path}: expected a greyscale or RGB page, got shape {arr.shape}")
    return arr.astype(np.float32)


def main(argv=None, device: str | torch.device = "cuda"):
    parser = ArgumentParser(description="Run text detection on one image.")
    parser.add_argument("model", help="Checkpoint (.pt)")
    parser.add_argument("image", help="Page: JPEG, PNG or .npy")
    parser.add_argument("out_basename")
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    cfg = DetectionTrainConfig()
    model = DetectionModel()
    ckpt = torch.load(args.model, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["model_state"], strict=True)
    model = model.to(dev).eval()

    grey = read_grey_page(args.image)
    input_h, input_w = grey.shape
    input_img = (grey / 255.0 - 0.5)[..., None]

    img = resize(input_img, cfg.mask_size)
    write_png(f"{args.out_basename}-input.png", to_grey(img))

    x = torch.from_numpy(np.ascontiguousarray(img[..., 0]))[None, None].to(dev)

    def forward() -> np.ndarray:
        with torch.no_grad(), numerics():
            return model(x)[0, 0].cpu().numpy()

    forward()  # warm-up: cuDNN picks its algorithms
    start = time.time()
    probs = forward()[..., None]  # [H, W, 1]
    print(f"Predicted text in {time.time() - start:.2f}s", file=sys.stderr)

    binary = np.where(probs > 0.5, 1.0, 0.0)
    binary_full = resize(binary, (input_h, input_w), nearest=True)[..., 0]
    text_regions = ((grey / 255.0) * binary_full - 0.5).astype(np.float32)
    write_png(f"{args.out_basename}-text-regions.png", to_grey(text_regions))
    write_png(f"{args.out_basename}-text-probs.png", to_grey(probs - 0.5))

    quads = expand_quads(extract_cc_quads(binary_full), dist=SHRINK_DISTANCE)
    write_png(f"{args.out_basename}-text-words.png", draw_quads(input_img, quads))
    print(f"Found {len(quads)} words")


if __name__ == "__main__":
    main()
