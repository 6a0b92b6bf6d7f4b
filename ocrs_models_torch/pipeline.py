"""End-to-end OCR serving on the GPU: detect -> group lines -> recognize.

Counterpart of ``ocrs_models_tpu/pipeline.py`` (``OcrPipeline``), with the
same results on the same weights: U-Net text detection, connected-component
word quads on the host, line grouping by vertical overlap, per-line crops
pooled into width buckets, CRNN recognition and greedy CTC decode.

Usage::

    pipe = OcrPipeline.from_jax_variables(det_vars, rec_vars)   # device="cuda"
    pages = pipe.run_batch(list_of_grey_hwc_images_in_[-0.5, 0.5])

Numerics: the forwards run float32 convolutions with cuDNN's TF32 turned
off (``torch.backends.cudnn.flags(allow_tf32=False)``) and leave matmul
TF32 off (PyTorch's default), so the f32 outputs keep the reference's
float32 parity contract. ``compute_dtype=torch.bfloat16`` is the serving
fast path of the JAX package: both models compute in bf16 (parameters stay
float32; detection's output layer and the recognizer's log-softmax are
float32).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import DEFAULT_ALPHABET, DET_SIZE, SHRINK_DISTANCE, round_up
from .data.resize import resize
from .device import resolve_device
from .geometry import expand_quads, extract_cc_quads
from .models import DetectionModel, RecognitionModel
from .utils.text import ctc_greedy_decode_batch, decode_text
from .weights import detection_state_dict_from_jax, recognition_state_dict_from_jax

_NOT_IN_SLICE = "is not ported yet; see ROADMAP.md, Queue 1"
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)  # np.packbits order: MSB first


@dataclasses.dataclass
class OcrLine:
    text: str
    box: tuple[float, float, float, float]  # (left, top, right, bottom)
    words: list[np.ndarray]  # word quads (4x2) composing the line


def _vertical_overlap(a, b) -> float:
    top = max(a[1], b[1])
    bottom = min(a[3], b[3])
    if bottom <= top:
        return 0.0
    return (bottom - top) / max(min(a[3] - a[1], b[3] - b[1]), 1e-6)


def group_words_into_lines(quads: np.ndarray, overlap_threshold: float = 0.5):
    """Group word quads into reading-order lines by vertical overlap of
    their bounding boxes. Returns ``[(line_box, member_indices)]``, lines
    top to bottom, members left to right."""
    if len(quads) == 0:
        return []
    boxes = np.stack([quads.min(axis=1), quads.max(axis=1)], axis=1).reshape(-1, 4)
    lines: list[dict] = []
    for i in np.argsort(boxes[:, 1]):  # by top
        box = boxes[i]
        for line in lines:
            if _vertical_overlap(line["box"], box) >= overlap_threshold:
                line["members"].append(i)
                lb = line["box"]
                line["box"] = [
                    min(lb[0], box[0]), min(lb[1], box[1]),
                    max(lb[2], box[2]), max(lb[3], box[3]),
                ]
                break
        else:
            lines.append({"box": list(box), "members": [i]})
    lines.sort(key=lambda ln: ln["box"][1])
    for line in lines:
        line["members"].sort(key=lambda i: boxes[i][0])
    return [(np.array(ln["box"]), ln["members"]) for ln in lines]


class OcrPipeline:
    def __init__(
        self,
        det_state_dict: Optional[dict] = None,
        rec_state_dict: Optional[dict] = None,
        use_layout_model: bool = False,
        alphabet: str = DEFAULT_ALPHABET,
        det_size: Optional[tuple[int, int]] = None,
        rec_height: int = 64,
        max_line_width: int = 800,
        width_step: int = 256,
        threshold: float = 0.5,
        mesh=None,
        compute_dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
        seed: int = 0,
    ):
        """State dicts are in the reference's torch format (see
        :mod:`ocrs_models_torch.weights`); a model whose state dict is None
        keeps PyTorch's default initialisation, drawn from ``seed``.
        ``compute_dtype``: ``torch.float32`` or ``torch.bfloat16``.

        ``device`` defaults to CUDA and raises without it; pass ``"cpu"``
        to run the plain PyTorch path."""
        if use_layout_model:
            raise NotImplementedError(f"use_layout_model=True {_NOT_IN_SLICE}")
        if mesh is not None:
            raise NotImplementedError(f"multi-GPU serving (mesh) {_NOT_IN_SLICE}")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"compute_dtype must be torch.float32 or torch.bfloat16, got {compute_dtype}")
        self.device = resolve_device(device)
        self.alphabet = alphabet
        self.det_size = tuple(det_size or DET_SIZE)
        self.rec_height = rec_height
        self.max_line_width = max_line_width
        self.width_step = width_step
        self.threshold = threshold

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            det = DetectionModel(dtype=compute_dtype)
            rec = RecognitionModel(n_classes=len(alphabet) + 1, dtype=compute_dtype)
        if det_state_dict is not None:
            det.load_state_dict(det_state_dict, strict=True)
        if rec_state_dict is not None:
            rec.load_state_dict(rec_state_dict, strict=True)
        self.det_model = det.to(self.device).eval().requires_grad_(False)
        self.rec_model = rec.to(self.device).eval().requires_grad_(False)
        self._bit_weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=self.device)

    @classmethod
    def from_jax_variables(cls, det_variables, rec_variables, **kwargs) -> "OcrPipeline":
        """Build from the JAX package's ``{"params", "batch_stats"}`` trees
        (nested dicts of arrays)."""
        return cls(
            detection_state_dict_from_jax(det_variables),
            recognition_state_dict_from_jax(rec_variables),
            **kwargs,
        )

    @classmethod
    def from_torch_state_dicts(cls, det_sd, rec_sd, **kwargs) -> "OcrPipeline":
        """Build from reference-format torch state dicts (e.g. the published
        ocrs checkpoints)."""
        return cls(det_sd, rec_sd, **kwargs)

    @contextlib.contextmanager
    def _numerics(self):
        """Inference mode with f32 convolutions kept out of TF32. cuDNN
        times its algorithms once per shape (``benchmark=True``): serving
        shapes are fixed per bucket, and the heuristic choice for the
        recognition convs in f32 (FFT) is an order of magnitude slower."""
        flags = torch.backends.cudnn.flags(
            enabled=True, benchmark=True, deterministic=False, allow_tf32=False
        )
        with torch.inference_mode(), flags:
            yield

    # ------------------------------------------------------------- stages

    def _det_masks(self, batch: np.ndarray) -> np.ndarray:
        """``[B, H, W, 1]`` pages -> ``[B, H, ceil(W/8)]`` packed binary
        masks. Forward, threshold and bit-packing run on the device, so
        only W/8 bytes per row come back to the host."""
        x = torch.from_numpy(np.ascontiguousarray(batch[..., 0])).to(self.device)[:, None]
        with self._numerics():
            bits = self.det_model(x)[:, 0] > self.threshold  # [B, H, W]
            b, h, w = bits.shape
            bits = torch.nn.functional.pad(bits, (0, (-w) % 8))
            packed = (bits.view(b, h, -1, 8).to(torch.uint8) * self._bit_weights).sum(
                dim=-1, dtype=torch.uint8
            )
        return packed.cpu().numpy()

    def _page_quads(self, images: list[np.ndarray], det_batch: int) -> list[np.ndarray]:
        """Word quads of each page, in the page's own pixel scale. Detection
        runs in fixed ``det_batch`` sub-batches (tail padded with blank
        pages); labeling and quad fitting run on the host."""
        det_h, det_w = self.det_size
        det_in = np.zeros((len(images), det_h, det_w, 1), np.float32)
        for p, img in enumerate(images):
            det_in[p] = resize(img, self.det_size)
        page_quads: list[np.ndarray] = []
        for start in range(0, len(images), det_batch):
            chunk = det_in[start : start + det_batch]
            pad = det_batch - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad, det_h, det_w, 1), np.float32)])
            packed = self._det_masks(chunk)
            for row in range(min(det_batch, len(images) - start)):
                h, w = images[start + row].shape[:2]
                binary = np.unpackbits(packed[row], axis=-1)[:, :det_w]
                quads = expand_quads(extract_cc_quads(binary), dist=SHRINK_DISTANCE)
                scale = np.array([w / det_w, h / det_h])
                page_quads.append(np.asarray(quads, np.float64) * scale)
        return page_quads

    def detect_words(self, image: np.ndarray) -> np.ndarray:
        """Greyscale ``[H, W, 1]`` image in [-0.5, 0.5] -> ``Nx4x2`` word
        quads in the input's scale."""
        return self._page_quads([image], det_batch=1)[0]

    def recognize_lines(self, image: np.ndarray, line_boxes: list[np.ndarray]) -> list[str]:
        """Crop line boxes and recognize them; each width bucket runs as one
        batch of exactly its line count (the latency path)."""
        crops = [self._crop_line(image, box) for box in line_boxes]
        return self._recognize_crops(crops, rec_batch=None)

    def __call__(self, image: np.ndarray) -> list[OcrLine]:
        """Full pipeline on one greyscale ``[H, W, 1]`` image in [-0.5, 0.5]."""
        quads = self.detect_words(image)
        lines = group_words_into_lines(quads)
        texts = self.recognize_lines(image, [box for box, _ in lines])
        return [
            OcrLine(
                text=text,
                box=tuple(float(v) for v in box),
                words=[quads[i] for i in members],
            )
            for text, (box, members) in zip(texts, lines)
        ]

    # ------------------------------------------------------- batched serving

    def _crop_line(self, image: np.ndarray, box) -> Optional[np.ndarray]:
        """Crop one line box and resize it to ``rec_height``; None for a
        degenerate box (its text is "")."""
        h, w = image.shape[:2]
        x0, y0, x1, y1 = box
        x0 = int(max(0, np.floor(x0)))
        y0 = int(max(0, np.floor(y0)))
        x1 = int(min(w, np.ceil(x1)))
        y1 = int(min(h, np.ceil(y1)))
        if x1 - x0 < 2 or y1 - y0 < 2:
            return None
        aspect = (x1 - x0) / (y1 - y0)
        out_w = min(self.max_line_width, max(10, int(self.rec_height * aspect)))
        return resize(image[y0:y1, x0:x1], (self.rec_height, out_w))

    def run_batch(
        self, images: list[np.ndarray], det_batch: int = 8, rec_batch: int = 128
    ) -> list[list[OcrLine]]:
        """Multi-page serving path: all pages move through each stage
        together so the GPU sees large, fixed shapes.

        - Detection runs in fixed ``det_batch`` sub-batches.
        - Word quads and line grouping run on the host, per page.
        - Line crops of all pages are pooled into global width buckets
          (multiples of ``width_step``, capped at ``max_line_width``) and
          recognized in fixed ``rec_batch`` rows, the tail zero-padded.

        :param images: greyscale ``[H, W, 1]`` float pages in [-0.5, 0.5]
            (sizes may differ).
        :return: per page, the same ``list[OcrLine]`` as ``__call__``.
        """
        if not images:
            return []
        page_quads = self._page_quads(images, det_batch)
        page_lines = [group_words_into_lines(q) for q in page_quads]
        flat_crops: list[Optional[np.ndarray]] = []
        flat_owner: list[tuple[int, int]] = []  # (page, line index)
        for p, lines in enumerate(page_lines):
            for li, (box, _) in enumerate(lines):
                flat_crops.append(self._crop_line(images[p], box))
                flat_owner.append((p, li))
        flat_texts = self._recognize_crops(flat_crops, rec_batch)

        out: list[list[OcrLine]] = [[] for _ in images]
        for (p, li), text in zip(flat_owner, flat_texts):
            box, members = page_lines[p][li]
            out[p].append(
                OcrLine(
                    text=text,
                    box=tuple(float(v) for v in box),
                    words=[page_quads[p][i] for i in members],
                )
            )
        return out

    def _recognize_crops(
        self, crops: list[Optional[np.ndarray]], rec_batch: Optional[int]
    ) -> list[str]:
        """Greedy-decode a flat crop list in width-bucket batches.

        ``rec_batch=None``: one exact-size batch per bucket (latency path).
        ``rec_batch=N``: fixed N-row chunks, tail zero-padded (serving
        path). The forward, argmax and CTC collapse run on the device; only
        the decoded ids come back."""
        texts = [""] * len(crops)
        valid = [i for i, c in enumerate(crops) if c is not None]
        widths = {
            i: min(round_up(crops[i].shape[1], self.width_step), self.max_line_width)
            for i in valid
        }
        for bucket in sorted(set(widths.values())):
            idxs = [i for i in valid if widths[i] == bucket]
            step = len(idxs) if rec_batch is None else rec_batch
            for start in range(0, len(idxs), step):
                rows = idxs[start : start + step]
                batch = np.zeros((step, self.rec_height, bucket), np.float32)
                lens = np.zeros((step,), np.int64)
                for row, i in enumerate(rows):
                    wi = min(crops[i].shape[1], bucket)
                    batch[row, :, :wi] = crops[i][:, :wi, 0]
                    lens[row] = wi // 4  # the model emits wi // 4 + 1 steps
                x = torch.from_numpy(batch).to(self.device)[:, None]
                with self._numerics():
                    ids = self.rec_model(x).argmax(dim=-1)
                    decoded, dec_lens = ctc_greedy_decode_batch(
                        ids, torch.from_numpy(lens).to(self.device)
                    )
                decoded, dec_lens = decoded.cpu().numpy(), dec_lens.cpu().numpy()
                for row, i in enumerate(rows):
                    texts[i] = decode_text(decoded[row, : dec_lens[row]], self.alphabet)
        return texts
