"""End-to-end OCR serving on the GPU: detect -> group lines -> recognize.

Counterpart of ``ocrs_models_tpu/pipeline.py`` (``OcrPipeline``), with the
same results on the same weights: U-Net text detection, connected-component
word quads on the host, line grouping by vertical overlap or by the layout
transformer (``use_layout_model=True``), per-line crops pooled into width
buckets, CRNN recognition and greedy CTC decode.

Usage::

    pipe = OcrPipeline.from_jax_variables(det_vars, rec_vars)   # device="cuda"
    pipe = OcrPipeline.from_checkpoints("det.pt", "rec.pt", "layout.pt",
                                        use_layout_model=True)
    pages = pipe.run_batch(list_of_grey_hwc_images_in_[-0.5, 0.5])

Numerics: the forwards run float32 convolutions with cuDNN's TF32 turned
off (``torch.backends.cudnn.flags(allow_tf32=False)``) and leave matmul
TF32 off (PyTorch's default), so the f32 outputs keep the reference's
float32 parity contract. ``compute_dtype=torch.bfloat16`` is the serving
fast path of the JAX package: both models compute in bf16 (parameters stay
float32; detection's output layer and the recognizer's log-softmax are
float32). The layout model runs in float32 whatever ``compute_dtype`` is,
as in the JAX package, with matmul TF32 turned off.
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
from .models import DetectionModel, LayoutModel, RecognitionModel
from .training.steps import numerics
from .utils.text import ctc_greedy_decode_batch, decode_text
from .weights import (
    detection_state_dict_from_jax,
    layout_state_dict_from_jax,
    recognition_state_dict_from_jax,
)

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


def group_lines_from_layout_probs(
    boxes: np.ndarray,
    probs: np.ndarray,
    threshold: float = 0.5,
    geometry_guard: bool = True,
):
    """Split a reading-ordered word-box sequence into lines at predicted
    line starts.

    The model proposes, geometry vetoes: with ``geometry_guard`` a word
    whose box has no vertical overlap with the previous word starts a new
    line whatever its probability, and a predicted line end forces the next
    word to start one. The first word always starts a line.

    :param boxes: ``[W, 4]`` word boxes in reading order.
    :param probs: ``[W, 2]`` (line_start, line_end) probabilities.
    :return: ``[(line_box, member_indices)]`` in sequence order.
    """
    lines: list[dict] = []
    force_new = True
    for i, box in enumerate(boxes):
        new_line = probs[i, 0] >= threshold or force_new
        if not new_line and geometry_guard and _vertical_overlap(boxes[i - 1], box) <= 0.0:
            new_line = True
        if new_line:
            lines.append({"box": list(box), "members": [i]})
        else:
            line = lines[-1]
            line["members"].append(i)
            lb = line["box"]
            line["box"] = [
                min(lb[0], box[0]), min(lb[1], box[1]),
                max(lb[2], box[2]), max(lb[3], box[3]),
            ]
        force_new = probs[i, 1] >= threshold
    return [(np.array(ln["box"]), ln["members"]) for ln in lines]


class OcrPipeline:
    def __init__(
        self,
        det_state_dict: Optional[dict] = None,
        rec_state_dict: Optional[dict] = None,
        layout_state_dict: Optional[dict] = None,
        use_layout_model: bool = False,
        alphabet: str = DEFAULT_ALPHABET,
        det_size: Optional[tuple[int, int]] = None,
        rec_height: int = 64,
        max_line_width: int = 800,
        width_step: int = 256,
        threshold: float = 0.5,
        layout_pad_words: int = 500,
        mesh=None,
        compute_dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
        seed: int = 0,
    ):
        """State dicts are in the reference's torch format (see
        :mod:`ocrs_models_torch.weights`); a model whose state dict is None
        keeps PyTorch's default initialisation, drawn from ``seed``.
        ``compute_dtype``: ``torch.float32`` or ``torch.bfloat16``.

        ``use_layout_model`` groups words into lines with the layout
        transformer (``LayoutModel(return_probs=True)`` at the reference's
        width, float32) and needs ``layout_state_dict``; every page is
        padded to ``layout_pad_words`` words, and a page's words past that
        become lines of their own.

        ``device`` defaults to CUDA and raises without it; pass ``"cpu"``
        to run the plain PyTorch path."""
        if use_layout_model and layout_state_dict is None:
            raise ValueError("use_layout_model=True requires layout_state_dict")
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
        self.use_layout_model = use_layout_model
        self.layout_pad_words = layout_pad_words

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
        self.layout_model = None
        if layout_state_dict is not None:
            layout = LayoutModel(return_probs=True)
            layout.load_state_dict(layout_state_dict, strict=True)
            self.layout_model = layout.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_jax_variables(
        cls, det_variables, rec_variables, layout_variables=None, **kwargs
    ) -> "OcrPipeline":
        """Build from the JAX package's variable trees (nested dicts of
        arrays): ``{"params", "batch_stats"}`` for detection and
        recognition, ``{"params"}`` for the layout model."""
        layout_sd = None
        if layout_variables is not None:
            layout_sd = layout_state_dict_from_jax(layout_variables)
        return cls(
            detection_state_dict_from_jax(det_variables),
            recognition_state_dict_from_jax(rec_variables),
            layout_sd,
            **kwargs,
        )

    @classmethod
    def from_checkpoints(
        cls, det_ckpt: str, rec_ckpt: str, layout_ckpt: Optional[str] = None, **kwargs
    ) -> "OcrPipeline":
        """Build from reference-format ``.pt`` checkpoints (``{"epoch",
        "model_state", ...}``: what the port's trainers and the JAX
        trainers' ``--export x.pt`` write)."""

        def model_state(path):
            return torch.load(path, map_location="cpu", weights_only=True)["model_state"]

        layout_sd = model_state(layout_ckpt) if layout_ckpt is not None else None
        return cls(model_state(det_ckpt), model_state(rec_ckpt), layout_sd, **kwargs)

    @classmethod
    def from_torch_state_dicts(cls, det_sd, rec_sd, **kwargs) -> "OcrPipeline":
        """Build from reference-format torch state dicts (e.g. the published
        ocrs checkpoints)."""
        return cls(det_sd, rec_sd, **kwargs)

    @contextlib.contextmanager
    def _numerics(self):
        """Inference mode with f32 convolutions and matmuls kept out of
        TF32. cuDNN times its algorithms once per shape
        (``benchmark=True``): serving shapes are fixed per bucket, and the
        heuristic choice for the recognition convs in f32 (FFT) is an order
        of magnitude slower."""
        with torch.inference_mode(), numerics():
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
        if self.use_layout_model:
            lines = self.group_lines_with_layout_model(quads)
        else:
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

    def group_lines_with_layout_model(self, quads: np.ndarray):
        """Line grouping of one page by the layout transformer; the same
        ``[(line_box, member_indices)]`` contract as
        :func:`group_words_into_lines`."""
        return self._group_lines_layout_batch([quads])[0]

    def _layout_inputs(self, page_quads: list[np.ndarray]):
        """The layout model's input for many pages: ``[n_pages,
        layout_pad_words, 4]`` float32 word boxes, each page's words in
        reading order (by row, the top edge over the median word height,
        rounded; then by left edge) and zero-padded; and per page its
        ``(boxes, order, k)`` (None for a page without words): the boxes,
        their reading order and how many of them the model sees."""
        padded = np.zeros((len(page_quads), self.layout_pad_words, 4), np.float32)
        pages: list[Optional[tuple]] = []
        for p, quads in enumerate(page_quads):
            if len(quads) == 0:
                pages.append(None)
                continue
            boxes = np.stack([quads.min(axis=1), quads.max(axis=1)], axis=1).reshape(-1, 4)
            med_h = float(np.median(boxes[:, 3] - boxes[:, 1]))
            row = np.round(boxes[:, 1] / max(med_h, 1.0)).astype(np.int64)
            order = np.lexsort((boxes[:, 0], row))
            k = min(len(order), self.layout_pad_words)
            padded[p, :k] = boxes[order[:k]]
            pages.append((boxes, order, k))
        return padded, pages

    def _group_lines_layout_batch(self, page_quads: list[np.ndarray]):
        """Layout-model line grouping of many pages in ONE padded forward
        on the device (see :meth:`_layout_inputs`). A page without words
        gets no lines; a page's words past ``layout_pad_words`` become
        lines of their own."""
        padded, pages = self._layout_inputs(page_quads)
        if all(page is None for page in pages):
            return [[] for _ in pages]
        with self._numerics():
            probs = self.layout_model(torch.from_numpy(padded).to(self.device)).cpu().numpy()
        page_lines = []
        for p, page in enumerate(pages):
            if page is None:
                page_lines.append([])
                continue
            boxes, order, k = page
            lines = group_lines_from_layout_probs(boxes[order[:k]], probs[p, :k])
            mapped = [(box, [int(order[i]) for i in members]) for box, members in lines]
            mapped += [(boxes[i].copy(), [int(i)]) for i in order[k:]]
            page_lines.append(mapped)
        return page_lines

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
        - Word quads run on the host, per page; line grouping too, or, with
          the layout model, one padded forward for all pages on the device.
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
        if self.use_layout_model:
            page_lines = self._group_lines_layout_batch(page_quads)
        else:
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
