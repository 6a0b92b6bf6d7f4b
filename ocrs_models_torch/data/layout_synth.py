"""Layout ground truth without a browser (the port's copy of
``ocrs_models_tpu/data/layout_synth.py``, numpy and json only).

A structured-document synthesizer writes pages in the layout scraper's JSON
schema::

    {"url": ..., "resolution": {"width", "height"},
     "paragraphs": [{"coords": [l,t,r,b],
                     "words": [{"text", "coords": [l,t,r,b]}, ...]}]}

so :class:`~ocrs_models_torch.data.web_layout.WebLayout`, and so the layout
trainer, read generated and scraped pages alike. Pages hold multi-column
bodies, headings, word-wrapped paragraphs with ragged or justified line
ends, indented lists, captions and occasional sub/superscript words; word
widths come from a syllable-based pseudo-word sampler scaled by the block's
font size. Page ``idx`` of seed ``s`` draws from
``default_rng(s * 1_000_003 + idx)`` and equals the JAX package's page.

CLI: ``python -m ocrs_models_torch.data.layout_synth OUT_DIR --pages N``
writes ``page-XXXXX.json`` files for ``train_layout OUT_DIR``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .web_layout import extract_word_boxes

_SYLLABLES = (
    "a an ar as at be ca co con de di do el en er es ex fa fi "
    "ga gen go ha he hi in is it la le li lo ma me mi mo na ne "
    "ni no on or ou pa pe po ra re ri ro sa se si so sta ta te "
    "ti to tra un ur us ve vi wa we wi"
).split()


def pseudo_word(rng: np.random.Generator) -> str:
    """Readable pseudo-word with a natural length distribution (median ~5
    chars, tail to ~14 like running English text)."""
    n_syl = 1 + min(int(rng.geometric(0.55)), 5)
    word = "".join(rng.choice(_SYLLABLES) for _ in range(n_syl))
    r = rng.uniform()
    if r < 0.04:
        word = word.capitalize()
    elif r < 0.05:
        word = word.upper()
    if rng.uniform() < 0.06:
        word += rng.choice([",", ".", ":", ";", ")"])
    return word


class DocumentSynthesizer:
    """Random structured documents in the scraper JSON schema."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def page(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        vw = int(rng.integers(800, 1700))
        vh = int(rng.integers(700, 2400))
        margin = float(rng.uniform(12, 80))
        n_cols = int(rng.choice([1, 1, 1, 2, 2, 3]))
        gutter = float(rng.uniform(16, 48))
        col_w = (vw - 2 * margin - (n_cols - 1) * gutter) / n_cols
        base_font = float(rng.uniform(11, 20))

        paragraphs = []
        for col in range(n_cols):
            x0 = margin + col * (col_w + gutter)
            y = margin + float(rng.uniform(0, 40))
            while y < vh - 60:
                kind = rng.choice(
                    ["para", "para", "para", "heading", "list", "caption"],
                )
                if kind == "heading":
                    font = base_font * float(rng.uniform(1.4, 2.4))
                    n_words = int(rng.integers(1, 7))
                    justify = False
                    indent = 0.0
                elif kind == "list":
                    font = base_font
                    n_words = int(rng.integers(4, 40))
                    justify = False
                    indent = float(rng.uniform(14, 40))
                elif kind == "caption":
                    font = base_font * float(rng.uniform(0.7, 0.9))
                    n_words = int(rng.integers(3, 18))
                    justify = False
                    indent = 0.0
                else:
                    font = base_font
                    n_words = int(rng.integers(8, 120))
                    justify = bool(rng.uniform() < 0.3)
                    indent = 0.0

                para, y = self._flow_paragraph(
                    rng, x0 + indent, y, col_w - indent, vh, font, n_words, justify
                )
                if para["words"]:
                    paragraphs.append(para)
                y += float(rng.uniform(0.4, 1.6)) * font + float(
                    rng.uniform(0, 18)
                )
                if kind == "list" and rng.uniform() < 0.6:
                    y -= float(rng.uniform(0, 12))  # tight list spacing

        return {
            "url": f"synthetic://doc/{self.seed}/{idx}",
            "resolution": {"width": vw, "height": vh},
            "paragraphs": paragraphs,
        }

    def _flow_paragraph(self, rng, x0, y0, width, vh, font, n_words, justify):
        """Word-wrap ``n_words`` pseudo-words into the column, returning the
        scraper-schema paragraph and the y just below its last line."""
        char_w = font * float(rng.uniform(0.46, 0.58))
        space_w = char_w * float(rng.uniform(0.5, 0.75))
        line_h = font * float(rng.uniform(1.15, 1.6))
        ascent = font * 0.8

        lines: list[list[tuple[str, float]]] = [[]]
        x = 0.0
        for _ in range(n_words):
            text = pseudo_word(rng)
            w = max(2.0, len(text) * char_w * float(rng.uniform(0.85, 1.15)))
            if x + w > width and lines[-1]:
                lines.append([])
                x = 0.0
            lines[-1].append((text, w))
            x += w + space_w

        words = []
        y = y0
        for li, line in enumerate(lines):
            if y + line_h > vh - 10:
                break
            total_w = sum(w for _, w in line)
            n_gaps = max(len(line) - 1, 1)
            if justify and li < len(lines) - 1 and len(line) > 1:
                gap = (width - total_w) / n_gaps
            else:
                gap = space_w
            x = x0
            top = y
            for text, w in line:
                w_top, w_bottom = top, top + ascent
                if rng.uniform() < 0.015:  # sub/superscript
                    shift = ascent * 0.35 * (1 if rng.uniform() < 0.5 else -1)
                    w_top += shift
                    w_bottom += shift
                w_top = max(w_top, 0.0)
                words.append(
                    {
                        "text": text,
                        "coords": [
                            round(x, 2),
                            round(w_top, 2),
                            round(x + w, 2),
                            round(w_bottom, 2),
                        ],
                    }
                )
                x += w + gap
            y += line_h

        if not words:
            return {"coords": [x0, y0, x0, y0], "words": []}, y0
        l = min(w["coords"][0] for w in words)
        t = min(w["coords"][1] for w in words)
        r = max(w["coords"][2] for w in words)
        b = max(w["coords"][3] for w in words)
        return {"coords": [l, t, r, b], "words": words}, y


class SyntheticDocLayout:
    """In-memory dataset over :class:`DocumentSynthesizer` pages with the
    same ``(boxes [W,4], labels [W,2])`` contract as ``WebLayout``."""

    def __init__(
        self,
        size: int = 128,
        n_words: int = 500,
        seed: int = 0,
        train: bool = True,
        normalize_coords: bool = True,
        randomize: bool = False,
        max_jitter: int = 25,
    ):
        # Disjoint page streams for train/val.
        self._synth = DocumentSynthesizer(seed=seed * 2 + (0 if train else 1))
        self.size = size
        self.n_words = n_words
        self.normalize_coords = normalize_coords
        self.randomize = randomize
        self.max_jitter = max_jitter
        self._rng = np.random.default_rng(seed + (0 if train else 77))

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int):
        content = self._synth.page(idx)
        jx = jy = 0.0
        if self.randomize:
            jx = float(self._rng.uniform(0, self.max_jitter))
            jy = float(self._rng.uniform(0, self.max_jitter))
        boxes, labels = extract_word_boxes(content, self.normalize_coords, jx, jy)
        out_b = np.zeros((self.n_words, 4), np.float32)
        out_l = np.zeros((self.n_words, 2), np.float32)
        k = min(len(boxes), self.n_words)
        out_b[:k] = boxes[:k]
        out_l[:k] = labels[:k]
        return out_b, out_l


def write_corpus(out_dir: str, n_pages: int, seed: int = 0) -> None:
    """Write ``n_pages`` scraper-schema JSON files into ``out_dir``: a
    directory ``train_layout`` reads as WebLayout data."""
    os.makedirs(out_dir, exist_ok=True)
    synth = DocumentSynthesizer(seed=seed)
    for i in range(n_pages):
        with open(os.path.join(out_dir, f"page-{i:05d}.json"), "w") as f:
            json.dump(synth.page(i), f)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Generate layout ground truth in the scraper JSON schema"
    )
    ap.add_argument("out_dir")
    ap.add_argument("--pages", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    write_corpus(args.out_dir, args.pages, args.seed)
    print(f"Wrote {args.pages} pages to {args.out_dir}")


if __name__ == "__main__":
    main()
