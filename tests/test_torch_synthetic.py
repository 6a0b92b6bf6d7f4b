"""The port's PIL-free synthetic text lines against the JAX package's
Pillow drawing, its glyph atlas against a fresh Pillow rendering, and its
numpy rotation against PIL's.

    python tests/test_torch_synthetic.py --write-atlas

renders ``ocrs_models_torch/data/glyphs_aileron38.npz`` with Pillow's
default font (this file holds the only Pillow code of the atlas, since
the port imports no PIL).

Tolerances: the atlas equals the fresh rendering exactly; the rendered
lines equal the JAX package's to 1/255 but for at most 1e-4 of a line's
pixels, none off by more than 16/255 (measured: equal); the rotation
equals PIL's to 1e-5 (measured: bit for bit); augmented samples, where
the augmentation resamples the height back to 64, at the line tolerance.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ocrs_models_torch.config import DEFAULT_ALPHABET  # noqa: E402
from ocrs_models_torch.data import glyphs  # noqa: E402

FONT_SIZE = 38  # int(64 * 0.6), the JAX dataset's size for 64-high lines


def render_atlas() -> dict:
    """The glyph atlas's arrays, rendered with Pillow's default font."""
    import PIL
    from PIL import ImageFont

    font = ImageFont.load_default(size=FONT_SIZE)
    advance, right, offset, shape, bitmaps = [], [], [], [], []
    for ch in DEFAULT_ALPHABET:
        mask, off = font.getmask2(ch, "L")
        w, h = mask.size
        bitmaps.append(np.asarray(mask, dtype=np.uint8).reshape(h, w))
        length = font.getlength(ch)
        if length != int(length):
            raise ValueError(f"{ch!r} has a fractional advance {length}")
        advance.append(int(length))
        right.append(font.getbbox(ch)[2])
        offset.append(off)
        shape.append((h, w))
    start = np.cumsum([0] + [b.size for b in bitmaps])
    return {
        "chars": np.array(list(DEFAULT_ALPHABET)),
        "advance": np.asarray(advance, np.int32),
        "right": np.asarray(right, np.int32),
        "offset": np.asarray(offset, np.int32),
        "shape": np.asarray(shape, np.int32),
        "start": start.astype(np.int64),
        "pixels": np.concatenate([b.ravel() for b in bitmaps]),
        "font": np.array(" ".join(font.getname())),
        "font_size": np.array(FONT_SIZE),
        "pillow": np.array(PIL.__version__),
    }


def test_atlas_equals_a_fresh_pillow_rendering():
    fresh = render_atlas()
    with np.load(glyphs.ATLAS_PATH, allow_pickle=False) as stored:
        assert sorted(stored.files) == sorted(fresh)
        for key, value in fresh.items():
            np.testing.assert_array_equal(stored[key], value, err_msg=key)
    atlas = glyphs.GlyphAtlas()
    assert atlas.font == "Aileron Regular" and atlas.font_size == FONT_SIZE


def _assert_line_close(got: np.ndarray, want: np.ndarray, what) -> None:
    assert got.shape == want.shape, (what, got.shape, want.shape)
    diff = np.abs(got.astype(np.float64) - want)
    assert diff.max() <= 16 / 255 + 1e-6, (what, diff.max())
    assert (diff > 1 / 255 + 1e-6).mean() <= 1e-4, (what, (diff > 1 / 255 + 1e-6).mean())


@pytest.mark.parametrize("seed", [0, 1234, 1235])
def test_synthetic_lines_match_jax(seed):
    from ocrs_models_tpu.data.synthetic import SyntheticRecognition as JaxSynthetic
    from ocrs_models_torch.data import SyntheticRecognition

    ours, theirs = SyntheticRecognition(size=200, seed=seed), JaxSynthetic(size=200, seed=seed)
    for i in range(200):
        got, want = ours[i], theirs[i]
        np.testing.assert_array_equal(got["text"], want["text"])
        assert got["image"].dtype == np.float32 and got["text"].dtype == np.int32
        _assert_line_close(got["image"], want["image"], (seed, i))


def test_render_line_refuses_what_the_atlas_lacks():
    with pytest.raises(ValueError, match="size 38"):
        glyphs.render_line("abc", height=32)
    with pytest.raises(ValueError, match="not in the glyph atlas"):
        glyphs.render_line("\u00e9t\u00e9")


def test_rotate_expand_matches_pil():
    from PIL import Image

    from ocrs_models_tpu.data.augment import _rotate_expand as jax_rotate_expand
    from ocrs_models_torch.data.augment import _rotate_expand, rotate_expand

    rng = np.random.default_rng(0)
    for i in range(50):
        h, w = int(rng.integers(54, 75)), int(rng.integers(10, 800))
        img = rng.uniform(-0.5, 0.5, (h, w, 1)).astype(np.float32)
        img[:, : w // 3] = -0.5  # flat runs beside noise, as a text line has
        seed = int(rng.integers(1 << 31))
        want = jax_rotate_expand(np.random.default_rng(seed), [img])[0]
        got = _rotate_expand(np.random.default_rng(seed), [img])[0]
        assert got.shape == want.shape and got.dtype == np.float32, (i, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=str(i))
    # Angles PIL treats on their own: zero (a copy) and the far ends.
    img = rng.uniform(-0.5, 0.5, (64, 37)).astype(np.float32)
    for angle in (0.0, 5.0, -5.0, 360.0):
        want = np.asarray(Image.fromarray(img, mode="F").rotate(
            angle, resample=Image.BILINEAR, expand=True, fillcolor=-0.5))
        np.testing.assert_allclose(rotate_expand(img, angle), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1234])
def test_augmented_lines_match_jax(seed):
    from ocrs_models_tpu.data.augment import RecognitionAugment as JaxAugment
    from ocrs_models_tpu.data.synthetic import SyntheticRecognition as JaxSynthetic
    from ocrs_models_torch.data import SyntheticRecognition
    from ocrs_models_torch.data.augment import RecognitionAugment

    ours = SyntheticRecognition(size=100, seed=seed, transform=RecognitionAugment(seed))
    theirs = JaxSynthetic(size=100, seed=seed, transform=JaxAugment(seed))
    widths = set()
    for i in range(100):
        got, want = ours[i], theirs[i]
        np.testing.assert_array_equal(got["text"], want["text"])
        _assert_line_close(got["image"], want["image"], (seed, i))
        widths.add(got["image"].shape[1])
    assert len(widths) > 50


if __name__ == "__main__" and "--write-atlas" in sys.argv:
    np.savez_compressed(glyphs.ATLAS_PATH, **render_atlas())
    print(f"wrote {glyphs.ATLAS_PATH}")
