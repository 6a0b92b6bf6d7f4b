"""The port's detection data and geometry against the JAX package's, on the
CPU, from the same numpy inputs: polygon shrinking and clipping, the
Pillow-exact polygon fill and the masks, box-match metrics, collation, the
synthetic pages, the four augmentation branches and the resizes, and the
rendering behind ``eval_detection`` and ``--debug-images``.

Tolerances, and why:

- ``shrink_polygon``, ``convex_intersection_area``, ``fill_polygon``,
  ``generate_mask``: equal, bit for bit, on each backend (the numpy
  versions against the JAX package's numpy versions, the C++ core against
  its C++ core, and the two backends of the port against each other: the
  fill is integer work on float32 crossings, the rest the same double
  arithmetic in the same order).
- ``box_match_metrics``: 1e-12 (ratios of the same double areas).
- collation, ``SyntheticDetection``, the warps, crops and jitter, nearest
  resizes, rendering and the PNG codec: equal, bit for bit. PIL's
  ``transform`` is reproduced, samples and maps alike (16.16 fixed point
  for the nearest affine map, as Pillow computes it).
- the augmented samples (``DetectionAugment``): 1e-5; they end in the
  bilinear resize, which matches PIL's to float32 rounding (read 6e-8).
"""

import numpy as np
import pytest
from PIL import Image, ImageDraw

from ocrs_models_tpu.data import SyntheticDetection as JaxSyntheticDetection
from ocrs_models_tpu.data import augment as jax_augment
from ocrs_models_tpu.data.collate import collate_detection as jax_collate_detection
from ocrs_models_tpu.geometry import metrics as jax_metrics
from ocrs_models_tpu.geometry import polygon as jax_polygon
from ocrs_models_tpu.geometry import raster as jax_raster
from ocrs_models_tpu.utils import image as jax_image
from ocrs_models_tpu.utils import metrics as jax_util_metrics
from ocrs_models_tpu.utils.render import draw_quads as pil_draw_quads
from ocrs_models_tpu.utils.render import to_pil_grey
from ocrs_models_torch.data import SyntheticDetection, collate_detection
from ocrs_models_torch.data import augment
from ocrs_models_torch.data.resize import resize
from ocrs_models_torch.geometry import metrics, native, polygon, raster
from ocrs_models_torch.training.eval_detection import read_grey_page
from ocrs_models_torch.utils import image, render
from ocrs_models_torch.utils import metrics as util_metrics
from torch_port_common import use_geometry_backend


@pytest.fixture(params=["numpy", "native"])
def backend(request, monkeypatch):
    use_geometry_backend(request.param, monkeypatch)
    return request.param


def _quads(rng, n: int, scale: float = 60.0) -> np.ndarray:
    """Rotated rectangles and skewed quads of many sizes, some sub-pixel,
    some thin enough to vanish when shrunk."""
    out = []
    for _ in range(n):
        c = rng.uniform(-5, scale, 2)
        w, h = rng.choice([0.4, 3.0, 7.0, 20.0, 45.0]), rng.choice([2.0, 6.5, 9.0, 30.0])
        a = rng.uniform(0, np.pi)
        d, e = np.array([np.cos(a), np.sin(a)]), np.array([-np.sin(a), np.cos(a)])
        quad = np.array([c, c + w * d, c + w * d + h * e, c + h * e])
        if rng.uniform() < 0.3:
            quad = quad + rng.normal(0, 1.5, (4, 2))
        if rng.uniform() < 0.3:
            quad = np.round(quad)
        out.append(quad[::-1] if rng.uniform() < 0.5 else quad)
    return np.array(out)


def test_shrink_polygon_matches_jax(backend):
    rng = np.random.default_rng(0)
    kept = 0
    for quad in _quads(rng, 300):
        for dist in (3.0, 1.0, -2.0):
            want = jax_polygon.shrink_polygon(quad, dist)
            got = polygon.shrink_polygon(quad, dist)
            assert got == want
            kept += bool(got)
    assert 300 < kept < 900  # some survive, some collapse
    pentagon = [(0, 0), (10, 0), (12, 7), (5, 12), (-2, 7)]
    assert polygon.shrink_polygon(pentagon, 1.5) == jax_polygon.shrink_polygon(pentagon, 1.5)


def test_shrink_backends_agree():
    if not native.available():
        pytest.skip("no C++ toolchain: only the numpy versions run here")
    rng = np.random.default_rng(1)
    for quad in _quads(rng, 200):
        assert polygon.shrink_polygon_numpy(quad, 3.0) == polygon.shrink_polygon(quad, 3.0)
        a, b = quad, _quads(rng, 1)[0] + quad[0] - 5
        assert (polygon.convex_intersection_area_numpy(a, b)
                == polygon.convex_intersection_area(a, b))


def test_convex_intersection_area_matches_jax(backend):
    rng = np.random.default_rng(2)
    quads = _quads(rng, 120, scale=20.0)
    nonzero = 0
    for a, b in zip(quads[:60], quads[60:]):
        want = jax_polygon.convex_intersection_area(a, b)
        assert polygon.convex_intersection_area(a, b) == want
        nonzero += want > 0
    assert nonzero > 10
    square = np.array([[0, 0], [4, 0], [4, 4], [0, 4]], float)
    assert polygon.convex_intersection_area(square, square + 2) == 4.0


def test_fill_polygon_matches_jax_and_pil(backend):
    rng = np.random.default_rng(3)
    for quad in _quads(rng, 200):
        want = jax_raster.fill_polygon(48, 40, quad)
        got = raster.fill_polygon(48, 40, quad)
        np.testing.assert_array_equal(got, want)
    # Pillow itself, on shapes whose truncated vertices stay distinct.
    for poly in ([(3, 2), (30, 5), (25, 33), (5, 20)], [(10.7, 1.2), (40.2, 30.9), (2.5, 35.5)],
                 [(0, 0), (47, 0), (47, 39), (0, 39)], [(20, -5), (60, 20), (20, 45), (-10, 20)]):
        img = Image.new("L", (48, 40), 0)
        ImageDraw.Draw(img).polygon(poly, fill=1)
        np.testing.assert_array_equal(raster.fill_polygon(48, 40, poly), np.asarray(img))


def test_generate_mask_matches_jax(backend):
    rng = np.random.default_rng(4)
    polys = list(_quads(rng, 40, scale=90.0))
    for shrink in (3.0, 0.0):
        want = jax_raster.generate_mask(100, 80, polys, shrink_dist=shrink)
        got = raster.generate_mask(100, 80, polys, shrink_dist=shrink)
        assert got.dtype == np.float32 and got.any()
        np.testing.assert_array_equal(got, want)


def test_box_match_metrics_matches_jax(backend):
    rng = np.random.default_rng(5)
    target = _quads(rng, 30, scale=100.0)
    cases = [
        (target + rng.normal(0, 2.0, target.shape), target),  # good matches
        (_quads(rng, 12, scale=100.0), target),  # merges and splits
        (np.zeros((0, 4, 2)), target),
        (target, np.zeros((0, 4, 2))),
        (np.zeros((0, 4, 2)), np.zeros((0, 4, 2))),
    ]
    merged = np.array([[[0, 0], [40, 0], [40, 10], [0, 10]]], float)
    parts = np.array([[[0, 0], [18, 0], [18, 10], [0, 10]], [[21, 0], [40, 0], [40, 10], [21, 10]]],
                     float)
    cases += [(merged, parts), (parts, merged)]
    for pred, tgt in cases:
        want = jax_metrics.box_match_metrics(pred, tgt)
        got = metrics.box_match_metrics(pred, tgt)
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12, err_msg=k)
    assert metrics.box_match_metrics(merged, parts)["merged_frac"] == 1.0
    assert metrics.box_match_metrics(parts, merged)["split_frac"] == 1.0


def test_metric_means_and_image_convention_match_jax():
    rng = np.random.default_rng(6)
    dicts = [{"precision": rng.uniform(), "recall": rng.uniform()} for _ in range(5)]
    dicts.append({"precision": 0.5})
    assert util_metrics.get_metric_means(dicts) == jax_util_metrics.get_metric_means(dicts)
    assert util_metrics.get_metric_means([]) == {}
    means = util_metrics.get_metric_means(dicts)
    assert util_metrics.format_metrics(means) == jax_util_metrics.format_metrics(means)
    pixels = rng.integers(0, 256, (9, 7), dtype=np.uint8)
    np.testing.assert_array_equal(image.transform_image(pixels), jax_image.transform_image(pixels))
    floats = rng.uniform(-0.7, 0.7, (9, 7)).astype(np.float32)
    np.testing.assert_array_equal(image.untransform_image(floats),
                                  jax_image.untransform_image(floats))


# ------------------------------------------------------------ data


def test_synthetic_detection_matches_jax():
    for seed, size in ((0, (256, 192)), (7, (800, 600)), (3, (200, 400))):
        want_ds = JaxSyntheticDetection(size=3, page_size=size, seed=seed)
        got_ds = SyntheticDetection(size=3, page_size=size, seed=seed)
        for i in range(3):
            want, got = want_ds[i], got_ds[i]
            assert got["path"] == want["path"]
            for key in ("image", "mask"):
                assert got[key].dtype == want[key].dtype == np.float32
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["mask"].any()


def test_collate_detection_matches_jax():
    samples = [JaxSyntheticDetection(size=3, page_size=(128, 96), seed=1)[i] for i in range(3)]
    for multiple in (1, 4):
        want = jax_collate_detection(samples, batch_multiple=multiple)
        got = collate_detection(samples, batch_multiple=multiple)
        assert got.keys() == want.keys()
        assert got["n_valid"] == want["n_valid"] == 3 and got["path"] == want["path"]
        np.testing.assert_array_equal(got["sample_weight"], want["sample_weight"])
        for key in ("image", "mask"):
            assert got[key].shape == (len(want[key]), 1, 128, 96)
            np.testing.assert_array_equal(got[key], want[key].transpose(0, 3, 1, 2))
    no_path = [{"image": s["image"], "mask": s["mask"]} for s in samples]
    assert "path" not in collate_detection(no_path)


def _page(seed: int = 0, size=(180, 140)) -> tuple[np.ndarray, np.ndarray]:
    sample = JaxSyntheticDetection(size=1, page_size=size, seed=seed)[0]
    return sample["image"], sample["mask"]


@pytest.mark.parametrize("branch", ["_color_jitter", "_affine", "_perspective", "_random_crop"])
def test_augment_branches_match_pil(branch):
    img, mask = _page()
    for seed in range(4):
        want = getattr(jax_augment, branch)(np.random.default_rng(seed), [img, mask])
        got = getattr(augment, branch)(np.random.default_rng(seed), [img, mask])
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    assert got[1].any() and (got[0] != jax_augment.FILL).any()


def test_detection_augment_matches_jax():
    img, mask = _page(seed=2, size=(400, 300))
    branches = set()
    for idx in range(24):
        rng = np.random.default_rng((5, idx))
        branches.add(int(rng.integers(0, 4)) if rng.uniform() < 0.5 else -1)
        want = jax_augment.DetectionAugment((160, 120), seed=5)(img, mask, idx=idx)
        got = augment.DetectionAugment((160, 120), seed=5)(img, mask, idx=idx)
        for g, w in zip(got, want):
            assert g.shape == w.shape == (160, 120, 1)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    assert branches == {-1, 0, 1, 2, 3}  # every branch ran, and none
    want = jax_augment.DetectionAugment((160, 120), augment=False)(img, mask, idx=0)
    got = augment.DetectionAugment((160, 120), augment=False)(img, mask, idx=0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_transforms_match_pil_at_odd_maps():
    rng = np.random.default_rng(8)
    src = rng.uniform(-0.5, 0.5, (37, 29)).astype(np.float32)
    pil = Image.fromarray(src, mode="F")
    maps = [(1.3, 0.2, -4.0, -0.15, 0.8, 6.5), (0.5, 0.0, 3.0, 0.0, 2.0, -1.0),
            (-1.0, 0.0, 28.0, 0.0, 1.0, 0.0), (0.9, -0.4, 12.0, 0.4, 0.9, -8.0)]
    for coeffs in maps:
        for nearest in (False, True):
            resample = Image.NEAREST if nearest else Image.BILINEAR
            want = np.asarray(pil.transform((41, 33), Image.AFFINE, coeffs, resample=resample,
                                            fillcolor=0.25))
            got = augment.transform_affine(src, (41, 33), coeffs, nearest, 0.25)
            np.testing.assert_array_equal(got, want, err_msg=str((coeffs, nearest)))
    persp = (1.1, 0.05, -2.0, -0.03, 0.95, 1.5, 0.002, -0.001)
    for nearest in (False, True):
        resample = Image.NEAREST if nearest else Image.BILINEAR
        want = np.asarray(pil.transform((31, 40), Image.PERSPECTIVE, persp, resample=resample,
                                        fillcolor=-0.5))
        np.testing.assert_array_equal(augment.transform_perspective(src, (31, 40), persp, nearest,
                                                                    -0.5), want)


def test_nearest_resize_matches_pil():
    rng = np.random.default_rng(9)
    img = (rng.uniform(size=(90, 70, 1)) > 0.5).astype(np.float32)
    for size in ((800, 600), (90, 70), (45, 35), (33, 101), (91, 71), (7, 3)):
        want = jax_augment.resize(img, size, nearest=True)
        got = resize(img, size, nearest=True)
        assert got.shape == want.shape == size + (1,)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- rendering


def test_draw_quads_matches_pil():
    rng = np.random.default_rng(10)
    img = rng.uniform(-0.5, 0.5, (70, 90, 1)).astype(np.float32)
    quads = np.concatenate([_quads(rng, 20, scale=90.0),
                            np.round(_quads(rng, 10, scale=90.0)),
                            np.full((1, 4, 2), 12.0)])  # a point: a zero-length line
    want = np.asarray(pil_draw_quads(img, quads))
    got = render.draw_quads(img, quads)
    assert got.dtype == np.uint8 and (got != np.repeat(got[..., :1], 3, -1)).any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(render.to_grey(img), np.asarray(to_pil_grey(img)))
    grey = rng.integers(0, 256, (5, 4), dtype=np.uint8)
    np.testing.assert_array_equal(render.to_grey(grey), np.asarray(to_pil_grey(grey)))


def _png_with_filters(path, img: np.ndarray, filters) -> None:
    """Write ``img`` as a PNG whose rows use the given filter types (0-4),
    so that the reader meets every one."""
    import struct
    import zlib

    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else 3
    rows = img.reshape(h, w * bpp).astype(np.int64)
    raw = bytearray()
    prev = np.zeros(w * bpp, np.int64)
    for y in range(h):
        kind, line = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            pa, pb, pc = abs(prev - upleft), abs(left - upleft), abs(left + prev - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw += bytes([kind]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = line

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    color = 0 if bpp == 1 else 2
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                                                   0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_png_reader_and_writer(tmp_path, mode):
    rng = np.random.default_rng(11)
    shape = (23, 31) if mode == "L" else (23, 31, 3)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[5:9] = np.arange(31)[:, None] * 8 if mode == "RGB" else np.arange(31) * 8
    Image.fromarray(img, mode).save(tmp_path / "pil.png")
    np.testing.assert_array_equal(render.read_png(str(tmp_path / "pil.png")), img)
    _png_with_filters(tmp_path / "filters.png", img, [0, 1, 2, 3, 4])
    assert np.array_equal(np.asarray(Image.open(tmp_path / "filters.png")), img)  # a valid PNG
    np.testing.assert_array_equal(render.read_png(str(tmp_path / "filters.png")), img)
    render.write_png(str(tmp_path / "port.png"), img)
    with Image.open(tmp_path / "port.png") as written:
        assert written.mode == mode
        np.testing.assert_array_equal(np.asarray(written), img)


def test_png_reader_refuses_other_formats(tmp_path):
    import struct
    import zlib

    def with_header_byte(src, name, offset, value):
        data = bytearray((tmp_path / src).read_bytes())
        data[offset] = value
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
        (tmp_path / name).write_bytes(bytes(data))

    # 16-bit greyscale is read (since the decoder took every PNG depth), as
    # Pillow's "I;16" holds it.
    deep = (np.arange(16, dtype=np.uint16) * 4001).reshape(4, 4)
    Image.fromarray(deep).save(tmp_path / "deep.png")
    with Image.open(tmp_path / "deep.png") as img:
        np.testing.assert_array_equal(render.read_png(str(tmp_path / "deep.png")),
                                      np.asarray(img))
    # Headers that lie about the data: a non-interlaced greyscale PNG with
    # its interlace flag set (Adam7's passes need other row counts), an
    # 8-bit RGBA PNG with its bit depth set to 16 (half the bytes needed);
    # a layout PNG does not have: palette at 16 bits; and not a PNG.
    Image.new("L", (9, 9)).save(tmp_path / "plain.png")
    with_header_byte("plain.png", "interlaced.png", 28, 1)
    Image.fromarray(np.zeros((4, 4, 4), np.uint8), "RGBA").save(tmp_path / "rgba8.png")
    with_header_byte("rgba8.png", "rgba.png", 24, 16)
    Image.new("P", (4, 4)).save(tmp_path / "p8.png")
    with_header_byte("p8.png", "palette16.png", 24, 16)
    (tmp_path / "text.png").write_text("not a png")
    for name in ("rgba", "palette16", "interlaced", "text"):
        with pytest.raises(ValueError, match="PNG"):
            render.read_png(str(tmp_path / f"{name}.png"))


def test_read_grey_page_matches_pil_convert(tmp_path):
    rng = np.random.default_rng(12)
    rgb = rng.integers(0, 256, (17, 13, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(tmp_path / "page.png")
    want = np.asarray(Image.open(tmp_path / "page.png").convert("L"), dtype=np.float32)
    np.testing.assert_array_equal(read_grey_page(str(tmp_path / "page.png")), want)
    np.save(tmp_path / "page.npy", rgb)
    np.testing.assert_array_equal(read_grey_page(str(tmp_path / "page.npy")), want)
    np.save(tmp_path / "grey.npy", want[..., None])
    np.testing.assert_array_equal(read_grey_page(str(tmp_path / "grey.npy")), want)
    np.save(tmp_path / "bad.npy", np.zeros((3, 4, 2)))
    with pytest.raises(ValueError, match="greyscale or RGB"):
        read_grey_page(str(tmp_path / "bad.npy"))
