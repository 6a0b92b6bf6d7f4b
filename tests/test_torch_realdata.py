"""The port's real-data path on the CPU, against Pillow and the JAX
package: the image decoder, the HierText and DDI-100 readers, the
trainers on them and the dataset preview CLI.

Every case copies a committed toy root (``tests/data/torch_hiertext_toy``,
``tests/data/torch_ddi_toy``, written by
``tests/torch_fixtures/make_toy_roots.py``) into ``tmp_path`` first.

Tolerances, and why:

- the decoder: bit-equal to Pillow's ``convert("L")`` (libjpeg-turbo's
  integer IDCT, upsampling and colour tables), on every fixture, on a
  seeded hypothesis sweep of Pillow-written JPEGs and on the frame layouts
  Pillow does not write (``torch_fixtures/jpeg_writer.py``);
- dataset samples: equal, JSONL files byte-equal, crop caches at equal
  paths; samples through ``DetectionAugment`` within 1e-5, as in
  ``test_torch_detection_data.py`` (its bilinear resize matches PIL's to
  float32 rounding: read 3e-8);
- the trainers, one epoch from the JAX trainers' ``--export init.pt``:
  the tolerances of ``test_torch_train_rec.py`` (train loss 1e-4, train
  CER equal, validation loss 1e-3, validation CER within 0.05) and
  ``test_torch_detection_train.py`` (train and validation losses 1e-5):
  HierText on 2 pages without augmentation, where the two packages' pages
  are equal; DDI-100 on 3 augmented pages (read 9e-7 and 1.7e-7). An
  augmented page differs from the JAX package's by the resize's float32
  rounding (3e-8), and Adam's first step moves each parameter by about
  its gradient's sign times the learning rate, so where a gradient is
  near zero its sign, and the loss after the step, follow that rounding
  (on 2 augmented HierText pages the validation losses read 2.5e-5
  apart); the augmented samples themselves are held within 1e-5 above;
- the preview CLI: the same file names, pixels equal.
"""

import gzip
import hashlib
import io
import json
import os
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from ocrs_models_tpu.data import __main__ as jax_preview
from ocrs_models_tpu.data import ddi100 as jax_ddi
from ocrs_models_tpu.data import hiertext as jax_hiertext
from ocrs_models_tpu.data.augment import DetectionAugment as JaxDetectionAugment
from ocrs_models_tpu.data.augment import RecognitionAugment as JaxRecognitionAugment
from ocrs_models_tpu.training import train_detection as jax_train_detection
from ocrs_models_tpu.training import train_rec as jax_train_rec
from ocrs_models_torch.data import __main__ as preview
from ocrs_models_torch.data import ddi100, hiertext, imageio
from ocrs_models_torch.data.augment import DetectionAugment, RecognitionAugment
from ocrs_models_torch.models import DetectionModel
from ocrs_models_torch.training import eval_detection, train_detection, train_rec
from ocrs_models_torch.utils.render import write_png

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_fixtures.jpeg_writer import write_jpeg  # noqa: E402
from torch_fixtures.png_writer import write_png as png_bytes  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
HIERTEXT = DATA / "torch_hiertext_toy"
DDI = DATA / "torch_ddi_toy"
DIGESTS = json.loads((DATA / "torch_toy_digests.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """XLA's CPU threads and torch's contend in one process (the trainers
    run beside the JAX ones): two torch threads for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _copy(src: Path, dst: Path) -> str:
    shutil.copytree(src, dst)
    return str(dst)


def _pillow_grey(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("L"))


# ---------------------------------------------------------------- decoder


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_read_grey_equals_pillow_on_every_fixture(tmp_path, name):
    path = tmp_path / Path(name).name
    shutil.copy(DATA / name, path)
    got = imageio.read_grey(str(path))
    np.testing.assert_array_equal(got, _pillow_grey(path.read_bytes()))
    assert got.dtype == np.uint8 and list(got.shape) == DIGESTS[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS[name]["sha256"]


@settings(max_examples=80, deadline=None, derandomize=True, database=None)
@given(width=st.integers(1, 70), height=st.integers(1, 70),
       layout=st.sampled_from(["L", 0, 1, 2]), quality=st.integers(1, 100),
       progressive=st.booleans(), restart=st.sampled_from([0, 1, 2, 5]),
       optimize=st.booleans(), seed=st.integers(0, 2**16))
def test_decoder_sweep_matches_pillow(width, height, layout, quality, progressive, restart,
                                      optimize, seed):
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (height // 5 + 2, width // 5 + 2, 3), dtype=np.uint8)
    img = Image.fromarray(coarse).resize((width, height), Image.BILINEAR)
    noisy = np.clip(np.asarray(img, np.int32) + rng.integers(-30, 31, (height, width, 3)),
                    0, 255).astype(np.uint8)
    img = Image.fromarray(noisy)
    options = {"quality": quality, "progressive": progressive, "optimize": optimize}
    if layout == "L":
        img = img.convert("L")
    else:
        options["subsampling"] = layout
    if restart:
        options["restart_marker_blocks"] = restart
    buf = io.BytesIO()
    img.save(buf, "JPEG", **options)
    data = buf.getvalue()
    np.testing.assert_array_equal(imageio.decode_jpeg_grey(data), _pillow_grey(data))


LAYOUTS = {
    "4:4:0": ([(1, 2), (1, 1), (1, 1)], {}),
    "4:2:2 non-interleaved": ([(2, 1), (1, 1), (1, 1)], {"interleaved": False}),
    "4:2:0 non-interleaved, restarts": ([(2, 2), (1, 1), (1, 1)],
                                        {"interleaved": False, "restart_interval": 2}),
    "mixed 2x2 / 2x1 / 1x2": ([(2, 2), (2, 1), (1, 2)], {}),
    "chroma finer than luma": ([(1, 1), (2, 2), (1, 1)], {}),
    "greyscale 2x2": ([(2, 2)], {}),
    "SOF1, 16-bit tables": ([(2, 1), (1, 1), (1, 1)], {"sof": 0xC1, "qt16": True}),
    "Adobe transform 0 (RGB)": ([(1, 1)] * 3, {"marker": "adobe0"}),
    "Adobe transform 1 (YCbCr)": ([(2, 2), (1, 1), (1, 1)], {"marker": "adobe1"}),
    "ids R, G, B": ([(1, 1)] * 3, {"marker": None, "ids": [82, 71, 66]}),
    "no marker, ids 1, 2, 3": ([(2, 1), (1, 1), (1, 1)], {"marker": None}),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("size", [(1, 1), (2, 3), (17, 9), (33, 31)])
def test_decoder_layouts_pillow_does_not_write(layout, size):
    sampling, options = LAYOUTS[layout]
    rng = np.random.default_rng(len(layout) * 100 + size[0])
    planes = [rng.integers(0, 256, size[::-1]).astype(np.uint8) for _ in sampling]
    data = write_jpeg(planes, sampling, **options)
    np.testing.assert_array_equal(imageio.decode_jpeg_grey(data), _pillow_grey(data))


def _jpeg_bytes(mode="RGB", **options) -> bytes:
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 256, (24, 40, 4 if mode == "CMYK" else 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", **options)
    return buf.getvalue()


def _sof_offset(data: bytes) -> int:
    i = 2
    while data[i + 1] not in (0xC0, 0xC2):
        i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    return i


def _refused_files():
    data = _jpeg_bytes()
    sof = _sof_offset(data)
    with_marker = lambda m: data[:sof + 1] + bytes([m]) + data[sof + 2:]  # noqa: E731
    twelve = bytearray(data)
    twelve[sof + 4] = 12
    yield "arithmetic", with_marker(0xC9), "arithmetic"
    yield "lossless", with_marker(0xC3), "lossless"
    yield "12-bit", bytes(twelve), "12-bit"
    yield "truncated", data[: len(data) // 2], "truncated"
    yield "truncated progressive", _jpeg_bytes(progressive=True)[:-40], "truncated"
    yield "no EOI", data[:-2], "truncated"
    yield "not an image", b"GIF89a" + bytes(20), "not a JPEG or PNG"


@pytest.mark.parametrize("case,data,reason", list(_refused_files()),
                         ids=[c[0] for c in _refused_files()])
def test_decoder_refusals_name_the_file(tmp_path, case, data, reason):
    path = tmp_path / f"{case.replace(' ', '_')}.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=reason) as info:
        imageio.read_grey(str(path))
    assert str(path) in str(info.value)
    if case.startswith(("truncated", "no EOI")):  # Pillow refuses these too
        with pytest.raises(OSError, match="truncated"):
            _pillow_grey(data)
    if case == "12-bit":  # ... and this (it reads 8-bit samples only)
        with pytest.raises(OSError, match="cannot identify"):
            _pillow_grey(data)


def test_read_grey_without_the_codec_names_the_file(tmp_path, monkeypatch):
    path = tmp_path / "page.jpg"
    path.write_bytes(_jpeg_bytes())

    def no_compiler():
        raise RuntimeError("building imagecodec.cpp with g++ failed: no g++")

    monkeypatch.setattr(imageio, "get_lib", no_compiler)
    with pytest.raises(RuntimeError, match="not available") as info:
        imageio.read_grey(str(path))
    assert str(path) in str(info.value)


@pytest.mark.parametrize("mode", ["P", "LA", "RGBA", "P-short-palette", "1", "L;4"])
def test_png_colour_types_match_pillow(tmp_path, mode):
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (19, 23, 3), dtype=np.uint8)
    path = tmp_path / "page.png"
    if mode == "P":
        Image.fromarray(rgb).quantize(40).save(path)
    elif mode == "P-short-palette":  # indices past the palette read as black
        img = Image.fromarray(rng.integers(0, 12, (19, 23), dtype=np.uint8), "P")
        img.putpalette(rng.integers(0, 256, 3 * 8, dtype=np.uint8).tobytes())
        img.save(path)
    elif mode == "1":
        Image.fromarray(rgb[..., 0] > 128).save(path)
    elif mode == "L;4":  # 4-bit greyscale, packed two to a byte
        _png_of(path, rng.integers(0, 16, (19, 23), dtype=np.uint8), depth=4)
    else:
        alpha = rng.integers(0, 256, (19, 23, 1), dtype=np.uint8)
        arr = np.concatenate([rgb[..., :1] if mode == "LA" else rgb, alpha], axis=-1)
        Image.fromarray(arr, mode).save(path)
    np.testing.assert_array_equal(imageio.read_grey(str(path)), _pillow_grey(path.read_bytes()))


def _png_of(path, samples, depth):
    """A greyscale PNG of ``depth``-bit ``samples``, rows filtered with
    Paeth (Pillow writes no 2- or 4-bit greyscale)."""
    import struct
    import zlib

    h, w = samples.shape
    per = 8 // depth
    padded = np.pad(samples, ((0, 0), (0, -w % per))).reshape(h, -1, per)
    packed = np.zeros(padded.shape[:2], np.int64)
    for i in range(per):
        packed |= padded[..., i].astype(np.int64) << (8 - depth * (i + 1))
    rows = b"".join(b"\x00" + bytes(row.astype(np.uint8)) for row in packed)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0,
                                                                     0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


CMYK_LAYOUTS = {
    "CMYK, no marker": ([(1, 1)] * 4, {"marker": None}),
    "CMYK, Adobe 0": ([(1, 1)] * 4, {"marker": "adobe0"}),
    "CMYK, JFIF (read as no marker)": ([(2, 2), (1, 1), (1, 1), (1, 1)], {"marker": "jfif"}),
    "YCCK, Adobe 2, 4:2:0": ([(2, 2), (1, 1), (1, 1), (2, 2)], {"marker": "adobe2"}),
    "YCCK, Adobe 1, 4:2:2": ([(2, 1), (1, 1), (1, 1), (2, 1)], {"marker": "adobe1"}),
    "YCCK, Adobe 2, one scan a component, restarts": (
        [(1, 2), (1, 1), (1, 1), (1, 2)],
        {"marker": "adobe2", "interleaved": False, "restart_interval": 2}),
}


@pytest.mark.parametrize("layout", sorted(CMYK_LAYOUTS))
@pytest.mark.parametrize("size", [(1, 1), (2, 3), (17, 9), (33, 31)])
def test_decoder_reads_cmyk_and_ycck_as_pillow(layout, size):
    # Four components: libjpeg's YCCK->CMYK where an Adobe marker says a
    # transform other than 0, Pillow's inversion ("CMYK;I") and its
    # cmyk2rgb and rgb2l; planes of any values, so clamps are reached.
    sampling, options = CMYK_LAYOUTS[layout]
    rng = np.random.default_rng(len(layout) * 100 + size[0])
    planes = [rng.integers(0, 256, size[::-1]).astype(np.uint8) for _ in sampling]
    data = write_jpeg(planes, sampling, **options)
    np.testing.assert_array_equal(imageio.decode_jpeg_grey(data), _pillow_grey(data))


@pytest.mark.parametrize("options", [{"quality": 95}, {"quality": 60, "progressive": True},
                                     {"quality": 85, "restart_marker_blocks": 2},
                                     {"quality": 75, "optimize": True}],
                         ids=["q95", "progressive", "restarts", "optimized"])
def test_decoder_reads_pillow_cmyk_jpegs(options):
    # Pillow writes CMYK inverted with an Adobe marker of transform 0.
    data = _jpeg_bytes("CMYK", **options)
    with Image.open(io.BytesIO(data)) as img:
        assert img.mode == "CMYK" and img.info["adobe_transform"] == 0
    np.testing.assert_array_equal(imageio.decode_jpeg_grey(data), _pillow_grey(data))


PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("color,depth", [(c, d) for c, ds in PNG_DEPTHS.items() for d in ds])
def test_png_depths_and_interlacing_match_pillow(tmp_path, color, depth, interlace):
    # Every bit depth each colour type allows, without and with Adam7
    # (passes with no pixel at the small sizes), each row behind another
    # filter (png_writer.py); 16-bit samples over the whole range, so that
    # grey clips and the other types keep their high bytes.
    rng = np.random.default_rng(10 * color + depth)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    for i, (h, w) in enumerate([(1, 1), (3, 5), (13, 11), (9, 17)]):
        samples = rng.integers(0, 2**depth, (h, w, channels))
        palette = rng.integers(0, 256, (2**depth - 1, 3)) if color == 3 else None
        data = png_bytes(samples[..., 0] if channels == 1 else samples, depth, color,
                         interlace=interlace, palette=palette, first_filter=i)
        path = tmp_path / f"page{i}.png"
        path.write_bytes(data)
        np.testing.assert_array_equal(imageio.read_grey(str(path)), _pillow_grey(data))


def test_png_16_bit_greyscale_clips_as_pillow():
    # Pillow opens 16-bit greyscale as "I;16", and its convert("L") reads
    # every value above 255 as 255 (the JAX package trains on that).
    data = png_bytes(np.asarray([[0, 100, 255, 256, 1000, 65535]]), 16, 0)
    want = np.asarray([[0, 100, 255, 255, 255, 255]], np.uint8)
    np.testing.assert_array_equal(_pillow_grey(data), want)
    np.testing.assert_array_equal(imageio.png_to_grey(imageio.decode_png(data)), want)


# --------------------------------------------------------------- datasets


def test_hiertext_samples_jsonl_and_cache_equal_the_jax_package(tmp_path, capsys):
    port_root = _copy(HIERTEXT, tmp_path / "port")
    jax_root = _copy(HIERTEXT, tmp_path / "jax")
    for train in (True, False):
        want_ds = jax_hiertext.HierTextRecognition(jax_root, train=train)
        jax_log = capsys.readouterr().out
        got_ds = hiertext.HierTextRecognition(port_root, train=train)
        assert capsys.readouterr().out == jax_log.replace(jax_root, port_root)
        assert len(got_ds) == len(want_ds) > 0
        for i in range(len(want_ds)):
            got, want = got_ds[i], want_ds[i]
            assert got["image_id"] == want["image_id"]
            np.testing.assert_array_equal(got["text"], want["text"])
            assert got["image"].dtype == np.float32 and got["image"].shape[0] == 64
            np.testing.assert_array_equal(got["image"], want["image"])
        want_det = jax_hiertext.HierTextDetection(jax_root, train=train)
        jax_log = capsys.readouterr().out
        got_det = hiertext.HierTextDetection(port_root, train=train)
        assert capsys.readouterr().out == jax_log
        assert len(got_det) == len(want_det) > 0
        for i in range(len(want_det)):
            got, want = got_det[i], want_det[i]
            assert got["path"] == want["path"].replace(jax_root, port_root)
            np.testing.assert_array_equal(got["image"], want["image"])
            np.testing.assert_array_equal(got["mask"], want["mask"])
    for name in ("train.jsonl", "validation.jsonl", "train-lines.jsonl",
                 "validation-lines.jsonl"):
        assert (Path(port_root) / "gt" / name).read_bytes() == \
            (Path(jax_root) / "gt" / name).read_bytes(), name

    def cache(root):
        return sorted(str(p.relative_to(root)) for p in Path(root).glob("*-lines-cache/*/*"))

    assert cache(port_root) == cache(jax_root) and len(cache(port_root)) > 10
    assert not list(Path(port_root).rglob("*.tmp*"))


def test_hiertext_caches_cross_read(tmp_path):
    """Each package reads the crops the other cached: the samples equal
    those from a cache of its own."""
    own = _copy(HIERTEXT, tmp_path / "own")
    shared = _copy(HIERTEXT, tmp_path / "shared")
    jax_own = _copy(HIERTEXT, tmp_path / "jax_own")
    jax_written = [jax_hiertext.HierTextRecognition(shared)[i]["image"] for i in range(6)]
    port_ds = hiertext.HierTextRecognition(shared)  # reads the JAX package's PNGs
    assert [p.stat().st_mtime_ns for p in sorted(Path(shared).glob("*-lines-cache/*/*"))]
    for i in range(6):
        np.testing.assert_array_equal(port_ds[i]["image"],
                                      hiertext.HierTextRecognition(own)[i]["image"])
    port_written = _copy(Path(own), tmp_path / "port_written")  # the port's cache
    for i in range(6):
        np.testing.assert_array_equal(jax_hiertext.HierTextRecognition(port_written)[i]["image"],
                                      jax_hiertext.HierTextRecognition(jax_own)[i]["image"])
        np.testing.assert_array_equal(jax_written[i], port_ds[i]["image"])


def test_hiertext_augmented_samples_match_the_jax_package(tmp_path):
    port_root = _copy(HIERTEXT, tmp_path / "port")
    jax_root = _copy(HIERTEXT, tmp_path / "jax")
    got_ds = hiertext.HierTextRecognition(port_root, transform=RecognitionAugment(seed=3))
    want_ds = jax_hiertext.HierTextRecognition(jax_root, transform=JaxRecognitionAugment(seed=3))
    for i in range(len(want_ds)):
        np.testing.assert_array_equal(got_ds[i]["image"], want_ds[i]["image"])
    got_det = hiertext.HierTextDetection(port_root, transform=DetectionAugment((192, 144), seed=7))
    want_det = jax_hiertext.HierTextDetection(jax_root,
                                              transform=JaxDetectionAugment((192, 144), seed=7))
    for i in range(len(want_det)):
        got, want = got_det[i], want_det[i]
        assert got["image"].shape == want["image"].shape == (192, 144, 1)
        np.testing.assert_allclose(got["image"], want["image"], atol=1e-5)
        np.testing.assert_allclose(got["mask"], want["mask"], atol=1e-5)


def test_ddi100_samples_equal_the_jax_package(tmp_path):
    root = _copy(DDI, tmp_path / "ddi")
    for train, n in ((True, 9), (False, 2)):
        got_ds, want_ds = ddi100.DDI100(root, train=train), jax_ddi.DDI100(root, train=train)
        assert len(got_ds) == len(want_ds) == n
        for i in range(n):
            got, want = got_ds[i], want_ds[i]
            assert got["path"] == want["path"]
            np.testing.assert_array_equal(got["image"], want["image"])
            np.testing.assert_array_equal(got["mask"], want["mask"])
            assert got["mask"].sum() > 0
    got_ds = ddi100.DDI100(root, transform=DetectionAugment((192, 144), seed=2))
    want_ds = jax_ddi.DDI100(root, transform=JaxDetectionAugment((192, 144), seed=2))
    for i in range(len(want_ds)):
        np.testing.assert_allclose(got_ds[i]["image"], want_ds[i]["image"], atol=1e-5)
        np.testing.assert_allclose(got_ds[i]["mask"], want_ds[i]["mask"], atol=1e-5)
    assert len(ddi100.DDI100(root, max_images=4)) == 3  # 90% of the first 4 names


def test_ddi100_unpickler_admits_only_numpy_arrays(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    with pytest.raises(pickle.UnpicklingError, match="Disallowed class posix.system"):
        ddi100.RestrictedUnpickler(io.BytesIO(pickle.dumps(Evil()))).load()
    words = [{"box": np.array([[1, 2], [3, 4]], np.int64), "text": "a"}]
    got = ddi100.RestrictedUnpickler(io.BytesIO(pickle.dumps(words))).load()
    np.testing.assert_array_equal(got[0]["box"], words[0]["box"])
    with pytest.raises(pickle.UnpicklingError):  # a numpy scalar is no array
        ddi100.RestrictedUnpickler(io.BytesIO(pickle.dumps(np.float32(1)))).load()


@pytest.mark.parametrize("reader", ["detection", "recognition", "ddi"])
def test_missing_roots_name_the_path(tmp_path, reader):
    make = {"detection": hiertext.HierTextDetection,
            "recognition": hiertext.HierTextRecognition, "ddi": ddi100.DDI100}[reader]
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "nope")):
        make(str(tmp_path / "nope"))
    if reader != "ddi":  # pages there, ground truth missing
        root = _copy(HIERTEXT, tmp_path / "root")
        (Path(root) / "gt" / "train.jsonl.gz").unlink()
        with pytest.raises(FileNotFoundError, match="train.jsonl.gz"):
            make(root)


# --------------------------------------------------------------- trainers


@pytest.fixture(scope="module")
def jax_rec_init(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("jax_rec_init")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(run_dir)
        jax_train_rec.main(["synthetic", "-", "--export", "init.pt", "--no-bf16"])
    return run_dir / "init.pt"


DET_CLI = ["--no-bf16", "--mask-height", "192", "--num-devices", "1"]


@pytest.fixture(scope="module")
def jax_det_init(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("jax_det_init")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(run_dir)
        jax_train_detection.main(["synthetic", "-", "--export", "init.pt", *DET_CLI])
    return run_dir / "init.pt"


def _epoch_record(run_dir: Path, name: str) -> dict:
    lines = (run_dir / f"{name}-metrics.jsonl").read_text().splitlines()
    (record,) = [json.loads(ln) for ln in lines if '"epoch"' in ln]
    return record


def _run_both(tmp_path, monkeypatch, src, jax_main, port_main, args, init):
    for name in ("jax", "port"):
        _copy(src, tmp_path / f"{name}_root")
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jax_main([args[0], str(tmp_path / "jax_root"), *args[1:]])
    monkeypatch.chdir(tmp_path / "port")
    state = port_main([args[0], str(tmp_path / "port_root"), *args[1:], "--checkpoint",
                       str(init)], device="cpu")
    assert state.step == 1
    return tmp_path / "jax", tmp_path / "port"


def test_train_rec_hiertext_matches_jax(jax_rec_init, tmp_path, monkeypatch):
    jax_dir, port_dir = _run_both(
        tmp_path, monkeypatch, HIERTEXT, jax_train_rec.main, train_rec.main,
        ["hiertext", "--max-images", "8", "--batch-size", "8", "--max-epochs", "1", "--no-bf16",
         "--num-devices", "1"], jax_rec_init)
    want = _epoch_record(jax_dir, "text-recognition")
    got = _epoch_record(port_dir, "text-recognition")
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-4)
    assert got["train_accuracy"] == want["train_accuracy"]
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-3)
    assert abs(got["val_accuracy"]["char_error_rate"]
               - want["val_accuracy"]["char_error_rate"]) <= 0.05
    assert (port_dir / "text-rec-checkpoint.pt").exists()


@pytest.mark.parametrize("dataset,src,extra", [
    ("hiertext", HIERTEXT, ["--max-images", "2", "--batch-size", "2", "--no-augment"]),
    ("ddi", DDI, ["--max-images", "4", "--batch-size", "3"]),
])
def test_train_detection_real_data_matches_jax(jax_det_init, tmp_path, monkeypatch, dataset, src,
                                               extra):
    jax_dir, port_dir = _run_both(
        tmp_path, monkeypatch, src, jax_train_detection.main, train_detection.main,
        [dataset, *extra, "--max-epochs", "1", *DET_CLI], jax_det_init)
    want = _epoch_record(jax_dir, "text-detection")
    got = _epoch_record(port_dir, "text-detection")
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    assert got["val_metrics"].keys() == want["val_metrics"].keys()


def test_trainers_on_two_ranks_read_the_toy_roots(tmp_path, monkeypatch):
    """``--num-devices 2`` (two ``gloo`` ranks on the CPU): the parent
    converts the ground truth once, both ranks fill one crop cache (their
    temporary names are per process), rank 0 writes the records."""
    ht = _copy(HIERTEXT, tmp_path / "ht")
    ddi = _copy(DDI, tmp_path / "ddi")
    monkeypatch.chdir(tmp_path)
    assert train_rec.main(["hiertext", ht, "--num-devices", "2", "--batch-size", "8",
                           "--max-images", "8", "--max-epochs", "1", "--no-bf16"],
                          device="cpu") is None
    assert train_detection.main(["ddi", ddi, "--num-devices", "2", "--batch-size", "2",
                                 "--max-images", "4", "--max-epochs", "1", *DET_CLI[:3]],
                                device="cpu") is None
    for name in ("text-recognition", "text-detection"):
        record = _epoch_record(tmp_path, name)
        assert np.isfinite([record["train_loss"], record["val_loss"]]).all(), name
    cache = list(Path(ht).glob("*-lines-cache/*/*"))
    assert len(cache) == 8 + 10 and all(p.suffix == ".png" for p in cache)


@pytest.mark.parametrize("main", [train_rec.main, train_detection.main], ids=["rec", "det"])
@pytest.mark.parametrize("dataset", ["hiertext", "ddi"])
def test_trainers_refuse_a_missing_root(tmp_path, monkeypatch, main, dataset):
    if main is train_rec.main and dataset == "ddi":
        with pytest.raises(SystemExit):  # argparse: train_rec has no ddi
            main([dataset, str(tmp_path)], device="cpu")
        return
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "nope")):
        main([dataset, str(tmp_path / "nope"), "--max-epochs", "1", "--num-devices", "2"],
             device="cpu")
    assert list(tmp_path.iterdir()) == []


def test_eval_detection_reads_a_jpeg_page(tmp_path, capsys):
    """``eval_detection`` on a JPEG page writes what it writes for the PNG
    of Pillow's decode of that page."""
    page = HIERTEXT / "train" / "t4.jpg"
    shutil.copy(page, tmp_path / "page.jpg")
    Image.open(page).convert("L").save(tmp_path / "page.png")
    torch.manual_seed(0)
    torch.save({"epoch": 0, "model_state": DetectionModel().state_dict()}, tmp_path / "det.pt")
    for fmt in ("jpg", "png"):
        eval_detection.main([str(tmp_path / "det.pt"), str(tmp_path / f"page.{fmt}"),
                             str(tmp_path / fmt)], device="cpu")
    outs = capsys.readouterr().out.splitlines()
    assert outs[0] == outs[1] and outs[0].startswith("Found ")
    for part in ("input", "text-probs", "text-regions", "text-words"):
        assert (tmp_path / f"jpg-{part}.png").read_bytes() == \
            (tmp_path / f"png-{part}.png").read_bytes(), part


# ------------------------------------------------------------ preview CLI


@pytest.mark.parametrize("kind,src", [("hiertext", HIERTEXT), ("hiertext-rec", HIERTEXT),
                                      ("ddi", DDI), ("synthetic-rec", None),
                                      ("synthetic-layout", None)])
def test_preview_cli_matches_jax(tmp_path, capsys, kind, src):
    roots = {name: _copy(src, tmp_path / f"{name}_root") if src else "-"
             for name in ("jax", "port")}
    jax_preview.main([kind, roots["jax"], str(tmp_path / "jax"), "--max-images", "4"])
    preview.main([kind, roots["port"], str(tmp_path / "port"), "--max-images", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == f"Wrote previews to {tmp_path / 'port'}"
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    # ddi: the train split of the first 4 pages is 3
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == (3 if kind == "ddi" else 4)
    for name in names:
        with Image.open(tmp_path / "port" / name) as got, \
                Image.open(tmp_path / "jax" / name) as want:
            assert got.mode == want.mode and got.size == want.size, name
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)


def test_write_png_crops_read_back(tmp_path):
    """The crop cache's writer and reader round-trip greyscale crops of
    every size a line can give, one pixel wide or tall included."""
    rng = np.random.default_rng(4)
    for shape in ((1, 1), (1, 17), (13, 1), (29, 311)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        write_png(str(tmp_path / "c.png"), img)
        np.testing.assert_array_equal(imageio.read_grey(str(tmp_path / "c.png")), img)
        with Image.open(tmp_path / "c.png") as written:
            np.testing.assert_array_equal(np.asarray(written), img)


def test_toy_roots_are_what_the_generator_writes():
    """The committed ground truth holds every filter's failure (so the
    line filters are exercised) and is plain JSON inside gzip; the digests
    cover the toy roots, the 2 MP page and the decode-format fixtures."""
    with gzip.open(HIERTEXT / "gt" / "train.jsonl.gz") as f:
        annotations = json.load(f)["annotations"]
    lines = [ln for a in annotations for p in a["paragraphs"] for ln in p["lines"]]
    assert any(not ln["legible"] for ln in lines) and any(ln["vertical"] for ln in lines)
    assert any(ln["handwritten"] for ln in lines)
    assert {n.split("/")[0] for n in DIGESTS} == {"torch_hiertext_toy", "torch_ddi_toy",
                                                  "torch_decode_page.jpg",
                                                  "torch_decode_formats"}
