"""Port's serving pipeline vs the JAX package's ``OcrPipeline`` on the same
random weights and pages: detection probabilities and masks, word quads,
line grouping, greedy decode, the PIL-free resize, and the texts of
``run_batch`` and ``__call__``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ocrs_models_tpu.data import SyntheticDetection
from ocrs_models_tpu.data.augment import resize as pil_resize
from ocrs_models_tpu.geometry import expand_quads as jax_expand_quads
from ocrs_models_tpu.geometry import extract_cc_quads as jax_extract_cc_quads
from ocrs_models_tpu.geometry.components import connected_components as jax_cc
from ocrs_models_tpu.models import DetectionModel as JaxDetection
from ocrs_models_tpu.models import RecognitionModel as JaxRecognition
from ocrs_models_tpu.parallel import create_mesh as jax_create_mesh
from ocrs_models_tpu.pipeline import OcrPipeline as JaxPipeline
from ocrs_models_tpu.pipeline import group_words_into_lines as jax_group
from ocrs_models_tpu.utils.text import ctc_greedy_decode_batch as jax_decode
from ocrs_models_torch.data.resize import resize
from ocrs_models_torch.geometry import expand_quads, extract_cc_quads, native
from ocrs_models_torch.geometry.components import connected_components_numpy
from ocrs_models_torch.geometry.polygon import min_area_rect_numpy, offset_ring_numpy
from ocrs_models_torch.parallel import Mesh, create_mesh
from ocrs_models_torch.pipeline import OcrPipeline, group_words_into_lines
from ocrs_models_torch.utils.text import ctc_greedy_decode_batch
from torch_port_common import random_variables, use_geometry_backend

DET_SIZE = (128, 96)


@pytest.fixture(scope="module")
def setup():
    det_vars = random_variables(JaxDetection(), (1, 64, 64, 1), seed=2)
    rec_vars = random_variables(JaxRecognition(n_classes=97), (1, 64, 32, 1), seed=3)
    jax_pipe = JaxPipeline(det_vars, rec_vars, det_size=DET_SIZE)
    port = OcrPipeline.from_jax_variables(det_vars, rec_vars, det_size=DET_SIZE, device="cpu")
    images = [
        SyntheticDetection(size=1, page_size=(256, 192), seed=s)[0]["image"] for s in (0, 1)
    ]
    images.append(SyntheticDetection(size=1, page_size=(192, 256), seed=2)[0]["image"])
    return jax_pipe, port, images


def _det_inputs(images):
    return np.stack([pil_resize(img, DET_SIZE) for img in images])


def test_detection_probabilities_and_masks_match(setup):
    jax_pipe, port, images = setup
    x = _det_inputs(images)
    want = np.asarray(jax_pipe._det_fwd(jax_pipe._det_vars, jnp.asarray(x)))[..., 0]
    with torch.no_grad():
        got = port.det_model(torch.from_numpy(x[..., 0])[:, None])[:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    packed_want = np.asarray(jax_pipe._det_mask(jax_pipe._det_vars, jnp.asarray(x)))
    np.testing.assert_array_equal(port._det_masks(x), packed_want)


@pytest.fixture(params=["numpy", "native"])
def geometry_backend(request, monkeypatch):
    """Both packages' geometry on one backend: their numpy versions, or
    their C++ cores. The two round some quad coordinates one ulp apart, so
    a comparison across backends is not a comparison of the ports."""
    use_geometry_backend(request.param, monkeypatch)
    return request.param


def test_quads_identical_given_mask(setup, geometry_backend):
    jax_pipe, _, images = setup
    packed = np.asarray(jax_pipe._det_mask(jax_pipe._det_vars, jnp.asarray(_det_inputs(images))))
    n_quads = 0
    for page in packed:
        mask = np.unpackbits(page, axis=-1)[:, : DET_SIZE[1]]
        want = jax_expand_quads(jax_extract_cc_quads(mask), dist=3.0)
        got = expand_quads(extract_cc_quads(mask), dist=3.0)
        np.testing.assert_array_equal(got, want)
        n_quads += len(got)
        labels, n = jax_cc(mask)
        labels_np, n_np = connected_components_numpy(mask > 0)
        assert n_np == n
        np.testing.assert_array_equal(labels_np, labels)
    assert n_quads > 0


def test_numpy_geometry_matches_native():
    if not native.available():
        pytest.skip("no C++ toolchain: only the numpy versions run here")
    rng = np.random.default_rng(0)
    for _ in range(20):
        pts = rng.uniform(0, 50, (12, 2))
        np.testing.assert_allclose(
            min_area_rect_numpy(pts), native.min_area_rect(pts), rtol=0, atol=1e-9
        )
        quad = native.min_area_rect(pts)
        np.testing.assert_allclose(
            offset_ring_numpy(quad, -3.0), native.polygon_offset(quad, -3.0), rtol=0, atol=1e-9
        )


def _assert_pages_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.text == b.text
        np.testing.assert_allclose(a.box, b.box, rtol=1e-6, atol=1e-6)
        assert len(a.words) == len(b.words)
        for qa, qb in zip(a.words, b.words):
            np.testing.assert_allclose(qa, qb, rtol=1e-6, atol=1e-6)


def test_run_batch_matches_jax(setup):
    jax_pipe, port, images = setup
    want = jax_pipe.run_batch(images, det_batch=2, rec_batch=4)
    got = port.run_batch(images, det_batch=2, rec_batch=4)
    assert len(got) == len(want) == 3
    assert sum(len(page) for page in got) > 0
    assert any(line.text for page in got for line in page)
    for g, w in zip(got, want):
        _assert_pages_equal(g, w)
    assert port.run_batch([]) == []


def test_call_matches_jax(setup):
    jax_pipe, port, images = setup
    _assert_pages_equal(port(images[2]), jax_pipe(images[2]))


@pytest.fixture
def two_torch_threads():
    """XLA's CPU threads and torch's contend in one process (the port's
    CPU forwards run 20x slower beside JAX at torch's default thread
    count); two threads for the test's duration."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_run_batch_on_a_mesh_matches_one_device_and_jax(setup, two_torch_threads):
    """Serving over a 2-device mesh (both on the CPU here: one replica of
    each model a device, every batch that divides split in two) against
    the single-device path and the JAX pipeline over a 2-device mesh, as
    ``tests/test_pipeline.py`` holds the JAX mesh pipeline."""
    jax_pipe, port, images = setup
    det_sd, rec_sd = port.det_model.state_dict(), port.rec_model.state_dict()
    meshed = OcrPipeline(det_sd, rec_sd, det_size=DET_SIZE, device="cpu",
                         mesh=create_mesh(devices=["cpu", "cpu"]))
    assert meshed._shards(4) == [(0, slice(0, 2)), (1, slice(2, 4))]
    assert meshed._shards(3) == [(0, slice(0, 3))]
    jax_meshed = JaxPipeline(jax_pipe._det_vars, jax_pipe._rec_vars, det_size=DET_SIZE,
                             mesh=jax_create_mesh(2))
    got = meshed.run_batch(images, det_batch=2, rec_batch=4)
    assert any(line.text for page in got for line in page)
    for want in (port.run_batch(images, det_batch=2, rec_batch=4),
                 jax_meshed.run_batch(images, det_batch=2, rec_batch=4)):
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _assert_pages_equal(g, w)
    boxes = [np.array([10.0, 10.0, 150.0, 40.0]), np.array([20.0, 50.0, 120.0, 80.0])]
    assert meshed.recognize_lines(images[0], boxes) == port.recognize_lines(images[0], boxes)


def test_recognize_lines_degenerate_box_gives_empty_text(setup):
    jax_pipe, port, images = setup
    boxes = [np.array([10.0, 10.0, 150.0, 40.0]), np.array([5.0, 5.0, 6.0, 30.0])]
    got = port.recognize_lines(images[0], boxes)
    assert got == jax_pipe.recognize_lines(images[0], boxes)
    assert got[1] == ""


@pytest.mark.parametrize(
    "src,dst",
    [((256, 192), (128, 96)), ((37, 200), (64, 400)), ((100, 80), (64, 50)),
     ((13, 7), (64, 10)), ((64, 900), (64, 800)), ((64, 64), (64, 64))],
)
def test_resize_matches_pil(src, dst):
    img = np.random.default_rng(sum(src)).uniform(-0.5, 0.5, (*src, 1)).astype(np.float32)
    want = np.asarray(
        Image.fromarray(img[..., 0], mode="F").resize((dst[1], dst[0]), Image.BILINEAR),
        np.float32,
    )[..., None]
    got = resize(img, dst)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_decode_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 4, (6, 17)).astype(np.int32)  # many repeats and blanks
    lens = rng.integers(0, 18, (6,)).astype(np.int32)
    want_ids, want_lens = jax.device_get(jax_decode(jnp.asarray(ids), jnp.asarray(lens)))
    got_ids, got_lens = ctc_greedy_decode_batch(
        torch.from_numpy(ids).long(), torch.from_numpy(lens).long()
    )
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_array_equal(got_lens.numpy(), want_lens)


def test_group_words_into_lines_matches_jax():
    rng = np.random.default_rng(4)
    tops = rng.choice([10.0, 40.0, 70.0], 15) + rng.uniform(-3, 3, 15)
    lefts = rng.uniform(0, 300, 15)
    quads = np.stack(
        [np.array([[x, y], [x + 30, y], [x + 30, y + 18], [x, y + 18]]) for x, y in zip(lefts, tops)]
    )
    want = jax_group(quads)
    got = group_words_into_lines(quads)
    assert len(got) == len(want) == 3
    for (gb, gm), (wb, wm) in zip(got, want):
        np.testing.assert_array_equal(gb, wb)
        assert [int(i) for i in gm] == [int(i) for i in wm]


@pytest.mark.parametrize("case", [
    pytest.param(({"use_layout_model": True}, ValueError, "layout_state_dict"), id="kwargs0"),
    pytest.param(({"mesh": Mesh((torch.device("cpu"),), 2, group=object())}, ValueError,
                  "process group"), id="kwargs1"),
])
def test_options_outside_the_slice_raise(case):
    # The layout model is served since it was ported, and then needs its
    # weights, as in the JAX package; a serving mesh is the devices of one
    # process (a process group's mesh trains).
    kwargs, error, match = case
    with pytest.raises(error, match=match):
        OcrPipeline(device="cpu", **kwargs)
