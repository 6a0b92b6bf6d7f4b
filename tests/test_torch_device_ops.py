"""The port's last modules against the JAX package on the CPU: connected
components and component bounds on the device, the batched preprocessing,
CTC prefix beam search, ``Config``/``MeshConfig`` and the profiler trace.

Inputs come from numpy seeds. Labels, boxes and strings are compared for
equality; the preprocessing within 1e-5 (resize, line crops) and 1e-6
(normalisation, photometric jitter on JAX's own draws). The port's
layout is NCHW where JAX's is NHWC.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ocrs_models_tpu.config as jax_config
import ocrs_models_tpu.data.device_pipeline as jax_pre
import ocrs_models_tpu.geometry.device as jax_geo
from ocrs_models_tpu.utils.profiling import Throughput as JaxThroughput
from ocrs_models_tpu.utils.text import ctc_beam_search_decode as jax_beam
from ocrs_models_torch import config
from ocrs_models_torch.data import device_pipeline as pre
from ocrs_models_torch.geometry import connected_components
from ocrs_models_torch.geometry.device import (
    component_bounds_device,
    connected_components_device,
)
from ocrs_models_torch.utils.profiling import Throughput, trace
from ocrs_models_torch.utils.text import ctc_beam_search_decode


def _nchw(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.numpy().transpose(0, 2, 3, 1)


# ------------------------------------------------- components and bounds

# (H, W, foreground share, seed): random masks from sparse specks to one
# winding blob (the 64x96 case at 0.55 takes 182 propagation steps in JAX).
MASKS = [(40, 60, 0.6, 0), (64, 96, 0.55, 1), (17, 23, 0.5, 2), (64, 96, 0.3, 3)]


def _masks(h, w, share, seed, n=3):
    return (np.random.default_rng(seed).uniform(size=(n, h, w)) < share).astype(np.uint8)


@pytest.mark.parametrize("case", MASKS, ids=lambda c: f"{c[0]}x{c[1]}-{c[2]}")
def test_connected_components_equal_jax_labels_and_bounds(case):
    masks = _masks(*case)
    want = np.asarray(jax_geo.connected_components_device(jnp.asarray(masks)))
    got = connected_components_device(masks, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    counts = [len(np.unique(m[m > 0])) for m in want]
    for i, mask in enumerate(masks):  # the host core's partition, bijectively
        host, n = connected_components(mask)
        pairs = np.unique(np.stack([want[i][mask > 0], host[mask > 0]]), axis=1)
        assert pairs.shape[1] == n == counts[i]
    # K=1 and 4 overflow (slot K-1 then holds the largest label's box); 64
    # holds every component but of the sparse 64x96 masks.
    for k in (1, 4, 64):
        jb, jv = jax_geo.component_bounds_device(jnp.asarray(want), k)
        boxes, valid = component_bounds_device(got, k, device="cpu")
        assert boxes.dtype == torch.int32 and boxes.shape == (len(masks), k, 4)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(boxes.numpy(), np.asarray(jb))
    assert max(counts) > 4


def test_component_bounds_of_two_boxes_and_of_an_empty_mask():
    mask = np.zeros((2, 20, 30), np.uint8)
    mask[0, 2:6, 3:10] = 1
    mask[0, 10:15, 20:28] = 1
    labels = connected_components_device(mask, device="cpu")
    assert int(labels[1].max()) == 0
    boxes, valid = component_bounds_device(labels, max_components=3, device="cpu")
    np.testing.assert_array_equal(valid.numpy(), [[True, True, False], [False] * 3])
    np.testing.assert_array_equal(boxes[0].numpy(), [[3, 2, 9, 5], [20, 10, 27, 14], [0] * 4])
    assert not boxes[1].any()


def test_device_components_refuse_what_they_cannot_label():
    with pytest.raises(ValueError, match="2\\^24"):  # float32 labels would round
        connected_components_device(torch.zeros((1, 4097, 4096), dtype=torch.bool),
                                    device="cpu")
    with pytest.raises(ValueError, match="outside"):
        component_bounds_device(torch.full((1, 4, 4), 17, dtype=torch.int32), 2, device="cpu")
    with pytest.raises(ValueError, match="max_components"):
        component_bounds_device(torch.zeros((1, 4, 4), dtype=torch.int32), 0, device="cpu")


# ------------------------------------------------------------ preprocessing

# Two downscales, where jax.image.resize antialiases, an upscale, and three
# channels.
RESIZES = [(150, 600, 1, 64, 256), (100, 30, 1, 64, 19), (37, 411, 1, 64, 710),
           (40, 50, 3, 20, 30)]


@pytest.mark.parametrize("case", RESIZES, ids=lambda c: "{}x{}x{}-{}x{}".format(*c))
def test_batch_resize_matches_jax(case):
    h, w, c, out_h, out_w = case
    x = np.random.default_rng(h * w).uniform(-0.5, 0.5, (2, h, w, c)).astype(np.float32)
    want = np.asarray(jax_pre.batch_resize(jnp.asarray(x), out_h, out_w))
    got = pre.batch_resize(_nchw(x), out_h, out_w, device="cpu")
    assert got.shape == (2, c, out_h, out_w) and got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-5)


def test_normalize_uint8_matches_jax():
    x = np.random.default_rng(0).integers(0, 256, (3, 20, 30, 1), dtype=np.uint8)
    x[0, 0, :2, 0] = (0, 255)
    want = np.asarray(jax_pre.normalize_uint8(jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(pre.normalize_uint8(_nchw(x), device="cpu")), want,
                               rtol=0, atol=1e-6)


def test_photometric_matches_jax_on_its_draws():
    # torch cannot reproduce jax.random's stream, so JAX's draws are made
    # here as photometric_augment makes them and fed to the port.
    n, strength = 16, 0.1
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (n, 8, 8, 1)).astype(np.float32)
    key = jax.random.key(1)
    want = np.asarray(jax_pre.photometric_augment(jnp.asarray(x), key, strength))
    k_apply, k_b, k_c = jax.random.split(key, 3)
    shape = (n, 1, 1, 1)
    apply = jax.random.uniform(k_apply, shape) < 0.5
    b = jax.random.uniform(k_b, shape, minval=1 - strength, maxval=1 + strength)
    c = jax.random.uniform(k_c, shape, minval=1 - strength, maxval=1 + strength)
    draws = [torch.from_numpy(np.array(v)) for v in (apply, b, c)]
    got = pre._photometric(torch.from_numpy(_nchw(x)), *draws)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-6)


def test_photometric_augment_draws_from_its_generator():
    x = torch.from_numpy(np.random.default_rng(0).uniform(-0.5, 0.5, (16, 1, 8, 8))
                         .astype(np.float32))
    y = pre.photometric_augment(x, torch.Generator().manual_seed(1), device="cpu")
    again = pre.photometric_augment(x, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(y, again)
    assert y.min() >= -0.5 and y.max() <= 0.5
    changed = [not torch.allclose(y[i], x[i]) for i in range(16)]
    assert any(changed) and not all(changed)  # p=0.5 a sample


# (H, W): a width clamped to min_w, 22.5 rounded half to even (22, where
# int(x + 0.5) gives 23), a downscale, and a width clamped to max_w.
CROPS = [(128, 15), (128, 45), (96, 700), (20, 300)]


@pytest.mark.parametrize("case", CROPS, ids=lambda c: f"{c[0]}x{c[1]}")
def test_prepare_line_crops_matches_jax(case):
    h, w = case
    x = np.random.default_rng(w).integers(0, 256, (2, h, w, 1), dtype=np.uint8)
    want = np.asarray(jax_pre.prepare_line_crops(jnp.asarray(x), 64, 800))
    got = pre.prepare_line_crops(_nchw(x), 64, 800, device="cpu")
    assert got.shape == (2, 1, 64, want.shape[2])
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-5)


# ------------------------------------------------------------- beam search

def _lp(rows):
    x = np.array(rows, dtype=np.float64)
    return np.log(x / x.sum(axis=1, keepdims=True))


# The JAX package's own cases (tests/test_text.py): (probabilities, alphabet,
# beam width, string).
BEAM_CASES = {
    "peaked": ([[0.01, 0.98, 0.01], [0.98, 0.01, 0.01], [0.01, 0.01, 0.98]], "ab", 10, "ab"),
    "split_mass": ([[0.5, 0.5], [0.5, 0.5]], "a", 4, "a"),
    "blank_only": ([[0.99, 0.01], [0.99, 0.01]], "a", 10, ""),
    "repeat_needs_blank": ([[0.05, 0.95], [0.9, 0.1], [0.05, 0.95]], "a", 10, "aa"),
}


@pytest.mark.parametrize("name", BEAM_CASES)
def test_beam_search_on_the_jax_cases(name):
    rows, alphabet, beam, want = BEAM_CASES[name]
    lp = _lp(rows)
    assert jax_beam(lp, alphabet, beam_width=beam) == want
    assert ctc_beam_search_decode(lp, alphabet, beam_width=beam) == want
    assert ctc_beam_search_decode(torch.from_numpy(lp), alphabet, beam_width=beam) == want


@pytest.mark.parametrize("beam", [1, 4, 10])
@pytest.mark.parametrize("n_classes", [2, 3, 4, 5, 6])
def test_beam_search_equals_jax_on_random_log_probs(n_classes, beam):
    alphabet = "abcde"[: n_classes - 1]
    rng = np.random.default_rng(100 * n_classes + beam)
    for _ in range(6):
        logits = rng.normal(size=(int(rng.integers(1, 41)), n_classes)) * rng.uniform(0.5, 4)
        lp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
        want = jax_beam(lp, alphabet, beam_width=beam)
        assert ctc_beam_search_decode(lp, alphabet, beam_width=beam) == want
        lp32 = torch.from_numpy(lp.astype(np.float32))
        assert ctc_beam_search_decode(lp32, alphabet, beam) == jax_beam(lp32.numpy(), alphabet,
                                                                          beam)


def test_beam_search_decodes_a_bf16_tensor_as_jax_its_bf16_array():
    # numpy has no bfloat16: the port widens a bf16 tensor to float32
    # (exactly); JAX's function reads its bf16 array through ml_dtypes.
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(10, 5)) * 2
    lp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    want = jax_beam(jnp.asarray(lp, jnp.bfloat16), "abcd")
    assert want == "badadab"
    assert ctc_beam_search_decode(torch.from_numpy(lp).to(torch.bfloat16), "abcd") == want


# ------------------------------------------------------ config and profiling

def test_config_and_mesh_config_equal_jax():
    assert dataclasses.asdict(config.MeshConfig()) == dataclasses.asdict(jax_config.MeshConfig())
    ours, theirs = config.Config(), jax_config.Config()
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in
                                                          dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_trace_writes_a_trace_and_none_is_a_no_op(tmp_path):
    with trace(None):
        torch.ones(3).sum()
    with trace(str(tmp_path / "tb")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tb").glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert list(tmp_path.iterdir()) == [tmp_path / "tb"]


def test_throughput_summary_matches_jax():
    ours, theirs = Throughput(warmup=1, n_chips=2), JaxThroughput(warmup=1, n_chips=2)
    for counter in (ours, theirs):
        counter.update(100)
        time.sleep(0.01)
        counter.update(10)
        assert counter.items_per_sec_per_chip() == counter.last_rate > 0
    for rate in (0.0, 1234.4, 1234.5, 98765.6):
        ours.last_rate = theirs.last_rate = rate
        assert ours.summary() == theirs.summary()
