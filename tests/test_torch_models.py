"""Port's recognition and detection models vs the JAX package's, in eval
mode and float32, with the weights carried across by ``weights.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrs_models_tpu.models import DetectionModel as JaxDetection
from ocrs_models_tpu.models import RecognitionModel as JaxRecognition
from ocrs_models_torch.models import DetectionModel, RecognitionModel
from ocrs_models_torch.weights import (
    detection_state_dict_from_jax,
    recognition_state_dict_from_jax,
)
from torch_port_common import nhwc_to_nchw, random_variables


def _recognition(conv_backend, gru_backend, width, seed=0):
    jax_model = JaxRecognition(
        n_classes=97, gru_hidden=32, gru_dtype=jnp.float32,
        conv_backend=conv_backend, gru_backend=gru_backend,
    )
    variables = random_variables(jax_model, (1, 64, 32, 1), seed)
    x = np.random.default_rng(seed).uniform(-0.5, 0.5, (2, 64, width, 1)).astype(np.float32)
    want = np.asarray(jax_model.apply(variables, jnp.asarray(x), train=False))
    port = RecognitionModel(n_classes=97, gru_hidden=32).eval()
    port.load_state_dict(recognition_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = port(nhwc_to_nchw(x)).numpy()
    return got, want


@pytest.mark.parametrize(
    "conv_backend,gru_backend", [("fused", "pallas4"), ("xla", "scan")]
)
def test_recognition_matches_jax(conv_backend, gru_backend):
    got, want = _recognition(conv_backend, gru_backend, width=32)
    assert got.shape == want.shape == (2, 32 // 4 + 1, 97)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_recognition_odd_width_matches_jax():
    # W % 4 != 0: the pools floor and the model still emits W//4 + 1 steps.
    got, want = _recognition("xla", "scan", width=38, seed=1)
    assert got.shape == want.shape == (2, 38 // 4 + 1, 97)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_detection_matches_jax():
    jax_model = JaxDetection()
    variables = random_variables(jax_model, (1, 64, 64, 1), seed=2)
    x = np.random.default_rng(2).uniform(-0.5, 0.5, (2, 128, 96, 1)).astype(np.float32)
    want = np.asarray(jax_model.apply(variables, jnp.asarray(x), train=False))
    port = DetectionModel().eval()
    port.load_state_dict(detection_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = port(nhwc_to_nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 128, 96, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
