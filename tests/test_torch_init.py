"""Fresh port models start from flax's initialisers: each parameter's mean
and standard deviation in a fresh port model against the same parameter of
a fresh JAX model (``model.init`` on a small input), carried into the
port's keys by ``weights.*_state_dict_from_jax``.

Bounds, and why: the two are independent samples of one distribution, so
their means may differ by ``6 sigma sqrt(2/n)`` and their standard
deviations by ``6 sigma sqrt(1/n)`` (six standard errors of the
difference; ``sigma`` the JAX sample's standard deviation, ``n`` the
parameter's size). Constant parameters (zero biases, unit batch-norm
scales, running statistics) must be equal. Covered: the detector at full
width (622,122 parameters), the recognizer and the layout model at a small
width in both position embeddings.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ocrs_models_tpu.models.layout as jax_layout
from ocrs_models_tpu.models import DetectionModel as JaxDetection
from ocrs_models_tpu.models import RecognitionModel as JaxRecognition
from ocrs_models_torch.models import DetectionModel, LayoutModel, RecognitionModel
from ocrs_models_torch.weights import (
    detection_state_dict_from_jax,
    layout_state_dict_from_jax,
    recognition_state_dict_from_jax,
)

SMALL_LAYOUT = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64)


def _init(model, x, seed: int, **kwargs):
    """``model.init`` under ``jax.jit``: the same values, compiled once
    rather than op by op."""
    return jax.jit(functools.partial(model.init, **kwargs))(jax.random.key(seed), x)


def _assert_same_distribution(port: dict, jax_sd: dict) -> int:
    """Compare each floating parameter's statistics; returns how many
    parameters had spread to compare."""
    assert set(port) == set(jax_sd)
    spread = 0
    for key, want in jax_sd.items():
        got = port[key]
        if not torch.is_floating_point(want):
            continue
        want, got = want.double().numpy().ravel(), got.detach().double().numpy().ravel()
        if np.ptp(want) == 0:
            np.testing.assert_array_equal(got, want, err_msg=key)
            continue
        spread += 1
        n, sigma = want.size, want.std()
        assert abs(got.mean() - want.mean()) <= 6 * sigma * np.sqrt(2 / n), key
        assert abs(got.std() - sigma) <= 6 * sigma * np.sqrt(1 / n), (key, got.std(), sigma)
        # Truncated at two standard deviations, as flax's lecun_normal is.
        assert np.abs(got).max() <= 2 * np.abs(want).max() + 1e-12, key
    return spread


def test_detection_model_starts_from_flax_initialisers():
    variables = _init(JaxDetection(), jnp.zeros((1, 64, 64, 1)), 0, train=False)
    torch.manual_seed(0)
    model = DetectionModel()
    assert sum(p.numel() for p in model.parameters()) == 622_122
    spread = _assert_same_distribution(model.state_dict(), detection_state_dict_from_jax(variables))
    assert spread == 13 * 2 * 2 + 6 + 1  # dw and pw kernels, the up kernels, out_conv


def test_recognition_model_starts_from_flax_initialisers():
    variables = _init(JaxRecognition(n_classes=97), jnp.zeros((1, 64, 32, 1)), 1, train=False)
    torch.manual_seed(1)
    model = RecognitionModel(n_classes=97)
    spread = _assert_same_distribution(model.state_dict(),
                                       recognition_state_dict_from_jax(variables))
    assert spread == 7 + 1 + 2 * 2 * 4  # seven convs, output, the biGRU's


@pytest.mark.parametrize("pos_embedding", ["sin", "mlp"])
def test_layout_model_starts_from_flax_initialisers(pos_embedding):
    jax_model = jax_layout.LayoutModel(pos_embedding=pos_embedding, **SMALL_LAYOUT)
    variables = _init(jax_model, jnp.zeros((1, 8, 4)), 2)
    torch.manual_seed(2)
    model = LayoutModel(pos_embedding=pos_embedding, **SMALL_LAYOUT)
    spread = _assert_same_distribution(
        model.state_dict(),
        layout_state_dict_from_jax(variables, n_layers=2, pos_embedding=pos_embedding))
    assert spread == 2 * 4 + 1 + (2 if pos_embedding == "mlp" else 0)
