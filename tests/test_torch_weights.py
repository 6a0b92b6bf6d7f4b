"""The port's weight mapping equals the JAX package's own export to the
reference torch format, key for key and value for value, and loads
strictly into the port's modules."""

import numpy as np
import pytest
import torch

from ocrs_models_tpu.export.torch_export import (
    export_detection_state_dict,
    export_recognition_state_dict,
)
from ocrs_models_tpu.export.torch_import import import_recognition_state_dict
from ocrs_models_tpu.models import DetectionModel as JaxDetection
from ocrs_models_tpu.models import RecognitionModel as JaxRecognition
from ocrs_models_torch.models import DetectionModel, RecognitionModel
from ocrs_models_torch.weights import (
    detection_state_dict_from_jax,
    recognition_state_dict_from_jax,
)
from torch_port_common import random_variables


def _assert_same(got: dict, want: dict):
    assert list(got) == list(want)
    for key in want:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("hidden", [32, 256])
def test_recognition_mapping_equals_export(hidden):
    variables = random_variables(
        JaxRecognition(n_classes=97, gru_hidden=hidden), (1, 64, 32, 1), seed=0
    )
    sd = recognition_state_dict_from_jax(variables)
    _assert_same(sd, export_recognition_state_dict(variables))
    RecognitionModel(n_classes=97, gru_hidden=hidden).load_state_dict(sd, strict=True)


def test_detection_mapping_equals_export():
    variables = random_variables(JaxDetection(), (1, 64, 64, 1), seed=1)
    sd = detection_state_dict_from_jax(variables)
    _assert_same(sd, export_detection_state_dict(variables))
    DetectionModel().load_state_dict(sd, strict=True)


def test_reference_format_round_trip():
    # A state dict in the reference's .pt format (here: the port's own)
    # goes through the JAX importer and back unchanged.
    port = RecognitionModel(n_classes=97)
    sd = {k: v.detach() for k, v in port.state_dict().items()}
    back = recognition_state_dict_from_jax(import_recognition_state_dict(sd))
    assert set(back) == set(sd)
    for key, value in sd.items():
        torch.testing.assert_close(back[key], value, rtol=0, atol=0)
