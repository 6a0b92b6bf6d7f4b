"""ONNX and ``.npz`` export (the port's counterpart of
``ocrs_models_tpu/export``): the first-party ONNX writer and parser
(:mod:`.onnx_proto`), the strict opset-16 checker (:mod:`.onnx_check`),
the three graph builders (:mod:`.onnx_graph`), the numpy evaluator
(:mod:`.onnx_eval`), the mapping of the port's state dicts onto the JAX
package's variable trees (:mod:`ocrs_models_torch.weights`) and the
``convert`` CLI (``python -m ocrs_models_torch.export``)."""

from ..weights import (
    jax_variables_from_detection_state_dict,
    jax_variables_from_layout_state_dict,
    jax_variables_from_recognition_state_dict,
)
from .onnx_graph import (
    build_detection_onnx,
    build_layout_onnx,
    build_recognition_onnx,
)

__all__ = [
    "jax_variables_from_detection_state_dict",
    "jax_variables_from_recognition_state_dict",
    "jax_variables_from_layout_state_dict",
    "build_detection_onnx",
    "build_recognition_onnx",
    "build_layout_onnx",
]
