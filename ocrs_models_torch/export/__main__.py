"""Checkpoint conversion CLI (the port's counterpart of
``python -m ocrs_models_tpu.export convert``).

``convert`` reads a ``.pt`` checkpoint of one of the three models: the
port's trainer checkpoint ``{epoch, model_state, optimizer_state, step}``,
a reference-format ``--export x.pt`` of either package ``{epoch,
model_state, optimizer_state: {}}``, or a bare state dict. It loads it with
``strict=True`` into the default model of the named kind and writes, by
extension, ``.npz`` (the JAX package's flat archive), ``.pt`` (a
reference-format checkpoint) or ``.onnx`` (first-party emission with the
reference's io names, dynamic axes and opset 16, spec-checked). A
checkpoint of the wrong kind raises and writes nothing.

Example::

    python -m ocrs_models_torch.export convert recognition \\
        text-rec-checkpoint.pt text-recognition.onnx

Conversion computes nothing on a device: it reads the checkpoint with
``map_location="cpu"`` and writes numpy arrays and bytes, so it runs on
machines without a GPU. This is not a fallback from the GPU; no forward
pass runs. The JAX package's ``import-pt`` (reference ``.pt`` -> Orbax
directory) is not ported: only the JAX package reads Orbax directories,
and the port's trainers take a ``.pt`` directly.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..config import DEFAULT_ALPHABET
from ..models import DetectionModel, LayoutModel, RecognitionModel
from ..training.export_utils import MODELS, export_weights
from ..training.state import create_train_state


def default_model(kind: str) -> torch.nn.Module:
    """The default model of ``kind``, on the CPU (JAX ``_model_and_input``)."""
    if kind == "detection":
        return DetectionModel()
    if kind == "recognition":
        return RecognitionModel(n_classes=len(DEFAULT_ALPHABET) + 1)
    return LayoutModel()


def load_state_dict(path: str) -> tuple[dict, int]:
    """Read a ``.pt`` checkpoint on the CPU; returns ``(state_dict, epoch)``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "model_state" in payload:
        return payload["model_state"], int(payload.get("epoch", 0))
    return payload, 0  # bare state_dict


def cmd_convert(args) -> int:
    sd, epoch = load_state_dict(args.pt_file)
    model = default_model(args.model)
    model.load_state_dict(sd, strict=True)  # a checkpoint of another kind raises here
    export_weights(create_train_state(model), args.out_file, model=args.model, epoch=epoch)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ocrs_models_torch.export",
        description=__doc__.split("\n\n")[0],
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_conv = sub.add_parser("convert", help=".pt checkpoint -> .npz / .pt / .onnx")
    p_conv.add_argument("model", choices=MODELS)
    p_conv.add_argument("pt_file")
    p_conv.add_argument("out_file")
    p_conv.set_defaults(fn=cmd_convert)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
