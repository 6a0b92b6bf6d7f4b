"""PyTorch/CUDA port of the OCR models for NVIDIA Hopper.

A second package beside the JAX reference (``ocrs_models_tpu``), with the
same module names: U-Net text detection, connected-component word quads,
line grouping (by vertical overlap or by the layout transformer) and CRNN
recognition with greedy CTC decode, composed by
:class:`ocrs_models_torch.pipeline.OcrPipeline`; the recognition and
layout trainers under ``training/``. The recognizer's six kernels (stage
1 and the biGRU recurrence, forward and backward, and the CTC recursions)
are written in CUDA C++ for ``sm_90a`` under ``csrc/``, built with
``nvcc`` at first use and loaded with ``ctypes``; each has a plain PyTorch
twin that runs on CPU tensors. The layout model runs plain PyTorch.

The package imports torch, numpy and the standard library only. Entry
points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
