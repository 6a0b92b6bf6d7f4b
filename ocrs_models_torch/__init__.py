"""PyTorch/CUDA port of the OCR serving path for NVIDIA Hopper.

A second package beside the JAX reference (``ocrs_models_tpu``), with the
same module names: U-Net text detection, connected-component word quads,
line grouping and CRNN recognition with greedy CTC decode, composed by
:class:`ocrs_models_torch.pipeline.OcrPipeline`. The two kernels on the
serving path (recognition stage 1 and the biGRU recurrence) are written in
CUDA C++ for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
and loaded with ``ctypes``; each has a plain PyTorch twin that runs on CPU
tensors.

The package imports torch, numpy and the standard library only. Entry
points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
