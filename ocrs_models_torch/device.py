"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"``. Without a CUDA device they
raise instead of quietly running on the CPU; the CPU is used only when the
caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def as_device_tensor(x, device: str | torch.device = "cuda") -> torch.Tensor:
    """``x`` (a tensor or array) as a tensor on the resolved ``device``."""
    return torch.as_tensor(x).to(resolve_device(device))
