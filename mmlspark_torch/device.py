"""Device resolution for the PyTorch port.

Counterpart of ``mmlspark_tpu/utils/platform.py:target_platform``: the one
place that decides where a computation lands. Entry points run on CUDA
unless the caller asks for the CPU by name; asking for CUDA on a machine
without a usable GPU is an error, never a silent move to the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the default (``cuda``). Raises ``RuntimeError`` when
    CUDA is requested and ``torch.cuda.is_available()`` is false."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA GPU is "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or "
                         "'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
