"""Device resolution shared by the port's entry points.

Every entry point (``core.suite.build_arch``, ``BenchmarkRunner``,
``launch.serve.ServeEngine`` / ``Server`` and the serve CLI) takes a
``device`` argument that defaults to ``"cuda"``.  Asking for the card on a
machine without one raises instead of falling back to the CPU: a number
measured on the CPU must never pass for a device number.  Tests pass
``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises when CUDA is asked for
    and no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asked for, but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch path")
    return dev


def device_name(device: DeviceLike) -> str:
    """A human-readable name of the device results were measured on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type
