"""Device resolution: the counterpart of the reference's
``parallel/mesh.py`` for one card. Entry points run on ``cuda:0`` unless
the caller asks for the CPU; with no GPU and no explicit ``device="cpu"``
they raise instead of quietly running on the CPU."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


class NoDeviceError(RuntimeError):
    """No CUDA device, and the caller did not ask for the CPU."""


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise NoDeviceError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain torch path on the CPU")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(f"{dev} requested but no CUDA device is "
                            f"available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_context(dev: torch.device):
    """The context a launch on `dev` runs under: torch.cuda.device for a
    CUDA device (kernels, their attributes and collectives act on the
    host thread's current device), nothing for the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())
