"""The device the port's entry points run on."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: Optional[DeviceLike] = None) -> torch.device:
    """``device``, or the first CUDA device when none is given.

    A CUDA device that is not there raises: nothing in the port runs on the
    CPU in place of a missing card, only when the caller asks for the CPU.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: no CUDA device is visible; ask for the CPU "
            "(device='cpu', --device cpu) to run there"
        )
    return device
