"""Device selection for the port's entry points.

The rule: CUDA unless the caller asks for the CPU, and raise when CUDA was
asked for (or defaulted to) but is absent.  Nothing here drops to the CPU on
its own, so a run that was meant for the card never silently runs elsewhere.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device raises when CUDA is unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (the default for the port's entry points) "
            "but torch.cuda.is_available() is False; pass device='cpu' to "
            "run on the CPU")
    return dev


def tensor_device(x, device: DeviceLike = None) -> torch.device:
    """The device a fit or score runs on: a tensor or ``SparseMatrix``
    input decides it, otherwise ``resolve_device(device)``."""
    from .sparse.matrix import SparseMatrix
    if isinstance(x, (torch.Tensor, SparseMatrix)):
        return x.device
    return resolve_device(device)
