"""Where the port runs: the GPU unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means the GPU. A CUDA device without a GPU raises; the CPU is
    used only when the caller names it (the tests do)."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "gsavatar_torch runs on a CUDA GPU and none is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on `device` (a no-op on the CPU)."""
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
