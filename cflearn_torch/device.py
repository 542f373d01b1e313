"""Device selection for the port's entry points."""

from typing import Any

import torch


def resolve_device(device: Any = None) -> torch.device:
    """`None` means the CUDA card; without one this raises instead of
    running on the CPU. Any explicit device ("cpu", "meta", "cuda:1") is
    taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cflearn_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
