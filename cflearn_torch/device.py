"""Device selection for the port's entry points, and the card facts the
kernels' planners read."""

import functools
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


SM_COUNT = 132  # an H100 SXM's; the kernel wrappers plan with the card's own count


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device `index` (a CUDA tensor's `device.index`)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_ptr(device: torch.device) -> int:
    """The raw `cudaStream_t` of the current stream on CUDA `device`, for a kernel's C interface: what
    `torch.cuda.current_stream(device).cuda_stream` gives, without building a `Stream` object (a few
    microseconds a call, which the W8A8 route's two launches a conv pay on the host)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
