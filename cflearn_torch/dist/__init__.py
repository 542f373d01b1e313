"""Multi-process launching (counterpart of `cflearn_tpu/dist/`):
`run_distributed` spawns the ranks of one `torch.distributed` program, and
`ml` schedules many independent training tasks."""

from . import launch
from . import ml
from .launch import run_distributed

__all__ = ["launch", "ml", "run_distributed"]
