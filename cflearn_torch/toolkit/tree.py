"""State <-> flat numpy dicts (counterpart of the part of
`cflearn_tpu/toolkit/tree.py` that `schema/model.py` uses): the payload of
a saved model is {name: numpy array}, written as npz. numpy has no
bfloat16, so floating tensors go across as f32 (exact for bf16 and fp16)
and take their parameter's dtype again when loaded."""

from typing import Dict, Iterable, Mapping

import numpy as np
import torch


def tree_to_npd(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A state dict as {name: numpy array} on the host."""
    return {
        k: (v.detach().float() if v.is_floating_point() else v.detach()).cpu().numpy() for k, v in state.items()
    }


def npd_to_tree(npd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{name: numpy array} as CPU tensors (copies: arrays read from an npz
    file are read-only)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in npd.items()}


def tree_num_params(params: Iterable[torch.Tensor]) -> int:
    return sum(p.numel() for p in params)
