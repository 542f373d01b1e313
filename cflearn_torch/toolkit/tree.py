"""State <-> flat numpy dicts (counterpart of the part of
`cflearn_tpu/toolkit/tree.py` that `schema/model.py` uses): the payload of
a saved model is {name: numpy array}, written as npz. numpy has no
bfloat16, so floating tensors go across as f32 (exact for bf16 and fp16)
and take their parameter's dtype again when loaded."""

from typing import Any, Dict, Iterable, Mapping

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


def convert_pp_layout(states: Mapping[str, Any], targets: Iterable[str]) -> Dict[str, Any]:
    """A state dict rewritten toward the layout of `targets` (a model's
    state-dict keys), so that checkpoints move across
    `MixedStackedEncoder(pipeline_parallel=...)`: a target `...pp_block.rest`
    missing from `states` is stacked from `...blocks.{i}.rest` (on a new
    leading axis), a target `...blocks.{i}.rest` is row i of
    `...pp_block.rest`. Keys present pass through untouched; the source
    keys of a conversion are dropped."""
    out = dict(states)
    targets = list(targets)
    used = set()
    for key in targets:
        if key in out:
            continue
        if "pp_block." in key:
            prefix, rest = key.split("pp_block.", 1)
            parts = []
            while f"{prefix}blocks.{len(parts)}.{rest}" in states:
                used.add(f"{prefix}blocks.{len(parts)}.{rest}")
                parts.append(states[f"{prefix}blocks.{len(parts)}.{rest}"])
            if parts:
                out[key] = (
                    torch.stack([torch.as_tensor(p) for p in parts])
                    if torch.is_tensor(parts[0]) else np.stack(parts)
                )
        elif "blocks." in key:
            prefix, tail = key.rsplit("blocks.", 1)
            idx, _, rest = tail.partition(".")
            src = f"{prefix}pp_block.{rest}"
            if idx.isdigit() and src in states:
                used.add(src)
                out[key] = states[src][int(idx)]
    for key in used - set(targets):
        del out[key]
    return out
