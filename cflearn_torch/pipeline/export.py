"""Deployable artifacts of a trained model (counterpart of
`cflearn_tpu/pipeline/export.py`, whose artifact is a StableHLO program).

* `export_model` — `torch.export.export` of the model's inference forward
  (`model.run(batch, training=False)` without a gradient) at the example
  batch's static shapes, saved by `torch.export.save` as `<name>.pt2`,
  beside the weights in the model's own `<name>.npz` and the input spec in
  `<name>.json` (each key's shape and dtype, and the device the program was
  traced on): the JAX package's folder layout, with `.pt2` where it writes
  `.stablehlo`. The hand-written kernels on the path stay in the program as
  operations of PyTorch's dispatcher (`cflearn_torch::flash_attention`,
  `::flash_fwd_lse`, `::conv3x3`, `::group_norm_silu`): on the card each
  node launches its kernel and counts the launch, on the CPU it runs the
  plain version; `op_counts` counts them in a graph.
* `load_exported` — `torch.export.load(...).module()` on the device the
  program was traced on, wrapped in an `ExportedModel` that takes a numpy
  (or tensor) batch and returns the outputs as tensors.
* `pack_exported` (also named `pack_stablehlo`, the JAX name) — a training
  workspace's pipeline, loaded, exported into a folder.
* `aot_compile` — the inference forward captured in a CUDA graph at the
  example batch's shapes and replayed on every call (`CapturedForward`); on
  a model that the caller put on the CPU it runs eagerly. A replay runs the
  captured kernels without entering their wrappers, so the counters do not
  move: `launches_per_replay` holds the launches of the capture and
  `replays` the calls, so that captures x replays is the count.
"""

import json
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..data.utils import convert
from ..ops import launch_counts
from ..schema.model import IDLModel

# the operations that carry a kernel, by the launch counter each one moves
KERNEL_OPS = {
    "cflearn_torch::flash_attention": "flash_attention",
    "cflearn_torch::flash_fwd_lse": "flash_fwd_lse",
    "cflearn_torch::conv3x3": "conv3x3",
    "cflearn_torch::group_norm_silu": "group_norm",
}


class InferenceForward(nn.Module):
    """`model.run(batch, training=False, **forward_kwargs)` as a module whose
    outputs are the tensors among the model's outputs."""

    def __init__(self, model: IDLModel, forward_kwargs: Optional[Dict[str, Any]] = None) -> None:
        super().__init__()
        self.model = model
        self.forward_kwargs = dict(forward_kwargs or {})

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        outputs = self.model.run(batch, training=False, **self.forward_kwargs)
        return {k: v for k, v in outputs.items() if torch.is_tensor(v)}


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _as_batch(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: (v.to(device) if torch.is_tensor(v) else convert({k: np.asarray(v)}, device)[k])
            for k, v in batch.items()}


def op_counts(graph: Any) -> Dict[str, int]:
    """{operation: call_function nodes} of the kernel-carrying operations
    in a `torch.fx.Graph` (an exported program's `graph`, nested graphs
    included)."""
    counts: Dict[str, int] = {}
    graphs = [graph]
    while graphs:
        g = graphs.pop()
        for node in g.nodes:
            if node.op == "get_attr":
                sub = getattr(g.owning_module, node.target, None) if g.owning_module is not None else None
                if isinstance(sub, torch.fx.GraphModule):
                    graphs.append(sub.graph)
            if node.op != "call_function" or not isinstance(node.target, torch._ops.OpOverload):
                continue
            name = node.target._schema.name
            if name in KERNEL_OPS:
                counts[name] = counts.get(name, 0) + 1
    return counts


def export_program(
    model: IDLModel, example_batch: Dict[str, Any], forward_kwargs: Optional[Dict[str, Any]] = None,
) -> "torch.export.ExportedProgram":
    """`torch.export.export` of the model's inference forward at the example
    batch's shapes, on the model's device, without a gradient."""
    model.set_mode(False)
    batch = _as_batch(example_batch, _device_of(model))
    with torch.no_grad():
        return torch.export.export(InferenceForward(model, forward_kwargs), (batch,), strict=False)


def export_model(
    model: IDLModel,
    example_batch: Dict[str, Any],
    folder: str,
    *,
    name: str = "model",
    forward_kwargs: Optional[Dict[str, Any]] = None,
) -> str:
    """The model's inference forward as `<folder>/<name>.pt2`, its weights as
    `<name>.npz` and its input spec as `<name>.json`; returns `folder`.
    `forward_kwargs` (JSON values) go to `model.run`, e.g. `{"sample": False}`
    for an autoencoder's posterior mode in place of a draw."""
    os.makedirs(folder, exist_ok=True)
    program = export_program(model, example_batch, forward_kwargs)
    torch.export.save(program, os.path.join(folder, f"{name}.pt2"))
    model.save(os.path.join(folder, f"{name}.npz"))
    spec = {k: [list(np.shape(v)), str(np.asarray(v).dtype) if not torch.is_tensor(v) else str(v.dtype)]
            for k, v in example_batch.items()}
    with open(os.path.join(folder, f"{name}.json"), "w") as f:
        json.dump({"input_spec": spec, "device": str(_device_of(model)), "forward_kwargs": forward_kwargs or {},
                   "ops": op_counts(program.graph)}, f, indent=2)
    return folder


class ExportedModel:
    """A loaded export: `__call__(batch)` runs the program without a
    gradient on its device; `program` is the `ExportedProgram`, `module`
    its callable module."""

    def __init__(self, program: "torch.export.ExportedProgram", device: torch.device) -> None:
        self.program = program
        self.module = program.module()
        self.device = device

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return self.module(_as_batch(batch, self.device))

    def op_counts(self) -> Dict[str, int]:
        return op_counts(self.program.graph)


def _index(device: torch.device) -> tuple:
    return device.type, 0 if device.index is None and device.type == "cuda" else device.index


def load_exported(folder: str, *, name: str = "model", device: Any = None) -> ExportedModel:
    """`torch.export.load(...).module()` of `export_model`'s folder. The
    program holds the device it was traced on; `device`, where given, must
    be that one (export again to move it)."""
    with open(os.path.join(folder, f"{name}.json"), "r") as f:
        traced_on = torch.device(json.load(f)["device"])
    if device is not None and _index(torch.device(device)) != _index(traced_on):
        raise ValueError(f"the program in '{folder}' was traced on {traced_on}, not {device}: export it there")
    from ..ops import attention, conv, group_norm  # noqa: F401  (the kernels' operations, before the program is read)

    return ExportedModel(torch.export.load(os.path.join(folder, f"{name}.pt2")), traced_on)


def pack_exported(
    workspace: str,
    export_folder: str,
    example_batch: Dict[str, Any],
    *,
    device: Any = None,
    forward_kwargs: Optional[Dict[str, Any]] = None,
) -> str:
    """A training workspace's pipeline (`<workspace>/pipeline`) loaded on
    `device` and its model exported into `export_folder`. The JAX package
    names this `pack_stablehlo`, which is kept as an alias: what it writes
    here is a `torch.export` program, not StableHLO."""
    from .api import DLPipelineSerializer

    pipeline = DLPipelineSerializer.load_inference(os.path.join(workspace, "pipeline"), device=device)
    return export_model(pipeline.model, example_batch, export_folder, forward_kwargs=forward_kwargs)


pack_stablehlo = pack_exported


class CapturedForward:
    """The inference forward at fixed shapes: on the card, captured once in
    a CUDA graph (after warm-up calls on a side stream) and replayed on
    every call, the inputs copied into the graph's static tensors; on the
    CPU, the eager forward. `launches_per_replay` holds the kernels launched
    by the capture; the counters do not move on a replay."""

    def __init__(
        self, model: IDLModel, example_batch: Dict[str, Any], *, forward_kwargs: Optional[Dict[str, Any]] = None,
        warmup: int = 2,
    ) -> None:
        model.set_mode(False)
        self.forward = InferenceForward(model, forward_kwargs)
        self.device = _device_of(model)
        # the graph's own input tensors: a caller's tensor is never written into
        self.static_inputs = {k: v.clone() for k, v in _as_batch(example_batch, self.device).items()}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches_per_replay: Dict[str, int] = {}
        self.replays = 0
        if self.device.type != "cuda":
            return
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.no_grad(), torch.cuda.stream(stream):
            for _ in range(warmup):
                self.forward(self.static_inputs)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        torch.cuda.synchronize(self.device)
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(self.graph):
            self.static_outputs = self.forward(self.static_inputs)
        after = launch_counts()
        self.launches_per_replay = {k: after[k] - before[k] for k in after if after[k] != before[k]}

    def replay(self) -> None:
        """One replay of the captured graph on the current inputs."""
        assert self.graph is not None
        self.graph.replay()
        self.replays += 1

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        inputs = _as_batch(batch, self.device)
        if self.graph is None:
            with torch.no_grad():
                return self.forward(inputs)
        for k, v in inputs.items():
            self.static_inputs[k].copy_(v)
        self.replay()
        return {k: v.clone() for k, v in self.static_outputs.items()}


def aot_compile(
    model: IDLModel, example_batch: Dict[str, Any], *, forward_kwargs: Optional[Dict[str, Any]] = None,
) -> Callable[[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """The inference forward captured at the example batch's shapes (a
    `CapturedForward`): the counterpart of the JAX package's ahead-of-time
    compile, and what `DiffusionAPI.compile` can build on."""
    return CapturedForward(model, example_batch, forward_kwargs=forward_kwargs)
