"""One call captured in a CUDA graph: what `pipeline.export.aot_compile` and
`DiffusionAPI.compile` share.

`CapturedCall(fn, static_inputs)` runs `fn(**static_inputs)` a few times on
a side stream (the warm-up: lazy initialisation, cuBLAS / cuDNN plans, host
caches such as ToMe's indices), then captures one call in a
`torch.cuda.CUDAGraph`, optionally from a memory pool that several captures
share (`torch.cuda.graph_pool_handle()`). A `torch.Generator` that `fn`
draws from must be named in `generators`: the graph registers it
(`CUDAGraph.register_generator_state`), so that each replay draws at the
generator's offset of that moment and advances it by what the captured
draws take, as eager calls would (a capture with an unregistered
generator raises). The warm-up calls draw eagerly and move it: a caller
that wants the first replay to draw what an eager call would restores its
state after the construction. A call copies its inputs into the
static input tensors (not where a caller hands the static tensor itself)
and replays the graph; an input of another shape or dtype than its static
tensor raises `TypeError` before anything is copied or replayed
(`check_inputs`), as a JAX `Compiled` refuses arguments of other shapes
or dtypes (a plain `copy_` would broadcast a smaller batch or cast); the outputs are the static output tensors, which the
next replay overwrites: a caller that keeps one copies it out.

A replay launches the captured kernels without entering their wrappers, so
the launch counters do not move: `launches_per_replay` holds the launches
of the capture and `replays` the replays since, and
`launches_per_replay[k] * replays` is kernel k's count. Captures share a
pool only where they replay one at a time on one stream, and a static
output that one graph writes and another reads (DeepCache's feature)
stays referenced, so the pool never hands its memory to another capture.
"""

from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import torch

from . import launch_counts


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a tensor, a dict of them, or None."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def check_inputs(static: Dict[str, Any], inputs: Dict[str, Any], path: str = "") -> None:
    """Raise `TypeError` unless each input matches its static tensor's shape
    and dtype (the device may differ: the copy moves it), naming the key,
    the captured shape and dtype and the given ones."""
    for k, v in inputs.items():
        key = f"{path}{k}"
        if k not in static:
            raise TypeError(f"input {key!r} was not captured (captured: {sorted(static)})")
        dst = static[k]
        if torch.is_tensor(dst):
            if not torch.is_tensor(v):
                raise TypeError(f"input {key!r}: captured a tensor {tuple(dst.shape)} {dst.dtype}, given {type(v).__name__}")
            if v.shape != dst.shape or v.dtype != dst.dtype:
                raise TypeError(
                    f"input {key!r}: captured for shape {tuple(dst.shape)} and dtype {dst.dtype}, given shape "
                    f"{tuple(v.shape)} and dtype {v.dtype}"
                )
        elif isinstance(dst, dict):
            if not isinstance(v, dict) or set(v) != set(dst):
                got = sorted(v) if isinstance(v, dict) else type(v).__name__
                raise TypeError(f"input {key!r}: captured a dict of {sorted(dst)}, given {got}")
            check_inputs(dst, v, f"{key}.")


def _copy_into(dst: Any, src: Any) -> None:
    if torch.is_tensor(dst):
        if dst is not src:
            dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])


class CapturedCall:
    """`fn(**static_inputs)` captured in one CUDA graph (the module's doc)."""

    def __init__(
        self,
        fn: Callable[..., Any],
        static_inputs: Dict[str, Any],
        *,
        warmup: int = 2,
        pool: Optional[Any] = None,
        generators: Sequence[torch.Generator] = (),
    ) -> None:
        self.static_inputs = static_inputs
        device = next(_tensors(static_inputs)).device
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph captures work on a CUDA device, not {device}")
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.no_grad(), torch.cuda.stream(stream):
            for _ in range(warmup):
                fn(**static_inputs)
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        with torch.no_grad(), torch.cuda.graph(self.graph, pool=pool):
            self.static_outputs = fn(**static_inputs)
        after = launch_counts()
        self.launches_per_replay = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self.replays = 0

    def replay(self) -> None:
        """One replay on the inputs the static tensors hold now."""
        self.graph.replay()
        self.replays += 1

    def __call__(self, **inputs: Any) -> Any:
        """The inputs checked (`check_inputs`) and copied in, one replay; the
        static outputs."""
        check_inputs(self.static_inputs, inputs)
        for k, v in inputs.items():
            _copy_into(self.static_inputs[k], v)
        self.replay()
        return self.static_outputs

    def launches(self) -> Dict[str, int]:
        """{kernel: launches_per_replay x replays}."""
        return {k: n * self.replays for k, n in self.launches_per_replay.items()}
