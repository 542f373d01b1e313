"""The SD checkpoint converter (counterpart of `cflearn_tpu/scripts/sd.py`):
an upstream-layout SD or ControlNet checkpoint (`.safetensors`, `.ckpt`,
`.pt`, `.pth`) converted to the port's parameter names, and `inject` to load
the converted tensors into a live `DiffusionAPI`.

    python -m cflearn_torch.scripts.sd CKPT --out OUT.safetensors [--version v1|v2] [--controlnet]

The conversions are the zoo's (`zoo/convert.py`), strict like its loaders:
an upstream key that no parameter takes and no drop list names raises. The
output is a `.safetensors` file of the port's names (the port's own writer),
which `zoo.convert.load_torch_state_dict` reads back. `inject` is strict too (`zoo.common.load_into`):
it raises, naming the parameters the tensors leave unfilled, the tensors
that fill none and the shapes that differ, where the JAX package's `inject`
loads with `strict=False` and leaves such parameters as they were.
"""

import argparse
from typing import Any, Dict, List, Optional

import torch


def convert(ckpt_path: str, *, version: str = "v1") -> Dict[str, torch.Tensor]:
    """An upstream SD checkpoint (v1 or v2 layout) as {port name: tensor}."""
    from ..zoo import convert as C

    return C.convert_sd(C.load_torch_state_dict(ckpt_path), version=version)


def convert_v2(ckpt_path: str) -> Dict[str, torch.Tensor]:
    return convert(ckpt_path, version="v2")


def convert_controlnet(ckpt_path: str) -> Dict[str, torch.Tensor]:
    """An upstream ControlNet checkpoint (SD-1.5's geometry) as {port name:
    tensor}: the ControlNet module's own names (`zoo.load_control_net`)."""
    from ..zoo import convert as C

    return C.convert_controlnet_sd(C.load_torch_state_dict(ckpt_path))


def inject(api: Any, states: Dict[str, torch.Tensor]) -> None:
    """Copy converted tensors into `api.m` in place, each cast to its
    parameter's dtype and device; raises unless they fill every parameter
    with its shape and name nothing else."""
    from ..zoo.common import load_into

    load_into(api.m, states, "inject")


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Convert an upstream SD or ControlNet checkpoint to cflearn_torch")
    parser.add_argument("ckpt", type=str)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--version", type=str, default="v1")
    parser.add_argument("--controlnet", action="store_true")
    args = parser.parse_args(argv)
    from ..zoo.convert import write_safetensors

    states = convert_controlnet(args.ckpt) if args.controlnet else convert(args.ckpt, version=args.version)
    write_safetensors(args.out, states)
    print(f"wrote {len(states)} tensors to {args.out}")


if __name__ == "__main__":
    main()
