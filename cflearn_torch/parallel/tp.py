"""Tensor-, expert- and pipeline-parallel placement (counterpart of
`cflearn_tpu/parallel/tp.py`), and its execution.

The rules are the JAX package's, matched against the JAX path of each
parameter (`bridge.jax_param_names`, "m/.../to_q/kernel/value") and its
JAX shape, so that one rule list places the same tensors in both packages:
"col" splits the output axis of a kernel over `model`, "row" its input
axis, "expert" the leading expert axis; a stacked pipeline leaf
(`pp_block`, leading axis L) splits L over `pipe` and keeps the rule of
its inner shape; with `use_fsdp`, a parameter no rule places splits its
largest divisible axis over `fsdp` (in the JAX layout's axis order, so
that ties fall alike). `plan_placement` gives every parameter's spec in the
port's layout (a Linear `weight` is (out, in): "col" splits dim 0, "row"
dim 1).

GSPMD shards logically and inserts what the math needs; here every rank
runs its shard, so the plan also says how (`ParamPlacement.parts`,
`.note`):

- a column shard of a fused projection holds this rank's slice of each of
  its parts: GEGLU's `net1.net` (x and gate halves), `in_proj` and a
  [Q | K | V] `to_qkv` (thirds); `MultiHeadSpatialAttention.to_qkv`
  interleaves q, k and v per head, so whole heads are contiguous there;
- a column shard of an attention's q / k / v holds whole heads (the flash
  kernel runs on the local heads): where the heads do not divide the axis
  the layer stays replicated (the math is the same) and the plan says why;
- a column-parallel bias splits with its weight; a row-parallel bias is
  replicated and added once, after the reduction.

`place_params` applies a plan to a model on a `Mesh`: each placed
parameter keeps only this rank's shard (over `model` and `pipe`; an
`fsdp` split leaves the parameter whole, and the trainer's optimizer
updates only this rank's part of it), each column- / row-parallel Linear
becomes a `ColumnParallelLinear` / `RowParallelLinear` (Megatron's pair:
the input's gradient all-reduced before a column product, the output
all-reduced after a row product, `parallel.comm`), an attention module
counts only its local heads, and a MoE mixer runs only its local experts
and sums their combine over `model`. `gather_state_dict` / `unplace_params`
go back to whole tensors; `local_state_dict` cuts whole tensors to a
rank's shards. `describe_placement` lists the plan."""

import re
from typing import Any, Dict, List, NamedTuple, Optional, Pattern, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..modules.layers import Linear, _promote
from . import comm
from .mesh import Mesh, fsdp_param_sharding

# (pattern, kind) over JAX parameter paths: "col" splits a kernel's OUTPUT axis, "row" its INPUT axis
_DEFAULT_TP_RULES: List[Tuple[str, str]] = [
    # attention projections: q / k / v column-parallel, the output row-parallel
    (r".*/to_q/kernel.*", "col"),
    (r".*/to_k/kernel.*", "col"),
    (r".*/to_v/kernel.*", "col"),
    (r".*/to_qkv/kernel.*", "col"),
    (r".*/in_proj/kernel.*", "col"),
    (r".*/(q|k|v)_proj/kernel.*", "col"),
    (r".*/to_out/kernel.*", "row"),
    (r".*/out_proj/kernel.*", "row"),
    # feed-forwards: fc1 col, fc2 row (CLIP's and the transformers')
    (r".*/fc1/kernel.*", "col"),
    (r".*/fc2/kernel.*", "row"),
    (r".*/ff/net1/net/kernel.*", "col"),
    (r".*/ff/linear2/kernel.*", "row"),
    # the time embedding's MLP
    (r".*/time_fc1/kernel.*", "col"),
    (r".*/time_fc2/kernel.*", "row"),
    # MoE experts (leading num_experts axis) over `model`
    (r".*/experts_(w1|w2|b1|b2).*", "expert"),
]

# kernel rank -> the JAX axis of each port axis (as `bridge._PERM`)
_PERM = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def compile_rules(rules: Optional[Sequence[Tuple[str, str]]] = None) -> List[Tuple[Pattern, str]]:
    return [(re.compile(p), kind) for p, kind in (rules or _DEFAULT_TP_RULES)]


def _rule_kind(path: str, rules: List[Tuple[Pattern, str]]) -> Optional[str]:
    for pattern, kind in rules:
        if pattern.match(path):
            return kind
    return None


def tp_spec_for(path: str, shape: Sequence[int], tp_size: int, rules: List[Tuple[Pattern, str]]) -> Optional[Tuple]:
    """The JAX-layout spec of a leaf under TP, or None (replicated): the
    first matching rule decides, where its axis divides."""
    if len(shape) < 2 or tp_size <= 1:
        return None
    for pattern, kind in rules:
        if pattern.match(path):
            spec: List[Any] = [None] * len(shape)
            if kind == "expert" and shape[0] % tp_size == 0:
                spec[0] = "model"
                return tuple(spec)
            if kind == "col" and shape[-1] % tp_size == 0:
                spec[-1] = "model"
                return tuple(spec)
            if kind == "row" and shape[-2] % tp_size == 0:
                spec[-2] = "model"
                return tuple(spec)
    return None


def _is_pp_block(path: str) -> bool:
    return "/pp_block/" in path or path.startswith("pp_block/")


def pp_spec_for(
    path: str, shape: Sequence[int], pipe_size: int, tp_size: int, rules: List[Tuple[Pattern, str]]
) -> Optional[Tuple]:
    """The JAX-layout spec of a stacked pipeline leaf: its leading L axis
    over `pipe`, its inner axes by their TP rule."""
    if not _is_pp_block(path) or pipe_size <= 1 or len(shape) < 1 or shape[0] % pipe_size != 0:
        return None
    inner: Tuple[Any, ...] = (None,) * (len(shape) - 1)
    if tp_size > 1 and len(shape) >= 3:
        inner_spec = tp_spec_for(path, shape[1:], tp_size, rules)
        if inner_spec is not None:
            inner = tuple(inner_spec)
    return ("pipe",) + inner


def jax_spec_for(
    path: str, shape: Sequence[int], mesh_shape: Dict[str, int], rules: List[Tuple[Pattern, str]], use_fsdp: bool
) -> Tuple:
    """What `cflearn_tpu.parallel.tp.place_params` gives a leaf: the
    pipeline spec, else the TP spec (a stacked leaf on a pipe-less mesh
    matched by its inner shape), else with `use_fsdp` the fsdp spec, else
    replicated (all None)."""
    tp, pipe, fsdp = (mesh_shape.get(a, 1) for a in ("model", "pipe", "fsdp"))
    spec = pp_spec_for(path, shape, pipe, tp, rules)
    if spec is None and tp > 1:
        if _is_pp_block(path):
            inner = tp_spec_for(path, shape[1:], tp, rules) if len(shape) >= 2 else None
            spec = None if inner is None else (None,) + tuple(inner)
        else:
            spec = tp_spec_for(path, shape, tp, rules)
    if spec is None and use_fsdp and fsdp > 1:
        spec = fsdp_param_sharding(mesh_shape, shape)
    return tuple(spec) if spec is not None else (None,) * len(shape)


class ParamPlacement(NamedTuple):
    """One parameter's placement in the port's layout: `spec` names the mesh
    axis of each dimension (None: whole), `kind` the TP rule that placed it,
    `parts` the fused parts of a column shard along its `model` dim, and
    `note` why a rule's split was not taken."""

    spec: Tuple[Any, ...]
    kind: Optional[str] = None
    parts: int = 1
    note: str = ""


def _port_perm(jax_path: str, ndim: int) -> Tuple[int, ...]:
    """For each port axis, its JAX axis."""
    leaf = jax_path.rsplit("/", 2)[-2] if jax_path.endswith("/value") else jax_path.rsplit("/", 1)[-1]
    if leaf != "kernel":
        return tuple(range(ndim))
    if _is_pp_block(jax_path):
        return (0,) + tuple(1 + p for p in _PERM[ndim - 1])
    return _PERM[ndim]


def _heads_of(owner: nn.Module) -> Optional[int]:
    from ..modules.core.attentions import SpatialAttention

    if isinstance(owner, SpatialAttention):
        return 1
    for attr in ("num_heads", "heads"):
        if isinstance(getattr(owner, attr, None), int):
            return getattr(owner, attr)
    return None


def _col_parts(owner_name: str, owner: nn.Module, leaf_module: str) -> int:
    from ..modules.core.attentions import MultiHeadSpatialAttention

    if leaf_module in ("in_proj", "to_qkv"):
        return 1 if isinstance(owner, MultiHeadSpatialAttention) else 3
    if owner_name.endswith("net1") and leaf_module == "net":
        return 2
    return 1


_ATTENTION_LEAVES = ("to_q", "to_k", "to_v", "to_qkv", "in_proj", "q_proj", "k_proj", "v_proj")


def plan_placement(
    model: nn.Module,
    mesh_shape: Dict[str, int],
    *,
    use_fsdp: bool = False,
    tp_rules: Optional[Sequence[Tuple[str, str]]] = None,
) -> Dict[str, ParamPlacement]:
    """{parameter name: `ParamPlacement`} for `model` (a module or an
    `IDLModel`, on any device, "meta" too) on a mesh of `mesh_shape`."""
    from ..bridge import jax_param_names

    mesh_shape = dict(mesh_shape)
    tp = mesh_shape.get("model", 1)
    rules = compile_rules(tp_rules)
    modules = dict(model.named_modules())
    jax_names = jax_param_names(model)
    out: Dict[str, ParamPlacement] = {}
    for name, p in model.named_parameters():
        path = jax_names[name]
        perm = _port_perm(path, p.ndim)
        jax_shape = [0] * p.ndim
        for j, i in enumerate(perm):
            jax_shape[i] = p.shape[j]
        # in the JAX layout (an fsdp tie falls as there), then in the port's
        jspec = jax_spec_for(path, jax_shape, mesh_shape, rules, use_fsdp)
        spec = tuple(jspec[i] for i in perm)
        kind = _rule_kind(path, rules) if "model" in spec else None
        parts, note = 1, ""
        if kind in ("col", "row"):
            mod_name = name.rpartition(".")[0]
            owner_name, _, leaf_module = mod_name.rpartition(".")
            owner = modules.get(owner_name)
            if not isinstance(modules.get(mod_name), nn.Linear):
                note = f"replicated: {type(modules.get(mod_name)).__name__} is not a Linear"
            elif kind == "col":
                parts = _col_parts(owner_name, owner, leaf_module)
                heads = _heads_of(owner) if leaf_module in _ATTENTION_LEAVES else None
                dim = spec.index("model")
                if heads is not None and heads % tp:
                    note = f"replicated: {heads} heads do not divide model={tp}"
                elif p.shape[dim] % (parts * tp):
                    note = f"replicated: {parts} parts of {p.shape[dim]} do not divide model={tp}"
        elif kind == "expert":
            from ..modules.core.mixed_stacks import MoEChannelMixer

            if not isinstance(modules.get(name.rpartition(".")[0]), MoEChannelMixer):
                note = "replicated: not a MoEChannelMixer's expert tensor"
        if note:
            spec = tuple(None if a == "model" else a for a in spec)
            kind, parts = None, 1
        out[name] = ParamPlacement(spec, kind, parts, note)
    # a column-parallel Linear's bias splits with its weight: (..., out) as the weight's (..., out, in)
    for name, pl in list(out.items()):
        bias = name[: -len("weight")] + "bias"
        if pl.kind == "col" and name.endswith(".weight") and bias in out:
            out[bias] = ParamPlacement(pl.spec[:-1], "col", pl.parts)
    # an EMA's shadows split as their parameters do
    from ..modules.common import EMA

    for ema_name, ema in modules.items():
        if not isinstance(ema, EMA):
            continue
        for prefix in [f"{m}." if m else "" for m in modules]:
            if all(f"{prefix}{n}" in out for n in ema._names):
                for n in ema._names:
                    pl = out[f"{prefix}{n}"]
                    if any(a in ("model", "pipe") for a in pl.spec):
                        out[f"{ema_name}.{EMA._key(n)}"] = ParamPlacement(pl.spec, pl.kind, pl.parts)
                break
    return out


def describe_placement(model: nn.Module, mesh: Any, **kwargs: Any) -> List[Tuple[str, str]]:
    """[(parameter name, spec)] of every parameter the plan splits, and of
    every one it keeps whole against a rule (its spec then says why);
    `mesh` is a `Mesh`, a `MeshConfig` over its sizes, or {axis: size}."""
    shape = mesh.shape if isinstance(mesh, Mesh) else dict(mesh)
    out = []
    for name, pl in plan_placement(model, shape, **kwargs).items():
        if pl.note:
            out.append((name, pl.note))
        elif any(a is not None for a in pl.spec):
            out.append((name, f"PartitionSpec{pl.spec}" + (f" parts={pl.parts}" if pl.parts > 1 else "")))
    return out


# execution


class ColumnParallelLinear(Linear):
    """A Linear holding its rows' shard of the output (and of the bias): the
    input enters by `comm.copy_to` (its gradient all-reduced over `model`)."""

    tp_group: Any = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(comm.copy_to(x, self.tp_group))


class RowParallelLinear(Linear):
    """A Linear holding its columns' shard of the input: a whole input is
    cut to this rank's slice (`comm.split_along`), the partial products are
    summed over `model` (`comm.reduce_from`), then the bias is added once."""

    tp_group: Any = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.weight.shape[-1]:
            x = comm.split_along(x, -1, self.tp_group)
        dtype = _promote(x, self.weight)
        out = comm.reduce_from(F.linear(x.to(dtype), self.weight.to(dtype)), self.tp_group)
        return out if self.bias is None else out + self.bias.to(dtype)


_HEAD_ATTRS = ("num_heads", "heads")


def _cut(t: torch.Tensor, dim: int, index: int, parts_of: int, parts: int = 1) -> torch.Tensor:
    """Shard `index` of `parts_of` along `dim`, taken from each of `parts` fused parts."""
    chunks = t.chunk(parts, dim=dim) if parts > 1 else (t,)
    out = []
    for c in chunks:
        step = c.shape[dim] // parts_of
        out.append(c.narrow(dim, index * step, step))
    return torch.cat(out, dim=dim) if parts > 1 else out[0]


def _local_of(full: torch.Tensor, pl: ParamPlacement, mesh_shape: Dict[str, int], coord: Dict[str, int]) -> torch.Tensor:
    t = full
    for dim, axis in enumerate(pl.spec):
        if axis in ("model", "pipe"):
            t = _cut(t, dim, coord[axis], mesh_shape[axis], pl.parts if axis == "model" else 1)
    return t


def local_state_dict(
    full: Dict[str, torch.Tensor], placement: Dict[str, ParamPlacement], mesh: Mesh
) -> Dict[str, torch.Tensor]:
    """This rank's shards of whole tensors (names the plan does not hold pass whole)."""
    return {k: (_local_of(v, placement[k], mesh.shape, mesh.coord) if k in placement else v) for k, v in full.items()}


def place_params(
    model: nn.Module,
    mesh: Mesh,
    *,
    use_fsdp: bool = False,
    tp_rules: Optional[Sequence[Tuple[str, str]]] = None,
) -> Dict[str, ParamPlacement]:
    """Apply the plan of `model` on `mesh` (see the module's docstring);
    returns it and keeps it as `model._placement` (with `model._mesh`)."""
    from ..modules.core.mixed_stacks import MoEChannelMixer

    if getattr(model, "_placement", None) is not None:
        unplace_params(model)
    plan = plan_placement(model, mesh.shape, use_fsdp=use_fsdp, tp_rules=tp_rules)
    modules = dict(model.named_modules())
    tp_group = mesh.group("model")
    tp = mesh.shape["model"]
    restore: Dict[str, Any] = {}
    with torch.no_grad():
        for name, p in _placed_tensors(model, plan):
            pl = plan[name]
            if any(a in ("model", "pipe") for a in pl.spec):
                p.data = _local_of(p.data, pl, mesh.shape, mesh.coord).clone()
            # a pipelined stack runs only the blocks of its stage, so it must know it holds them
            p._pipe_shard = "pipe" in pl.spec
    for name, pl in plan.items():
        if not name.endswith(".weight") or pl.kind not in ("col", "row"):
            continue
        mod_name = name.rpartition(".")[0]
        mod = modules[mod_name]
        restore.setdefault(mod_name, ("class", type(mod)))
        mod.__class__ = ColumnParallelLinear if pl.kind == "col" else RowParallelLinear
        mod.tp_group = tp_group
        owner_name, _, leaf_module = mod_name.rpartition(".")
        owner = modules.get(owner_name)
        if pl.kind == "col" and leaf_module in _ATTENTION_LEAVES and owner is not None:
            for attr in _HEAD_ATTRS:
                if isinstance(getattr(owner, attr, None), int) and f"{owner_name}:{attr}" not in restore:
                    restore[f"{owner_name}:{attr}"] = ("attr", getattr(owner, attr))
                    setattr(owner, attr, getattr(owner, attr) // tp)
    for mod_name, mod in modules.items():
        if isinstance(mod, MoEChannelMixer) and plan[f"{mod_name}.experts_w1"].kind == "expert":
            spec = plan[f"{mod_name}.experts_w1"].spec
            local = mod.experts_w1.shape[spec.index("model")]
            mod.tp_group, mod.expert_offset = tp_group, mesh.coord["model"] * local
            restore[mod_name] = ("moe", None)
    model._placement, model._mesh, model._placement_restore = plan, mesh, restore
    return plan


def _placed_tensors(model: nn.Module, plan: Dict[str, ParamPlacement]) -> List[Tuple[str, torch.Tensor]]:
    """The parameters, and the buffers the plan places (an EMA's shadows)."""
    return list(model.named_parameters()) + [(n, b) for n, b in model.named_buffers() if n in plan]


def gather_state_dict(model: nn.Module, *, include_buffers: bool = True) -> Dict[str, torch.Tensor]:
    """Whole tensors of a placed model's parameters (a collective: every
    rank of the mesh calls it and gets them all), and its buffers."""
    plan: Optional[Dict[str, ParamPlacement]] = getattr(model, "_placement", None)
    states = {k: v.detach() for k, v in model.state_dict().items()} if include_buffers else {}
    if plan is None:
        states.update({k: p.detach() for k, p in model.named_parameters()})
        return states
    mesh: Mesh = model._mesh
    for name, p in _placed_tensors(model, plan):
        t = p.detach()
        pl = plan[name]
        for dim, axis in enumerate(pl.spec):
            if axis == "model":
                chunks = t.chunk(pl.parts, dim=dim) if pl.parts > 1 else (t,)
                t = torch.cat([comm.all_gather_along(c, dim, mesh.group("model")) for c in chunks], dim=dim)
            elif axis == "pipe":
                t = comm.all_gather_along(t, dim, mesh.group("pipe"))
        states[name] = t
    return states


def unplace_params(model: nn.Module) -> None:
    """Undo `place_params`: whole parameters (a collective), the Linears'
    classes, the heads and the experts as they were."""
    plan = getattr(model, "_placement", None)
    if plan is None:
        return
    full = gather_state_dict(model, include_buffers=False)
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, p in _placed_tensors(model, plan):
            p.data = full[name].clone()
            p._pipe_shard = False
    for key, (what, value) in model._placement_restore.items():
        if what == "class":
            modules[key].__class__ = value
            del modules[key].tp_group
        elif what == "attr":
            owner_name, attr = key.split(":")
            setattr(modules[owner_name], attr, value)
        else:
            modules[key].tp_group, modules[key].expert_offset = None, 0
    model._placement = model._mesh = model._placement_restore = None


def is_placed(model: nn.Module) -> bool:
    return getattr(model, "_placement", None) is not None
