"""Pipeline parallelism (counterpart of `cflearn_tpu/parallel/pp.py`):
GPipe over the mesh's `pipe` axis, one process per stage.

A stack of L structurally equal blocks is held as one template module
whose every parameter leads with the block axis (`stack_module_states`,
the layout of the JAX package's `pp_block`); on a mesh with `pipe` = S
each rank holds L / S consecutive blocks (`parallel.tp.place_params`
splits the leading axis). `pipeline_apply(block_fn, stacked, x, mesh=...)`
splits the batch into M microbatches (default S) and runs M + S - 1 ticks:
at tick t, stage s runs microbatch t - s through its blocks, taking it
from stage s - 1 by a point-to-point receive (stage 0 from x) and sending
its output on to stage s + 1; the last stage's outputs are broadcast to
every stage (the input and the output stay replicated over `pipe`, as
GSPMD leaves them). The backward (`_Pipeline`) runs the ticks in reverse:
each stage receives its output's gradient from the next, computes its
blocks again from the input it kept (GPipe's recomputation) under
autograd, sends the input's gradient to the previous stage and keeps its
blocks' gradients; stage 0 broadcasts the batch's gradient. With `mesh`
None, or a pipe axis of 1, the blocks run one after another on the whole
batch under plain autograd.

`with_aux=True`: `block_fn` returns (h, aux scalar) and the call (out,
aux): the blocks' objectives (the MoE balance loss) summed over the blocks
of each microbatch and averaged over the microbatches, as the JAX pipeline
does (the sequential path sums over the blocks on the whole batch). Under
the pipeline a MoE router's capacity and statistic are those of a
microbatch, as in the JAX package. Dropout inside the blocks draws again
in the recomputation: run pipelined stacks without it (the JAX package
says the same)."""

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from . import comm

def stack_module_states(modules: Sequence[nn.Module]) -> Tuple[nn.Module, Dict[str, nn.Parameter]]:
    """`modules[0]` made the template of the stack: each of its parameters
    replaced by one that leads with the block axis (block i's values at
    [i]; `init_parameters` draws each block's slice as its own parameter
    under a `pp_block` name). Returns (template, its stacked parameters by
    name)."""
    template = modules[0]
    per_block = [dict(m.named_parameters()) for m in modules]
    owners = dict(template.named_modules())
    out: Dict[str, nn.Parameter] = {}
    for name in per_block[0]:
        stacked = nn.Parameter(torch.stack([p[name].detach() for p in per_block]))
        owner, _, leaf = name.rpartition(".")
        setattr(owners[owner], leaf, stacked)
        out[name] = stacked
    return template, out


def _run_blocks(
    block_fn: Callable[..., Any], names: List[str], params: Sequence[torch.Tensor], h: torch.Tensor, with_aux: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    aux = h.new_zeros((), dtype=torch.float32)
    for i in range(params[0].shape[0] if params else 0):
        out = block_fn({n: p[i] for n, p in zip(names, params)}, h)
        if with_aux:
            h, a = out
            aux = aux + a.float()
        else:
            h = out
    return h, aux


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, block_fn, names, mesh, m, with_aux, *params):  # type: ignore[override]
        group = mesh.group("pipe")
        ranks = mesh.ranks("pipe")
        s, n_stage = mesh.coord["pipe"], mesh.shape["pipe"]
        xs = x.chunk(m)
        inputs: Dict[int, torch.Tensor] = {}
        outs: List[Optional[torch.Tensor]] = [None] * m
        aux = x.new_zeros((), dtype=torch.float32)
        with torch.no_grad():
            for t in range(m + n_stage - 1):
                mb = t - s
                if not 0 <= mb < m:
                    continue
                if s == 0:
                    h = xs[mb]
                else:
                    h = torch.empty_like(xs[mb])
                    dist.recv(h, ranks[s - 1], group=group)
                inputs[mb] = h
                h, a = _run_blocks(block_fn, names, params, h, with_aux)
                aux = aux + a
                h = h.to(x.dtype).contiguous()
                if s < n_stage - 1:
                    dist.send(h, ranks[s + 1], group=group)
                else:
                    outs[mb] = h
            out = torch.cat(outs) if s == n_stage - 1 else torch.empty_like(x)
            dist.broadcast(out, ranks[-1], group=group)
            aux = comm.all_reduce_sum(aux, group) / m
        ctx.block_fn, ctx.names, ctx.mesh, ctx.m, ctx.with_aux = block_fn, names, mesh, m, with_aux
        ctx.inputs = inputs
        ctx.save_for_backward(*params)
        ctx.x_meta = (x.shape, x.dtype)
        return out, aux

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out, g_aux):  # type: ignore[override]
        mesh, m = ctx.mesh, ctx.m
        params = ctx.saved_tensors
        group, ranks = mesh.group("pipe"), mesh.ranks("pipe")
        s, n_stage = mesh.coord["pipe"], mesh.shape["pipe"]
        g_outs = g_out.chunk(m) if g_out is not None else None
        grads = [torch.zeros_like(p) for p in params]
        dxs: List[Optional[torch.Tensor]] = [None] * m
        aux_weight = (g_aux if g_aux is not None else torch.zeros(())).float() / m
        for t in reversed(range(m + n_stage - 1)):
            mb = t - s
            if not 0 <= mb < m:
                continue
            h_in = ctx.inputs[mb]
            if s == n_stage - 1:
                g = g_outs[mb] if g_outs is not None else torch.zeros_like(h_in)
            else:
                g = torch.empty_like(h_in)
                dist.recv(g, ranks[s + 1], group=group)
            with torch.enable_grad():
                h = h_in.detach().requires_grad_(True)
                ps = [p.detach().requires_grad_(p.requires_grad) for p in params]
                out, aux = _run_blocks(ctx.block_fn, ctx.names, ps, h, ctx.with_aux)
                leaves = [h] + [p for p in ps if p.requires_grad]
                targets, grad_targets = [out.to(h.dtype)], [g]
                if ctx.with_aux and aux.requires_grad:
                    targets.append(aux)
                    grad_targets.append(aux_weight.to(aux.device))
                got = torch.autograd.grad(targets, leaves, grad_targets, allow_unused=True)
            dh = got[0] if got[0] is not None else torch.zeros_like(h_in)
            it = iter(got[1:])
            for i, p in enumerate(ps):
                if p.requires_grad:
                    gp = next(it)
                    if gp is not None:
                        grads[i] += gp
            if s > 0:
                dist.send(dh.contiguous(), ranks[s - 1], group=group)
            else:
                dxs[mb] = dh
        x_shape, x_dtype = ctx.x_meta
        dx = torch.cat(dxs) if s == 0 else torch.empty(x_shape, dtype=x_dtype, device=params[0].device)
        dist.broadcast(dx, ranks[0], group=group)
        ctx.inputs = None
        return (dx, None, None, None, None, None, *grads)


def pipeline_apply(
    block_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor], Any],
    stacked_params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    mesh: Any = None,
    num_microbatches: Optional[int] = None,
    with_aux: bool = False,
) -> Any:
    """Run `x` (the whole batch, (B, ...)) through the stacked blocks,
    pipelined over `mesh`'s `pipe` axis (see the module's docstring).
    `block_fn(params_i, h)` applies one block to h from its parameters
    {name: tensor}; `stacked_params` are this rank's stacked tensors."""
    names = list(stacked_params)
    params = [stacked_params[n] for n in names]
    pp = mesh.shape.get("pipe", 1) if mesh is not None else 1
    if pp <= 1:
        h, aux = _run_blocks(block_fn, names, params, x, with_aux)
        return (h, aux) if with_aux else h
    m = num_microbatches or pp
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by num_microbatches={m}")
    out, aux = _Pipeline.apply(x, block_fn, names, mesh, m, with_aux, *params)
    return (out, aux) if with_aux else out
