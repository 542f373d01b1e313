"""Context-parallel attention (counterpart of
`cflearn_tpu/ops/ring_attention.py`): the sequence split over the mesh's
`context` axis, one process per rank.

`ring_attention(q, k, v, group=...)` takes this rank's shards (B, H, L/cp,
D). Each of cp steps attends the local q to one kv block, then passes the
block to the next rank of the ring (`batch_isend_irecv`, started before
the block is attended and awaited after it), so every block visits every
rank. A block runs the flash forward with its logsumexp
(`ops.attention.flash_fwd_lse`, the TPU's `_flash_fwd_kernel`) and the
partial results merge by their logsumexp in f32 (`ring_merge`). With
`causal`, this rank's own block is causal, earlier blocks are whole and
later ones are skipped (the JAX ring masks them to nothing, which is the
same). The backward (`_RingAttention`) runs the ring again with the fused
flash backward (`flash_bwd_fused`, the TPU's `_flash_bwd_fused_kernel`) on
each block, from the merged output and the global logsumexp, so its delta
is the global one: dq sums locally, dk and dv sum in f32 and travel with
their block back to its owner. A block takes the kernels where
`ops.attention.use_kernel` sends `sdp_attn` to them (and on a CPU tensor
the kernels' plain versions, as every wrapper does), else the plain
functions; `plain=True` takes the plain functions for every block (the
reference the chip's check holds the kernels to).

`ring_block_fwd`, `ring_merge` and `ring_block_bwd` are one block's forward,
the merge and one block's backward as plain functions on tensors.
`ring_forward` and `ring_backward` are one rank's loops over them, and take
the ring as an object (`GroupRing`: the process group's ranks and its
point-to-point sends), so that cp ranks that are threads of one process,
with a ring of queues, run the same loops (what the card's check does,
with no second card).

`ulysses_attention` re-shards from the sequence to the heads with one
differentiable all-to-all (`parallel.comm.all_to_all_along`), runs the
port's attention over the whole sequence on H/cp heads (the kernels'
route), and re-shards back. `context_parallel_attention(q, k, v, mesh)`
takes whole (replicated) tensors, cuts this rank's slice of the sequence,
runs the ring or Ulysses ("auto": Ulysses where the heads divide the axis)
and gathers the output along the sequence, both differentiably: what
`ops.attention.sdp_attn` calls on a mesh with a `context` axis."""

import math
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel import comm
from .attention import (
    flash_bwd_fused,
    flash_bwd_plain,
    flash_fwd_lse,
    flash_fwd_with_lse_plain,
    use_kernel,
)


def ring_block_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, sm_scale: float, plain: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of q against one kv block: the flash forward with its
    logsumexp where `use_kernel` routes there, else its plain version."""
    if not plain and use_kernel(q, k):
        return flash_fwd_lse(q, k, v, causal=causal, sm_scale=sm_scale)
    return flash_fwd_with_lse_plain(q, k, v, causal=causal, sm_scale=sm_scale)


def ring_merge(
    o: Optional[torch.Tensor], lse: Optional[torch.Tensor], o_blk: torch.Tensor, lse_blk: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a block's (o, lse) into the running (f32 o, lse) by their
    logsumexp: o = sum_i exp(lse_i - lse) o_i, lse = logaddexp of the lse_i."""
    o_blk = o_blk.float()
    if o is None:
        return o_blk, lse_blk
    new = torch.logaddexp(lse, lse_blk)
    o = o * torch.exp(lse - new).unsqueeze(-1) + o_blk * torch.exp(lse_blk - new).unsqueeze(-1)
    return o, new


def ring_block_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool,
    sm_scale: float,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of one block from the merged o and the global lse: the
    fused flash backward where `use_kernel` routes there, else its plain
    version."""
    if not plain and use_kernel(q, k):
        return flash_bwd_fused(q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale)
    return flash_bwd_plain(q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale)


def _visits(rank: int, cp: int, causal: bool) -> List[Tuple[int, int]]:
    """(step, owner of the block this rank holds at that step) of the blocks it attends."""
    out = []
    for step in range(cp):
        owner = (rank - step) % cp
        if not (causal and owner > rank):
            out.append((step, owner))
    return out


class GroupRing:
    """The ring of `group`'s ranks, as `ring_forward` and `ring_backward`
    use it: this rank's place (`index` of `size`), and `start` / `wait`,
    which send tensors to the next rank and take the previous one's
    (`batch_isend_irecv`)."""

    def __init__(self, group: Any) -> None:
        self.group = group
        self.ranks = dist.get_process_group_ranks(group)
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())

    def start(self, tensors: List[torch.Tensor]) -> Tuple[list, list]:
        """Start sending `tensors` on and taking the previous rank's: (requests, the buffers that will hold them)."""
        nxt, prv = self.ranks[(self.index + 1) % self.size], self.ranks[(self.index - 1) % self.size]
        recv = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, self.group) for t in tensors]
        ops += [dist.P2POp(dist.irecv, r, prv, self.group) for r in recv]
        return dist.batch_isend_irecv(ops), recv

    def wait(self, pending: Tuple[list, list]) -> List[torch.Tensor]:
        reqs, recv = pending
        for req in reqs:
            req.wait()
        return recv


def ring_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring: Any, *, causal: bool, sm_scale: float, plain: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's forward over `ring` (a `GroupRing`, or anything with its
    `index`, `size`, `start` and `wait`): (o in q's dtype, the global lse)."""
    cp, index = ring.size, ring.index
    visits = dict(_visits(index, cp, causal))
    o = lse = None
    cur = [k, v]
    for step in range(cp):
        # the next block travels while this one is attended
        pending = ring.start(cur) if step < cp - 1 else None
        if step in visits:
            o_blk, lse_blk = ring_block_fwd(
                q, cur[0], cur[1], causal=causal and visits[step] == index, sm_scale=sm_scale, plain=plain
            )
            o, lse = ring_merge(o, lse, o_blk, lse_blk)
        cur = ring.wait(pending) if pending is not None else None
    return o.to(q.dtype), lse


def ring_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    ring: Any,
    *,
    causal: bool,
    sm_scale: float,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One rank's backward over `ring` from `ring_forward`'s (o, lse): (dq,
    dk, dv) of this rank's shards, in their dtypes."""
    cp, index = ring.size, ring.index
    visits = dict(_visits(index, cp, causal))
    do = do.contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    cur_k, cur_v = k, v
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for step in range(cp):
        if step in visits:
            dq_b, dk_b, dv_b = ring_block_bwd(
                q, cur_k, cur_v, o, lse, do, causal=causal and visits[step] == index, sm_scale=sm_scale, plain=plain
            )
            dq += dq_b.float()
            dk += dk_b.float()
            dv += dv_b.float()
        # the block's gradients travel with it; after the last step they reach its owner
        if step < cp - 1:
            cur_k, cur_v, dk, dv = ring.wait(ring.start([cur_k, cur_v, dk, dv]))
        else:
            dk, dv = ring.wait(ring.start([dk, dv]))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, causal, sm_scale, plain):  # type: ignore[override]
        o, lse = ring_forward(q, k, v, ring, causal=causal, sm_scale=sm_scale, plain=plain)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (ring, causal, sm_scale, plain)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):  # type: ignore[override]
        q, k, v, o, lse = ctx.saved_tensors
        ring, causal, sm_scale, plain = ctx.args
        grads = ring_backward(q, k, v, o, lse, do, ring, causal=causal, sm_scale=sm_scale, plain=plain)
        return (*grads, None, None, None, None)


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: Any = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    plain: bool = False,
) -> torch.Tensor:
    """Attention of this rank's sequence shards (B, H, L/cp, D) over the
    ring of `group` (the mesh's `context` group); its shard of the output."""
    if comm.group_size(group) == 1:
        return _local_attention(q, k, v, causal, _scale(q, sm_scale), plain)
    return _RingAttention.apply(q, k, v, GroupRing(group), causal, _scale(q, sm_scale), plain)


def _local_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, sm_scale: float, plain: bool
) -> torch.Tensor:
    from .attention import flash_attention_plain, local_sdp_attn

    if plain:
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    return local_sdp_attn(q, k, v, causal=causal, sm_scale=sm_scale)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group: Any = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Ulysses attention of this rank's sequence shards: heads <-> sequence
    by one all-to-all each way around the port's attention on H/cp heads
    and the whole sequence. The heads must divide the group."""
    from .attention import local_sdp_attn

    cp = comm.group_size(group)
    if q.shape[1] % cp:
        raise ValueError(f"ulysses needs heads ({q.shape[1]}) divisible by the context axis ({cp})")
    qh, kh, vh = (comm.all_to_all_along(t, 1, 2, group) for t in (q, k, v))
    out = local_sdp_attn(qh, kh, vh, causal=causal, sm_scale=sm_scale)
    return comm.all_to_all_along(out, 2, 1, group)


def context_parallel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Any,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    method: str = "auto",
) -> torch.Tensor:
    """Attention of whole (B, H, L, D) tensors, replicated over `mesh`'s
    `context` axis, with the sequence split over it: "ring" (any head
    count), "ulysses" (heads divisible by the axis) or "auto" (Ulysses
    where the heads divide, else the ring). Returns the whole output on
    every rank."""
    cp = mesh.shape["context"]
    if method == "auto":
        method = "ulysses" if q.shape[1] % cp == 0 else "ring"
    if method == "ulysses" and q.shape[1] % cp != 0:
        raise ValueError(f"ulysses needs heads ({q.shape[1]}) divisible by the context axis ({cp})")
    group = mesh.group("context")
    qs, ks, vs = (comm.split_along(t, 2, group) for t in (q, k, v))
    inner = ulysses_attention if method == "ulysses" else ring_attention
    return comm.gather_along(inner(qs, ks, vs, group=group, causal=causal, sm_scale=sm_scale), 2, group)
