"""Attention ops: the flash-attention CUDA kernels and the dispatcher.

Counterpart of `cflearn_tpu/ops/attention.py`:

* `flash_attention` — wrapper of the hand-written Hopper forward kernel
  (`csrc/flash_attention.cu`), which replaces the TPU's `_flash_kernel`.
* `flash_fwd_lse` — the same forward that also returns the per-row
  logsumexp (`csrc/flash_fwd_lse.cu`, the TPU's `_flash_fwd_kernel`).
* `flash_plan` — which forward kernel runs and with what tiles: the wgmma +
  TMA kernel (`csrc/flash_fwd_sm90.cuh`) for bf16 / fp16 with d <= 256, the
  wide-head wgmma + TMA kernel (`csrc/flash_fwd_sm90_wide.cuh`) for bf16 /
  fp16 with 256 < d <= 512 (the autoencoders' mid-block attention), the
  mma.sync kernels (`csrc/flash_fwd.cuh`) for the rest, or for any shape
  when a caller names them (`kernel="mma_sync"`).
* `flash_bwd_fused`, `flash_bwd_dq`, `flash_bwd_dkv` — the backward kernels
  (`csrc/flash_bwd_*.cu`; the TPU's `_flash_bwd_fused_kernel`,
  `_flash_bwd_dq_kernel`, `_flash_bwd_dkv_kernel`).
* `flash_bwd_plan` — which backward kernel runs and with what tiles: the
  wgmma + TMA kernels (`csrc/flash_bwd_sm90.cuh`) for bf16 / fp16 with
  d <= 128 (d <= 192 for dq), the mma.sync kernel (`csrc/flash_bwd.cuh`)
  for the rest, or for any shape when a caller names it
  (`kernel="mma_sync"`).
* `flash_attention_op`, `flash_fwd_lse_op` — the two forwards as
  operations of PyTorch's dispatcher (`torch.library.custom_op`): the plain
  version registered for the CPU, the kernel for CUDA, and a fake
  implementation for tracing, so that `torch.export` keeps them in its
  graph on either device and a selective-checkpoint policy can keep their
  outputs. Each implementation calls the wrapper, `flash_attention` or
  `flash_fwd_lse`. The modules' route calls `flash_fwd_lse_op` where a
  gradient is carried; the inference forward calls its operation only under
  a trace, and the wrapper itself in an eager call.
* `flash_attention_trainable` — the `torch.autograd.Function` over them
  (the JAX package's custom VJP of the same name).
* `xla_attention` — what the JAX package leaves to XLA (masks, biases, short
  kv such as SD cross-attention at kv = 77); here PyTorch's FlashAttention-2
  forward by name where it takes the inputs on the card, else
  `F.scaled_dot_product_attention`.
* `sdp_attn` — the dispatcher: on a mesh with a `context` axis (the
  ambient `parallel.mesh.get_active_context_mesh()`), a self-attention-shaped
  call (q_len == kv_len, divisible by the axis, no mask or bias) goes to
  `ops.ring_attention.context_parallel_attention`, as the JAX package
  routes it; otherwise `local_sdp_attn`, with the JAX package's
  `_use_pallas` shape predicate.

Every kernel wrapper runs its plain PyTorch version (`*_plain`, the same
arithmetic) on a CPU tensor; on a CUDA tensor it launches the kernel or
raises, and counts the launch in its `launches` attribute. The kernels take
bf16, fp16 and f32 (f32 products run as three TF32 products on split
operands, 3xTF32, to f32 accuracy; sums are f32), D % 8 == 0 and D <= 1024.

Layout is (B, H, L, D) throughout.
"""

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import SM_COUNT, sm_count
from . import _native

_NEG_INF = -1.0e30
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
MAX_HEAD_DIM = 1024
# mirrors the JAX package's `_FUSED_BWD`: False selects the split dq / dk.dv
# kernels, as `torch.use_deterministic_algorithms(True)` does
FUSED_BWD = True


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


def _keep_mask(q_len: int, kv_len: int, device: torch.device) -> torch.Tensor:
    q_pos = torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    return k_pos <= q_pos


def flash_fwd_with_lse_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels' function in plain PyTorch: f32 scores, masked
    entries at -1e30 (causal: k > q), P cast to the value dtype before P.V
    with f32 accumulation, o = acc / max(l, 1e-30) and
    lse = m + log(max(l, 1e-30)) as (B, H, Lq) f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(q.shape[-1], sm_scale)
    if causal:
        s = torch.where(_keep_mask(q.shape[-2], k.shape[-2], q.device), s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """`flash_fwd_with_lse_plain` without the logsumexp."""
    return flash_fwd_with_lse_plain(q, k, v, causal=causal, sm_scale=sm_scale)[0]


def flash_fwd_split_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    splits: int,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The arithmetic of the wide-head kernel's split kv range
    (`csrc/flash_fwd_sm90_wide.cuh`) in plain PyTorch, for the tests: each
    64-row q tile's kv blocks of `SM90_WIDE_BK` rows (with `causal`, those up
    to the tile's last row) cut into `splits` parts of ceil(blocks / splits);
    each part's f32 m_s (row max), l_s (row sum) and acc_s = cast(exp(s -
    m_s)) V;
    then M = max m_s, w_s = exp(m_s - M), o = (sum w_s acc_s) / max(sum w_s
    l_s, 1e-30) cast once and lse = M + log(max(sum w_s l_s, 1e-30)), the
    parts summed in order. A part without blocks has m = -1e30, l = acc = 0.
    Returns (o, lse) as `flash_fwd_with_lse_plain` does."""
    scale, bk = _scale(q.shape[-1], sm_scale), SM90_WIDE_BK
    lq, lk = q.shape[-2], k.shape[-2]
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    for q0 in range(0, lq, 64):
        rows = slice(q0, min(q0 + 64, lq))
        n_kb = _cdiv(lk, bk)
        if causal:
            n_kb = min(n_kb, (q0 + 63) // bk + 1)
        per = _cdiv(n_kb, splits)
        parts = []
        for sp in range(splits):
            k0, k1 = sp * per * bk, min(n_kb, (sp + 1) * per) * bk
            shape = q.shape[:-2] + (rows.stop - q0,)
            if k0 >= k1:
                parts.append((torch.full(shape, _NEG_INF, device=q.device), torch.zeros(shape, device=q.device),
                              torch.zeros(shape + (v.shape[-1],), device=q.device)))
                continue
            k1 = min(k1, lk)
            s = torch.matmul(qf[..., rows, :], kf[..., k0:k1, :].transpose(-1, -2)) * scale
            if causal:
                keep = (torch.arange(k0, k1, device=q.device)[None, :]
                        <= torch.arange(q0, rows.stop, device=q.device)[:, None])
                s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
            m = s.amax(dim=-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(dim=-1), torch.matmul(p.to(v.dtype).float(), vf[..., k0:k1, :])))
        big = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        l, acc = 0.0, 0.0
        for m, l_s, acc_s in parts:
            w = torch.exp(m - big)
            l = l + w * l_s
            acc = acc + w[..., None] * acc_s
        l = l.clamp_min(1e-30)
        o[..., rows, :] = (acc / l[..., None]).to(q.dtype)
        lse[..., rows] = big + torch.log(l)
    return o, lse


def flash_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch, written out from
    their formulas (not autograd of the forward): p = exp(s - lse) with
    masked entries 0, dv = cast(p)^T dO, dp = dO v^T, ds = p (dp - delta)
    with delta = rowsum(dO * O) in f32, dk = scale * cast(ds)^T q and
    dq = scale * cast(ds) k; p is cast to dO's dtype and ds to q's before
    their products, and every sum is f32."""
    scale = _scale(q.shape[-1], sm_scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    if causal:
        p = torch.where(_keep_mask(q.shape[-2], k.shape[-2], q.device), p, torch.zeros_like(p))
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)).to(q.dtype).float()
    dk = scale * torch.matmul(ds.transpose(-1, -2), qf)
    dq = scale * torch.matmul(ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """A (B, H, L, D) view the kernels can read: contiguous D, B/H/L strides
    positive and 16-byte multiples, base address 16-byte aligned (what TMA
    asks of a tensor map); otherwise a contiguous copy."""
    ok = (
        t.stride(-1) == 1
        and all(s > 0 and s % 8 == 0 for s in t.stride()[:-1])
        and t.data_ptr() % 16 == 0
    )
    return t if ok else t.contiguous()


# ---- the forward kernels' planner ----

SMEM_MAX = 232448  # the most dynamic shared memory a block can have on sm_90
TMA_BOX_MAX = 256  # the largest extent of a TMA box in any dimension
BOX_COLS = 64  # head-dim columns per TMA box: 128 bytes of 16-bit values, the 128-byte swizzle's row
SWIZZLE_BYTES = 128
SM90_MAX_STAGES = 4  # the K / V ring's barriers are sized for this many stages
_SM90_BARRIER_BYTES = 8 * (1 + 4 * SM90_MAX_STAGES)
_KERNEL_CODES = {"mma_sync": 0, "mma_sync_chunked": 0, "sm90": 1, "sm90_wide": 2}
# the sm90 kernel's instantiated steps of 16 over the head dim (`dispatch_sm90`); 16 with one consumer only
SM90_KSTEPS = (2, 3, 4, 5, 6, 8, 10, 12, 16)
# the planner's estimate of how much faster a CTA of three consumer warpgroups computes its q rows than one
# of two at d <= 64, where the softmax binds and a third warpgroup hides more of its latency (H100)
_THREE_CONSUMER_RATE = 1.2
# the wide-head kernel (`csrc/flash_fwd_sm90_wide.cuh`, bf16 / fp16, 256 < d <= 512): two consumer warpgroups on
# the same 64 q rows, each with one half of the head dim; its instantiated steps of 16 over the head dim (two
# halves of 12 or 16 steps, `dispatch_wide`), kv rows a block (one K and one V block of 64 rows fit beside the
# 64 KB q tile), the registers `setmaxnreg` gives the producer and each consumer, and the most parts a kv range
# is split into where the grid's tiles fill less than one wave of SMs
SM90_WIDE_KSTEPS = (24, 32)
SM90_WIDE_BK = 64
SM90_WIDE_REGS = (24, 240)
SM90_WIDE_MAX_SPLITS = 4
_WIDE_MIN_SPLIT_BLOCKS = 4  # kv blocks a part keeps at least


class FlashPlan(NamedTuple):
    kernel: str  # "sm90", "sm90_wide" (wgmma + TMA), "mma_sync" or "mma_sync_chunked" (`flash_fwd.cuh`)
    bq: int  # q rows per CTA
    bk: int  # kv rows per block
    stages: int  # K / V ring stages (the mma.sync kernels: 2 = double-buffered, 1 = single)
    consumers: int  # sm90: consumer warpgroups of 64 q rows (2, 3 = ping-pong); sm90_wide: 2 on the same rows; else 0
    head_pad: int  # the head dim as shared memory holds it: whole 64-column boxes (sm90*), or the kernel's DP
    ksteps: int  # sm90*: steps of 16 over the head dim in S = Q K^T (zero columns past d); else 0
    boxes: Tuple[Tuple[int, int], ...]  # sm90*: TMA boxes (columns, rows) of q and of k / v; else ()
    swizzle: int  # bytes of the shared-memory swizzle (sm90*); 0 for the cp.async kernels
    smem: int  # dynamic shared memory bytes of a CTA
    ctas: int  # CTAs of the grid
    splits: int = 1  # sm90_wide: parts of each tile's kv blocks, combined by a second launch; else 1


def _sm90_smem(slabs: int, bq: int, bk: int, stages: int) -> int:
    """`sm90_smem` of `csrc/flash_fwd_sm90.cuh`: 1024 bytes of alignment
    slack, the q tile, the K and V rings, the barriers."""
    return 1024 + slabs * SWIZZLE_BYTES * (bq + 2 * stages * bk) + _SM90_BARRIER_BYTES


def _wide_smem(slabs: int) -> int:
    """`wide_smem` of `csrc/flash_fwd_sm90_wide.cuh`: the alignment slack,
    the 64-row q tile, one K and one V block of 64 rows, the two consumers'
    partial S tiles (64 x 64 f32 each), five barriers."""
    return 1024 + slabs * SWIZZLE_BYTES * 64 * 3 + 2 * 64 * 64 * 4 + 5 * 8


def _mma_sync_tiles(d: int, size: int) -> Tuple[str, int, int, int, int, int]:
    """(kernel, bq, bk, stages, head_pad, smem) of the mma.sync kernel that
    `flash_fwd.cuh`'s `dispatch` launches for head dim d and element size."""
    if size == 4 or d > 512:  # the chunked kernel: 64 q rows, one chunk of DC columns a CTA
        dc = 64 if size == 4 and d <= 64 else 128
        pad = 4 if size == 4 else 8
        smem = 3 * 64 * (dc + pad) * size + 64 * (64 + pad) * size
        return "mma_sync_chunked", 64, 64, 1, dc, smem
    dp, wq, wd, stages = next(t for t in ((32, 4, 1, 2), (48, 4, 1, 2), (64, 4, 1, 2), (80, 4, 1, 2),
                                          (128, 4, 1, 2), (160, 4, 1, 2), (256, 2, 2, 2), (512, 1, 4, 1))
                              if d <= t[0])
    bq, bk, ld = 16 * wq, 64, dp + 8
    smem = bq * ld * 2 + 2 * stages * bk * ld * 2 + (bq * (bk + 4) * 4 if wd > 1 else 0)
    return "mma_sync", bq, bk, stages, dp, smem


@functools.lru_cache(maxsize=1024)
def flash_plan(
    b: int, h: int, lq: int, lk: int, d: int, dtype: torch.dtype, sms: int = SM_COUNT, kernel: Optional[str] = None
) -> FlashPlan:
    """The forward kernel and its tiles at q (b, h, lq, d), k / v (b, h, lk, d).

    bf16 / fp16 with d <= 256 take the wgmma + TMA kernel: S = Q K^T in the
    fewest instantiated steps of 16 (`SM90_KSTEPS`) that cover d, 64-column
    boxes over those, kv blocks of 128 rows while S and the P.V accumulator
    fit the registers side by side (d <= 128) and 64 beyond,
    two consumer warpgroups (128 q rows, ping-pong) unless that grid would
    leave more than half the SMs idle (then one, 64 rows), three (192 rows)
    at d <= 64 where their waves of CTAs finish sooner, and as many ring
    stages (2..4) as shared memory holds. bf16 / fp16 with 256 < d <= 512
    take the wide-head kernel: 64 q rows a CTA, two consumers with a half of
    the head dim each (`SM90_WIDE_KSTEPS` steps in all), one K and one V
    block of `SM90_WIDE_BK` rows, and where the tiles fill less than one
    wave of `sms`, the kv blocks split into as many parts (at most
    `SM90_WIDE_MAX_SPLITS`, each of at least four blocks) as fill it. f32,
    d > 512, and `kernel="mma_sync"` take the mma.sync kernels
    (`mma_sync_chunked` for f32 and d > 512)."""
    if kernel not in (None, "sm90", "sm90_wide", "mma_sync"):
        raise ValueError(f"flash_plan: kernel {kernel!r} is not 'sm90', 'sm90_wide' or 'mma_sync'")
    size = torch.empty((), dtype=dtype).element_size()
    half = dtype in (torch.bfloat16, torch.float16) and d % 8 == 0
    sm90_ok = half and d <= 256
    wide_ok = half and 256 < d <= 512
    if kernel == "sm90" and not sm90_ok:
        raise ValueError(f"flash_plan: the sm90 kernel takes bf16 / fp16 with 8 | d <= 256; got {dtype}, d={d}")
    if kernel == "sm90_wide" and not wide_ok:
        raise ValueError(f"flash_plan: the sm90_wide kernel takes bf16 / fp16 with 8 | d, 256 < d <= 512; "
                         f"got {dtype}, d={d}")
    if kernel != "mma_sync" and wide_ok:
        ksteps = next(k for k in SM90_WIDE_KSTEPS if 16 * k >= d)
        slabs = 16 * ksteps // BOX_COLS
        tiles = _cdiv(lq, 64) * b * h
        splits = 1
        if tiles < sms:
            splits = max(1, min(SM90_WIDE_MAX_SPLITS, sms // tiles, _cdiv(lk, SM90_WIDE_BK) // _WIDE_MIN_SPLIT_BLOCKS))
        return FlashPlan("sm90_wide", 64, SM90_WIDE_BK, 1, 2, BOX_COLS * slabs, ksteps,
                         ((BOX_COLS, 64), (BOX_COLS, SM90_WIDE_BK)), SWIZZLE_BYTES, _wide_smem(slabs), tiles * splits,
                         splits)
    if kernel == "mma_sync" or not sm90_ok:
        name, bq, bk, stages, pad, smem = _mma_sync_tiles(d, size)
        grid = _cdiv(lq, bq) * b * h * (_cdiv(d, pad) if name == "mma_sync_chunked" else 1)
        return FlashPlan(name, bq, bk, stages, 0, pad, 0, (), 0, smem, grid)
    ksteps = next(k for k in SM90_KSTEPS if 16 * k >= d)
    slabs = _cdiv(16 * ksteps, BOX_COLS)
    bk = 128 if slabs <= 2 else 64
    consumers = 2 if ksteps < 16 and 2 * _cdiv(lq, 128) * b * h > sms else 1
    if consumers == 2 and slabs == 1:
        # three consumers where their waves of CTAs take less time than two's
        waves = {c: _cdiv(_cdiv(lq, 64 * c) * b * h, sms) for c in (2, 3)}
        if waves[3] * 3 / _THREE_CONSUMER_RATE < waves[2] * 2:
            consumers = 3
    bq = 64 * consumers
    stages = max(s for s in range(2, SM90_MAX_STAGES + 1) if _sm90_smem(slabs, bq, bk, s) <= SMEM_MAX)
    return FlashPlan("sm90", bq, bk, stages, consumers, BOX_COLS * slabs, ksteps, ((BOX_COLS, bq), (BOX_COLS, bk)),
                     SWIZZLE_BYTES, _sm90_smem(slabs, bq, bk, stages), _cdiv(lq, bq) * b * h)


# ---- the backward kernels' planner ----

BWD_MODES = ("fused", "dq", "dkv")
# the largest head dim whose sums the wgmma + TMA backward kernels hold in registers: a kv-outer consumer
# (fused, dkv) holds dK and dV, the dq kernel dQ alone (`csrc/flash_bwd_sm90.cuh`)
SM90_BWD_MAX_D = {"fused": 128, "dkv": 128, "dq": 192}
# their instantiated steps of 16 over the head dim (`dispatch_bwd_sm90`)
SM90_BWD_KSTEPS = {"fused": (2, 3, 4, 5, 6, 8), "dkv": (2, 3, 4, 5, 6, 8), "dq": (2, 3, 4, 5, 6, 8, 10, 12)}
BWD_Q_TILE = 64  # q rows of a tile that a kv-outer CTA walks
_BWD_BARRIER_BYTES = 8 * (1 + 2 * SM90_MAX_STAGES)
_BWD_TILE = 64  # the mma.sync kernel's rows of an outer and of an inner tile (`flash_bwd.cuh`)


class FlashBwdPlan(NamedTuple):
    kernel: str  # "sm90" (wgmma + TMA, `flash_bwd_sm90.cuh`) or "mma_sync" (`flash_bwd.cuh`)
    mode: str  # "fused", "dq" or "dkv"
    outer: int  # rows a CTA owns: kv rows (fused, dkv) or q rows (dq)
    inner: int  # rows of each tile its loop walks: q rows (fused, dkv) or kv rows (dq)
    consumers: int  # sm90: consumer warpgroups of 64 outer rows; mma_sync: 0
    stages: int  # sm90: the ring's stages; mma_sync: 1 (each tile loaded and waited for)
    ksteps: int  # sm90: steps of 16 over the head dim in S and dP (zero columns past d); else 0
    head_pad: int  # the head dim as shared memory holds it: whole 64-column boxes (sm90), or the chunk DC
    boxes: Tuple[Tuple[int, int], ...]  # sm90: TMA boxes (columns, rows) of the outer and the inner tiles
    swizzle: int  # bytes of the shared-memory swizzle (sm90); 0 for the cp.async kernel
    smem: int  # dynamic shared memory bytes of a CTA
    ctas: int  # CTAs of the grid


def _bwd_sm90_smem(mode: str, slabs: int, ksteps: int, outer: int, inner: int, stages: int) -> int:
    """`kv_outer_smem` / `q_outer_smem` of `csrc/flash_bwd_sm90.cuh`."""
    if mode == "dq":  # Q and dO once, the K and V ring
        return 1024 + slabs * SWIZZLE_BYTES * (2 * outer + 2 * stages * inner) + _BWD_BARRIER_BYTES
    # K and V once, the Q and dO ring with its lse and delta rows; fused: dS^T and two 64 x d f32 dq tiles a
    # consumer
    smem = 1024 + slabs * SWIZZLE_BYTES * (2 * outer + 2 * stages * inner) + stages * 2 * inner * 4 + _BWD_BARRIER_BYTES
    if mode == "fused":
        smem += outer * SWIZZLE_BYTES + 2 * (outer // 64) * inner * 16 * ksteps * 4
    return smem


def _bwd_mma_sync_chunk(d: int, size: int) -> int:
    """The head-dim chunk DC that `flash_bwd.cuh`'s `dispatch` takes for head dim d and element size."""
    if size == 4:
        return 64 if d <= 64 else 128
    return next((dc for dc in (32, 48, 64, 80, 128, 160) if d <= dc), 128)


@functools.lru_cache(maxsize=1024)
def flash_bwd_plan(
    b: int, h: int, lq: int, lk: int, d: int, dtype: torch.dtype, sms: int = SM_COUNT, kernel: Optional[str] = None,
    mode: str = "fused",
) -> FlashBwdPlan:
    """The backward kernel of `mode` and its tiles at q / dO (b, h, lq, d), k / v (b, h, lk, d).

    bf16 / fp16 with 8 | d <= `SM90_BWD_MAX_D[mode]` (128 for the fused and
    dk.dv kernels, 192 for dq) take the wgmma + TMA kernels: the fewest
    instantiated steps of 16 (`SM90_BWD_KSTEPS`) that cover d, 64-column
    boxes over those, two consumer warpgroups (128 outer rows) unless that
    grid would leave more than half the SMs idle or their tiles would not
    fit in shared memory (the fused kernel past d = 80; then one, 64 rows), inner
    tiles of 64 q rows (kv outer) or of 128 kv rows where one box holds the
    head dim and 64 beyond (dq), and as many ring stages (2..4) as shared
    memory holds. f32, larger head dims (the UNet's d = 160 for the fused and
    dk.dv kernels, whose dK and dV do not fit a consumer's registers) and
    `kernel="mma_sync"` take the mma.sync kernel."""
    if kernel not in (None, "sm90", "mma_sync"):
        raise ValueError(f"flash_bwd_plan: kernel {kernel!r} is not 'sm90' or 'mma_sync'")
    if mode not in BWD_MODES:
        raise ValueError(f"flash_bwd_plan: mode {mode!r} is not one of {BWD_MODES}")
    size = torch.empty((), dtype=dtype).element_size()
    max_d = SM90_BWD_MAX_D[mode]
    sm90_ok = dtype in (torch.bfloat16, torch.float16) and d % 8 == 0 and d <= max_d
    if kernel == "sm90" and not sm90_ok:
        raise ValueError(f"flash_bwd_plan: the sm90 {mode} kernel takes bf16 / fp16 with 8 | d <= {max_d}; "
                         f"got {dtype}, d={d}")
    outer_len = lq if mode == "dq" else lk
    if kernel == "mma_sync" or not sm90_ok:
        dc = _bwd_mma_sync_chunk(d, size)
        pad = 4 if size == 4 else 8
        smem = 4 * 64 * (dc + pad) * size + 2 * 64 * (64 + pad) * size + 2 * 64 * 4
        return FlashBwdPlan("mma_sync", mode, _BWD_TILE, _BWD_TILE, 0, 1, 0, dc, (), 0, smem,
                            _cdiv(outer_len, _BWD_TILE) * _cdiv(d, dc) * b * h)
    ksteps = next(k for k in SM90_BWD_KSTEPS[mode] if 16 * k >= d)
    slabs = _cdiv(16 * ksteps, BOX_COLS)
    inner = (128 if slabs == 1 else 64) if mode == "dq" else BWD_Q_TILE
    # two consumers where the grid keeps the SMs busy and their tiles fit at two stages: the fused kernel's
    # f32 dq tiles (two 64 x d a consumer) do not past d = 80
    consumers = 2 if (2 * _cdiv(outer_len, 128) * b * h > sms
                      and _bwd_sm90_smem(mode, slabs, ksteps, 128, inner, 2) <= SMEM_MAX) else 1
    outer = 64 * consumers
    fit = [s for s in range(2, SM90_MAX_STAGES + 1) if _bwd_sm90_smem(mode, slabs, ksteps, outer, inner, s) <= SMEM_MAX]
    assert fit, f"flash_bwd_plan: no ring of the sm90 {mode} kernel fits at d={d}"
    stages = max(fit)
    return FlashBwdPlan("sm90", mode, outer, inner, consumers, stages, ksteps, BOX_COLS * slabs,
                        ((BOX_COLS, outer), (BOX_COLS, inner)), SWIZZLE_BYTES,
                        _bwd_sm90_smem(mode, slabs, ksteps, outer, inner, stages), _cdiv(outer_len, outer) * b * h)


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernels do not take."""
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {q.device}")
    b, h, q_len, d = q.shape
    kv_len = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} kernel takes bf16/fp16/f32 q, k, v of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (b, h, kv_len, d) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if d % 8 != 0 or d > MAX_HEAD_DIM or q_len == 0 or kv_len == 0:
        raise ValueError(f"{name} kernel takes 8 | D <= {MAX_HEAD_DIM} and non-empty L; got {tuple(q.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v on different devices")


def _count_launch(name: str) -> None:
    """One more launch of kernel `name`, on its wrapper's `launches`. The
    wrapper is looked up in `_WRAPPERS`, not by its global name, which a
    caller may have pointed elsewhere."""
    _native.count_launch(_WRAPPERS[name])


def _launch_fwd(
    name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, sm_scale: Optional[float],
    with_lse: bool, kernel: Optional[str],
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    _check_qkv(name, q, k, v)
    b, h, q_len, d = q.shape
    scale = _scale(d, sm_scale)
    # the wgmma kernels take the row max of the raw scores, which needs a positive scale
    plan = flash_plan(b, h, q_len, k.shape[2], d, q.dtype, sm_count(q.device.index),
                      "mma_sync" if kernel is None and scale <= 0 else kernel)
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    # (B, Lq, H, D) storage: merging heads afterwards is a free view
    out = torch.empty((b, q_len, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, q_len), dtype=torch.float32, device=q.device) if with_lse else None
    # a split kv range: each part's f32 accumulator (head_pad columns), m and l, for the combining launch
    work = (torch.empty(plan.splits * b * h * q_len * (plan.head_pad + 2), dtype=torch.float32, device=q.device)
            if plan.splits > 1 else None)
    err = _native.library(name)(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, h, q_len, k.shape[2], d, int(causal), scale,
        _KERNEL_CODES[plan.kernel], plan.bq, plan.bk, plan.stages, plan.ksteps, plan.splits,
        None if work is None else work.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _native.check(err, name, plan.kernel)
    _count_launch(name)
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    kernel: Optional[str] = None,
) -> torch.Tensor:
    """Flash attention forward, no graph. q: (B, H, Lq, D), k/v:
    (B, H, Lk, D) -> (B, H, Lq, D). CPU tensors take the plain version; CUDA
    tensors launch the kernel that `flash_plan` picks (or `kernel`, "sm90",
    "sm90_wide" or "mma_sync", names) or raise; a split kv range is one call
    and one count, though it makes a second launch that combines the parts.
    The result carries no `grad_fn`: differentiable callers go through
    `flash_attention_trainable`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    out, _ = _launch_fwd("flash_attention", q, k, v, causal, sm_scale, False, kernel)
    return out


flash_attention.launches = 0


def flash_fwd_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward with its residual: (o (B, H, Lq, D),
    lse (B, H, Lq) f32). No padded rows are stored. `kernel` as in
    `flash_attention`."""
    if q.device.type == "cpu":
        return flash_fwd_with_lse_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    out, lse = _launch_fwd("flash_fwd_lse", q, k, v, causal, sm_scale, True, kernel)
    return out, lse


flash_fwd_lse.launches = 0


def _fwd_out(q: torch.Tensor) -> torch.Tensor:
    """An empty forward output in the kernels' layout: (B, H, Lq, D) over
    (B, Lq, H, D) storage, so that merging the heads afterwards is a free
    view."""
    b, h, q_len, d = q.shape
    return q.new_empty((b, q_len, h, d)).transpose(1, 2)


# The two forwards as operations of PyTorch's dispatcher, each with an implementation for the CPU (the plain
# version, in the kernels' output layout), one for CUDA (the kernel) and a fake one (shapes and dtypes only), so
# that `torch.export` keeps the same operation in its graph on either device and a selective-checkpoint policy
# can keep its outputs (`everything_saveable`) where a launch from inside an autograd function's forward would be
# invisible to it. Both implementations reach the kernel through its wrapper, looked up as a module global, so
# that a wrapper swapped for its plain version (or for a recorder) is what the operation runs; the wrapper counts
# the launch, inside an exported program too. The gradient stays with `FlashAttentionTrainable`.


@torch.library.custom_op("cflearn_torch::flash_attention", mutates_args=(), device_types="cpu")
def flash_attention_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, sm_scale: Optional[float]
) -> torch.Tensor:
    """`flash_attention` as one operation of the dispatcher."""
    return _fwd_out(q).copy_(flash_attention(q, k, v, causal=causal, sm_scale=sm_scale))


@flash_attention_op.register_kernel("cuda")
def _flash_attention_cuda(q, k, v, causal, sm_scale):  # type: ignore[no-untyped-def]
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, sm_scale):  # type: ignore[no-untyped-def]
    return _fwd_out(q)


@torch.library.custom_op("cflearn_torch::flash_fwd_lse", mutates_args=(), device_types="cpu")
def flash_fwd_lse_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, sm_scale: Optional[float]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_fwd_lse` as one operation of the dispatcher."""
    o, lse = flash_fwd_lse(q, k, v, causal=causal, sm_scale=sm_scale)
    return _fwd_out(q).copy_(o), lse


@flash_fwd_lse_op.register_kernel("cuda")
def _flash_fwd_lse_cuda(q, k, v, causal, sm_scale):  # type: ignore[no-untyped-def]
    return flash_fwd_lse(q, k, v, causal=causal, sm_scale=sm_scale)


@flash_fwd_lse_op.register_fake
def _flash_fwd_lse_fake(q, k, v, causal, sm_scale):  # type: ignore[no-untyped-def]
    b, h, q_len, _ = q.shape
    return _fwd_out(q), q.new_empty((b, h, q_len), dtype=torch.float32)


def _inference_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, sm_scale: Optional[float]
) -> torch.Tensor:
    """The inference forward: the wrapper itself, or under a trace
    (`torch.export`, `torch.compile`) its operation, which the trace keeps
    as one node. An eager call pays no dispatcher round trip."""
    if torch.compiler.is_compiling():
        return flash_attention_op(q, k, v, causal, sm_scale)
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)


def bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B, H, Lq): a bandwidth pass that the
    JAX package also leaves outside its kernels."""
    return (do.float() * o.float()).sum(dim=-1)


def _launch_bwd(
    name: str,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool,
    sm_scale: Optional[float],
    kernel: Optional[str],
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    _check_qkv(name, q, k, v)
    b, h, q_len, d = q.shape
    kv_len = k.shape[2]
    plan = flash_bwd_plan(b, h, q_len, kv_len, d, q.dtype, sm_count(q.device.index), kernel,
                          name[len("flash_bwd_"):])
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"{name}: dO {tuple(do.shape)} {do.dtype} does not match q {tuple(q.shape)} {q.dtype}")
    if tuple(lse.shape) != (b, h, q_len) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse must be f32 {(b, h, q_len)}; got {lse.dtype} {tuple(lse.shape)}")
    delta = bwd_delta(o, do).contiguous()
    lse = lse.contiguous()
    # dO comes with whatever strides autograd gave it: a copy only if the
    # kernel cannot read them
    q, k, v, do = _kernel_view(q), _kernel_view(k), _kernel_view(v), _kernel_view(do)
    dq = dk = dv = None
    if name == "flash_bwd_fused":
        # the kv tiles' CTAs add their shares of dq into this f32 buffer (whole tiles by bulk reduce-adds on
        # the sm90 kernel, f32 atomics on the mma.sync one)
        dq = torch.zeros((b, h, q_len, d), dtype=torch.float32, device=q.device)
    elif name == "flash_bwd_dq":
        dq = torch.empty((b, h, q_len, d), dtype=q.dtype, device=q.device)
    if name != "flash_bwd_dq":
        dk = torch.empty((b, h, kv_len, d), dtype=q.dtype, device=q.device)
        dv = torch.empty((b, h, kv_len, d), dtype=q.dtype, device=q.device)
    err = _native.library(name)(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        None if dq is None else dq.data_ptr(),
        None if dk is None else dk.data_ptr(),
        None if dv is None else dv.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        b, h, q_len, kv_len, d, int(causal), _scale(d, sm_scale),
        _KERNEL_CODES[plan.kernel], plan.outer, plan.inner, plan.stages, plan.ksteps,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _native.check(err, name, plan.kernel)
    _count_launch(name)
    if name == "flash_bwd_fused":
        dq = dq.to(q.dtype)
    return dq, dk, dv


def flash_bwd_fused(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from one kernel: the one `flash_bwd_plan` picks, the
    wgmma + TMA kernel of `csrc/flash_bwd_sm90.cuh` or the mma.sync kernel
    of `csrc/flash_bwd.cuh` (or `kernel`, "sm90" or "mma_sync", names). dq
    is summed across kv tiles in an f32 buffer, by bulk reduce-adds of
    whole tiles (the wgmma + TMA kernel) or by f32 atomics (the mma.sync
    kernel), in an order that varies from run to run (not
    bit-reproducible), and cast to q's dtype afterwards."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale)
    grads = _launch_bwd("flash_bwd_fused", q, k, v, o, lse, do, causal, sm_scale, kernel)
    return grads


flash_bwd_fused.launches = 0


def flash_bwd_dq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    kernel: Optional[str] = None,
) -> torch.Tensor:
    """dq of the split (bit-reproducible) backward: q tiles outer, the kv
    blocks summed in a fixed order. `kernel` as in `flash_bwd_fused`."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale)[0]
    dq, _, _ = _launch_bwd("flash_bwd_dq", q, k, v, o, lse, do, causal, sm_scale, kernel)
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the split (bit-reproducible) backward: kv tiles outer,
    the q tiles summed in a fixed order. `kernel` as in `flash_bwd_fused`."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale)[1:]
    _, dk, dv = _launch_bwd("flash_bwd_dkv", q, k, v, o, lse, do, causal, sm_scale, kernel)
    return dk, dv


flash_bwd_dkv.launches = 0


_WRAPPERS = {
    fn.__name__: fn for fn in (flash_attention, flash_fwd_lse, flash_bwd_fused, flash_bwd_dq, flash_bwd_dkv)
}


class FlashAttentionTrainable(torch.autograd.Function):
    """Differentiable flash attention: the kernels' forward and backward.
    When no input needs a gradient the forward is the inference kernel, as
    the JAX custom VJP's primal is (`_inference_forward`). Otherwise
    it runs `flash_fwd_lse` (through `flash_fwd_lse_op`, which a
    selective-checkpoint policy can keep) and saves q, k, v, o, lse; the
    backward runs the fused kernel, or the split pair when `FUSED_BWD` is
    false or `torch.are_deterministic_algorithms_enabled()`."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False, sm_scale=None):  # type: ignore[override]
        if not any(ctx.needs_input_grad[:3]):
            return _inference_forward(q, k, v, causal, sm_scale)
        o, lse = flash_fwd_lse_op(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):  # type: ignore[override]
        q, k, v, o, lse = ctx.saved_tensors
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale)
        if FUSED_BWD and not torch.are_deterministic_algorithms_enabled():
            dq, dk, dv = flash_bwd_fused(q, k, v, o, lse, do, **kw)
        else:
            dq = flash_bwd_dq(q, k, v, o, lse, do, **kw)
            dk, dv = flash_bwd_dkv(q, k, v, o, lse, do, **kw)
        return dq, dk, dv, None, None


def flash_attention_trainable(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """`FlashAttentionTrainable.apply` with the JAX function's signature.
    Under `torch.no_grad()` no graph is wanted whatever the inputs say (the
    function's forward cannot see the grad mode), so the inference kernel
    runs directly (`_inference_forward`)."""
    if not torch.is_grad_enabled():
        return _inference_forward(q, k, v, causal, sm_scale)
    return FlashAttentionTrainable.apply(q, k, v, causal, sm_scale)


def library_flash_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> bool:
    """Whether FlashAttention-2's forward, called by name, computes what
    `F.scaled_dot_product_attention` does on these (B, H, L, D) inputs: bf16
    or fp16, one batch and head count, 8 | d <= 256, unit-stride head dims,
    no empty sequence, and causal only when Lq == Lk (FlashAttention-2
    aligns the causal mask to the bottom-right corner, SDPA and the JAX
    function to the top-left). The dispatcher's checks are skipped by the
    call by name, so they are made here."""
    d = q.shape[-1]
    return (q.dim() == k.dim() == v.dim() == 4 and q.dtype in (torch.bfloat16, torch.float16)
            and q.dtype == k.dtype == v.dtype and d % 8 == 0 and d <= 256 and k.shape[-1] == v.shape[-1] == d
            and q.shape[:2] == k.shape[:2] == v.shape[:2] and k.shape[2] == v.shape[2]
            and q.stride(-1) == k.stride(-1) == v.stride(-1) == 1 and min(q.shape[2], k.shape[2]) > 0
            and (not causal or q.shape[2] == k.shape[2]))


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused library attention for the shapes the JAX package leaves to XLA.
    `mask` is boolean (True = keep), `bias` an additive logits bias, both
    broadcastable to (B, H, Lq, Lk). On the card, inputs without a mask or a
    bias that `library_flash_takes` accepts run FlashAttention-2's forward by
    name: the backend is fixed by the inputs, not left to the dispatcher,
    which may pick cuDNN's attention, whose bits differed in a worker thread
    from the main thread's at SD's cross-attention shapes
    (`scripts/sdpa_thread_probe.py`)."""
    if q.is_cuda and mask is None and bias is None and library_flash_takes(q, k, v, causal):
        return torch.ops.aten._scaled_dot_product_flash_attention(q, k, v, 0.0, causal, False, scale=sm_scale)[0]
    attn_mask = None
    if mask is not None or bias is not None:
        if causal:
            lq, lk = q.shape[-2], k.shape[-2]
            tri = torch.ones((lq, lk), dtype=torch.bool, device=q.device).tril()
            mask = tri if mask is None else torch.logical_and(mask, tri)
            causal = False
        if bias is None:
            attn_mask = mask
        else:
            attn_mask = bias.to(q.dtype)
            if mask is not None:
                attn_mask = attn_mask.masked_fill(~mask, float("-inf"))
    return F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, is_causal=causal, scale=sm_scale
    )


def use_kernel(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Shape predicate of the JAX package's `_use_pallas`: K/V stream block
    by block, so only the q block and head dim bound the kernel; short kv
    (SD cross-attention, kv = 77) stays on the library path."""
    return q.shape[2] >= 128 and k.shape[2] >= 256 and _round_up(q.shape[3], 128) <= 1024


def sdp_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled-dot-product attention dispatcher. (B, H, L, D) in and out."""
    if mask is None and bias is None:
        from ..parallel.mesh import get_active_context_mesh

        mesh = get_active_context_mesh()
        if mesh is not None and q.shape[2] == k.shape[2] and q.shape[2] % mesh.shape["context"] == 0:
            from .ring_attention import context_parallel_attention

            return context_parallel_attention(q, k, v, mesh, causal=causal, sm_scale=sm_scale)
    return local_sdp_attn(q, k, v, causal=causal, sm_scale=sm_scale, mask=mask, bias=bias)


def local_sdp_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`sdp_attn` on this rank's tensors: the flash kernels where
    `use_kernel` says so, else `xla_attention`."""
    if mask is None and bias is None and use_kernel(q, k):
        # always the differentiable entry: without a gradient to carry it is
        # the inference kernel
        return flash_attention_trainable(q, k, v, causal, sm_scale)
    return xla_attention(q, k, v, causal=causal, sm_scale=sm_scale, mask=mask, bias=bias)
