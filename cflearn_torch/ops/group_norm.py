"""GroupNorm (+ optional SiLU) over channel-last input.

Counterpart of `cflearn_tpu/ops/group_norm.py`:

* `group_norm` — the JAX package's default path (`gn_call` without
  `CFLEARN_TPU_FUSED_GN`, i.e. flax's GroupNorm left to XLA) in plain
  PyTorch: statistics in f32 with var = E[x^2] - E[x]^2 clipped at 0, the
  affine in f32, the result cast to the promoted input/parameter dtype, SiLU
  after the cast. CPU tensors take it.
* `group_norm_silu` — wrapper of the hand-written Hopper kernel
  (`csrc/group_norm.cu`: one cooperative launch per call, whole rows per CTA,
  one grid barrier between the statistics and the output, see `gn_plan`),
  which replaces the TPU's
  `_gn_silu_kernel` (`_group_norm_pallas`); `group_norm_silu_plain` is its
  plain version: statistics, affine and SiLU in f32, one cast at the end to
  x's dtype. The previous design, three launches (stats, finalize, apply),
  stays reachable as the yardstick through `kernel="slabs"`.
* `gn_plan` — the host's planner of that kernel: the route (every row kept
  on chip, or streamed), the slabs of rows per sample, the rows a CTA keeps,
  the samples per wave, the CTAs. Plain Python, so that the CPU tests hold
  its coverage and budgets.
* `FusedGroupNorm` / `fused_group_norm` — the differentiable entry, as the JAX
  package's `fused_group_norm`: the kernel forward, the backward recomputed
  through the plain version. The JAX package has no backward kernel, so the
  port has none.
* `gn_call` / `module_call` — what the modules call.

The JAX package keeps its kernel opt-in because XLA fuses GroupNorm into its
neighbours; eager PyTorch fuses nothing, so on a CUDA tensor every eligible
GroupNorm (affine present, C % groups == 0, bf16 / fp16 / f32) goes through the kernel, with or without a gradient. Two gates of the JAX
dispatcher are dropped: `fits_vmem` and `spatial % 8 == 0` describe the TPU's
VMEM and tiling, and this kernel takes rows of any spatial size (the VAE's
512^2 x 128 included, streamed). There is no switch back to the plain
version on the card.

The one place where the kernel's arithmetic differs from the TPU kernel's:
the variance is clamped at 0 before `+ eps`, as flax and the port's default
path do. The Pallas kernel has no clamp; E[x^2] - mean^2 can round below zero
for a constant group, and a negative var + eps would give NaN.
"""

import functools
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import SM_COUNT, sm_count
from . import _native

_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_THREADS = 256  # threads per CTA of the kernel
_TARGET_CTAS = 4 * 132  # CTAs in flight the slabs aim at: a few per SM


def group_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    *,
    num_groups: int = 32,
    eps: float = 1e-6,
    apply_silu: bool = False,
) -> torch.Tensor:
    """x: (B, ..., C). Statistics per sample and group over all other axes."""
    out_dtype = x.dtype
    for p in (weight, bias):
        if p is not None:
            out_dtype = torch.promote_types(out_dtype, p.dtype)
    y = _normalise_f32(x, weight, bias, num_groups, eps).to(out_dtype)
    return F.silu(y) if apply_silu else y


def _normalise_f32(
    x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor], num_groups: int, eps: float
) -> torch.Tensor:
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    mean2 = xf.square().mean(dim=(1, 3), keepdim=True)
    var = (mean2 - mean.square()).clamp_min(0.0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y


def group_norm_silu_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    *,
    num_groups: int = 32,
    eps: float = 1e-6,
    apply_silu: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x (B, ..., C) -> the same shape
    in x's dtype. Group sums of x and x^2 in f32, var = max(E[x^2] - mean^2,
    0), y = (x - mean) * rsqrt(var + eps) * w + b, SiLU in f32, then one cast."""
    y = _normalise_f32(x, weight, bias, num_groups, eps)
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def kernel_plan(batch: int, spatial: int, channels: int, itemsize: int) -> Tuple[int, int]:
    """(slabs, rows per slab) of the three-launch yardstick for a (batch,
    spatial, channels) input: the slabs of rows one CTA takes, sized so that
    about `_TARGET_CTAS` CTAs are in flight and each of a CTA's threads has a
    few rows (a thread owns a 16-byte chunk of channels where C allows it;
    the threads left over after one row's chunks take further rows)."""
    chunk = 16 // itemsize
    chunks = channels // chunk if channels % chunk == 0 else channels
    rows_at_once = _THREADS // min(chunks, _THREADS)
    per_sample = max(1, _TARGET_CTAS // batch)
    rows = max(-(-spatial // per_sample), 4 * rows_at_once)
    return -(-spatial // rows), rows


# ---- the planner of the one-launch kernel (`csrc/group_norm.cu`) ----

GN_THREADS = 512  # threads of a CTA of the one-launch kernel: one CTA per SM
GN_SMEM_MAX = 232448  # the most dynamic shared memory a block can have on sm_90
_GN_MIN_CTA_BYTES = 8 * 1024  # below this a slab of rows is not worth a CTA
# the planner's estimate of a wave's cost: its grid barrier and the ramps around it (µs), the share of the 50 MB
# L2 that rows read again still find there, and the device memory rate that the rest is read at (H100)
_GN_WAVE_US = 4.0
_GN_L2_BYTES = 30 * 2**20
_GN_HBM_BYTES_PER_US = 3.0e6


class GnPlan(NamedTuple):
    kernel: str  # "grid" (one cooperative launch) or "slabs" (the previous design, three launches: the yardstick)
    route: str  # "on_chip" (every row kept in shared memory: x read from HBM once), "streamed" or "slabs"
    vec: int  # channels per load: a 16-byte chunk, or 1 where C or the addresses do not allow it
    per_sample: int  # slabs of rows per sample (units of work: batch x per_sample of them)
    rows: int  # rows per slab
    keep: int  # rows of its first slab of a wave a CTA keeps in shared memory (the rest it reads again); slabs: 0
    spw: int  # samples per wave (a grid barrier each); slabs: the batch
    ctas: int  # CTAs of the grid: at most one per SM, all resident (slabs: of each of its two slab launches)
    smem: int  # dynamic shared memory bytes of a CTA
    launches: int  # kernel launches per call


def _tiling(channels: int, vec: int, threads: int) -> Tuple[int, int, int]:
    """(chunks, threads along the chunks, threads along the rows) of a CTA over
    a row of `channels`: the kernel's `grid_tiling` (`tiling` for the slabs)."""
    cv = channels // vec
    tx_n = min(cv, threads)
    return cv, tx_n, threads // tx_n


def group_threads(groups: int) -> int:
    """Threads per group in the kernel's two reductions to group sums (over a
    slab's channels, over a sample's slabs): the kernel's `group_threads`."""
    return min(max(1, GN_THREADS // groups), 32)


def gn_smem(channels: int, groups: int, vec: int, itemsize: int, keep: int) -> int:
    """The kernel's `layout`: kept rows (128-byte aligned), per-thread channel
    sums (float2), w and b in f32 (16-byte aligned), the gathered group sums,
    mean and rstd per group, the bulk copy's barrier."""
    _, _, ty_n = _tiling(channels, vec, GN_THREADS)
    kept = -(-keep * channels * itemsize // 128) * 128
    return (-(-(kept + 8 * ty_n * channels) // 16) * 16 + 8 * channels
            + 8 * group_threads(groups) * groups + 8 * groups + 8)


def _gn_wave(batch: int, spatial: int, row: int, spw: int, keep_rows: int, sms: int) -> Tuple[int, int, int, int, float]:
    """(slabs per sample, rows per slab, CTAs, rows kept, estimated µs beyond the bound) with `spw` samples a wave."""
    min_rows = -(-_GN_MIN_CTA_BYTES // row)
    per_sample = max(1, min(sms // spw, -(-spatial // min_rows)))
    rows = -(-spatial // per_sample)
    per_sample = -(-spatial // rows)
    units = min(spw, batch) * per_sample
    ctas = min(units, sms)
    keep = min(rows, keep_rows)
    waves = -(-batch // spw)
    read_again = min(spw, batch) * spatial * row - ctas * keep * row
    extra = waves * (_GN_WAVE_US + max(0, read_again - _GN_L2_BYTES) / _GN_HBM_BYTES_PER_US)
    return per_sample, rows, ctas, keep, extra


@functools.lru_cache(maxsize=4096)
def gn_plan(
    batch: int, spatial: int, channels: int, groups: int, itemsize: int, vectorised: bool = True,
    sms: int = SM_COUNT, kernel: Optional[str] = None,
) -> GnPlan:
    """The GroupNorm kernel's plan for x (batch, spatial, channels).

    One CTA per SM at most, all resident (a cooperative launch). The samples
    go in waves of `spw`, each wave its statistics, a grid barrier and its
    output. A wave's samples' rows are cut into slabs, as many as share the
    SMs out among them but none under 8 KB; a CTA takes whole rows, so its
    slab is one contiguous span of x, and keeps as many as its shared memory
    holds beside the sums. Waves of fewer samples keep more of a large batch
    on chip (or in L2) at a barrier each: `spw` minimises the estimated
    barriers plus rows read again from device memory. "on_chip": every CTA
    keeps its whole slab, x is read from HBM once; "streamed": the rest is
    read again, last read first. `kernel="slabs"` plans the previous design,
    three launches."""
    if kernel not in (None, "grid", "slabs"):
        raise ValueError(f"gn_plan: kernel {kernel!r} is not 'grid' or 'slabs'")
    if channels % groups != 0:
        raise ValueError(f"gn_plan: C={channels} is not a multiple of groups={groups}")
    chunk = 16 // itemsize
    vec = chunk if vectorised and channels % chunk == 0 else 1
    if kernel == "slabs":
        slabs, rows = kernel_plan(batch, spatial, channels, itemsize)
        _, tx_n, ty_n = _tiling(channels, vec, _THREADS)
        return GnPlan("slabs", "slabs", vec, slabs, rows, 0, batch, batch * slabs, ty_n * tx_n * vec * 8, 3)
    row = channels * itemsize
    keep_rows = (GN_SMEM_MAX - gn_smem(channels, groups, vec, itemsize, 0) - 127) // row
    if keep_rows < 0:
        raise ValueError(f"gn_plan: C={channels} leaves no shared memory for the sums")
    options = {spw: _gn_wave(batch, spatial, row, spw, keep_rows, sms) for spw in range(1, batch + 1)}
    spw = min(options, key=lambda n: (options[n][-1], -n))  # the fewest waves among ties
    per_sample, rows, ctas, keep, _ = options[spw]
    on_chip = ctas == min(spw, batch) * per_sample and keep == rows
    return GnPlan("grid", "on_chip" if on_chip else "streamed", vec, per_sample, rows, keep, spw, ctas,
                  gn_smem(channels, groups, vec, itemsize, keep), 1)


def kernel_eligible(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor], num_groups: int) -> bool:
    """Whether the kernel takes this call (the JAX dispatcher's gates without
    the two that describe the TPU)."""
    if weight is None or bias is None or x.ndim < 2:
        return False
    c = x.shape[-1]
    return (
        x.dtype in _DTYPES and weight.dtype in _DTYPES and bias.dtype == weight.dtype
        and c % num_groups == 0 and x.numel() > 0
    )


def group_norm_silu(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    *,
    num_groups: int = 32,
    eps: float = 1e-6,
    apply_silu: bool = False,
    kernel: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm (+ SiLU) of x (B, ..., C) in x's dtype. CPU tensors take the
    plain version; CUDA tensors launch the kernel that `gn_plan` plans (or
    `kernel="slabs"`, the three-launch yardstick; bf16 / fp16 / f32 x; w and
    b of one of these dtypes; C % num_groups == 0) or raise. One call counts
    one launch on `group_norm_silu.launches`, whichever kernel runs."""
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, weight, bias, num_groups=num_groups, eps=eps, apply_silu=apply_silu)
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_silu: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or weight.dtype not in _DTYPES or bias.dtype != weight.dtype:
        raise TypeError(
            f"group_norm_silu kernel takes bf16/fp16/f32 x and parameters; got {x.dtype}, {weight.dtype}, {bias.dtype}"
        )
    c = x.shape[-1]
    if x.ndim < 2 or tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"group_norm_silu: x {tuple(x.shape)} w {tuple(weight.shape)} b {tuple(bias.shape)}")
    if c % num_groups != 0 or x.numel() == 0:
        raise ValueError(f"group_norm_silu kernel takes a non-empty x with C % groups == 0; got {tuple(x.shape)}")
    x = x.contiguous()
    weight, bias = weight.contiguous(), bias.contiguous()
    bsz = x.shape[0]
    spatial = x.numel() // (bsz * c)
    y = torch.empty_like(x)
    plan = gn_plan(bsz, spatial, c, num_groups, x.element_size(), (x.data_ptr() | y.data_ptr()) % 16 == 0,
                   sm_count(x.device.index), kernel)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    head = (_DTYPES[x.dtype], _DTYPES[weight.dtype], x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr())
    # the slab sums per (sample, slab, group); the yardstick also takes per (sample, group) statistics
    partial = torch.empty((bsz * plan.per_sample, num_groups, 2), dtype=torch.float32, device=x.device)
    if plan.kernel == "slabs":
        stats = torch.empty((bsz, num_groups, 2), dtype=torch.float32, device=x.device)
        err = _native.library("group_norm_slabs")(
            *head, partial.data_ptr(), stats.data_ptr(), bsz, spatial, c, num_groups, float(eps), int(apply_silu),
            plan.per_sample, plan.rows, stream,
        )
    else:
        err = _native.library("group_norm")(
            *head, partial.data_ptr(), bsz, spatial, c, num_groups, float(eps), int(apply_silu), plan.per_sample,
            plan.rows, plan.keep, plan.spw, plan.ctas, stream,
        )
    _native.check(err, f"group_norm_silu ({plan.kernel})")
    _WRAPPER.launches += 1
    return y


group_norm_silu.launches = 0
# the counter's holder, whatever a caller may have bound the module's name to
_WRAPPER = group_norm_silu


class FusedGroupNorm(torch.autograd.Function):
    """Differentiable GroupNorm (+ SiLU): `group_norm_silu` forward; the
    backward recomputes the plain version on the saved inputs and takes its
    gradients, as the JAX package's `_fgn_bwd` recomputes through XLA."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, apply_silu):  # type: ignore[override]
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (num_groups, eps, apply_silu)
        return group_norm_silu(x, weight, bias, num_groups=num_groups, eps=eps, apply_silu=apply_silu)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):  # type: ignore[override]
        num_groups, eps, apply_silu = ctx.args
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            y = group_norm_silu_plain(*inputs, num_groups=num_groups, eps=eps, apply_silu=apply_silu)
            wanted = [t for t, need in zip(inputs, needs) if need]
            grads = iter(torch.autograd.grad(y, wanted, dy))
        return (*(next(grads) if need else None for need in needs), None, None, None)


def fused_group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    apply_silu: bool = False,
) -> torch.Tensor:
    """`FusedGroupNorm.apply` with the JAX function's signature. Without a
    gradient to carry (no input needs one, or under `torch.no_grad()`) it is
    the kernel's wrapper alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        return FusedGroupNorm.apply(x, weight, bias, num_groups, eps, apply_silu)
    return group_norm_silu(x, weight, bias, num_groups=num_groups, eps=eps, apply_silu=apply_silu)


def module_call(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    *,
    num_groups: int,
    eps: float,
    apply_silu: bool = False,
) -> torch.Tensor:
    """GroupNorm (+ SiLU) as the modules run it: on a CUDA tensor through the
    kernel whenever it is eligible, in the promoted dtype of input and
    parameters; otherwise (CPU tensors, no affine, C not divisible) the
    default path."""
    if x.device.type == "cuda" and kernel_eligible(x, weight, bias, num_groups):
        dtype = torch.promote_types(x.dtype, weight.dtype)
        return fused_group_norm(x.to(dtype), weight, bias, num_groups, eps, apply_silu)
    return group_norm(x, weight, bias, num_groups=num_groups, eps=eps, apply_silu=apply_silu)


def gn_call(gn: Any, x: torch.Tensor, *, silu: bool = False) -> torch.Tensor:
    """Run a port `GroupNorm` module, with SiLU fused where the kernel runs
    (in f32 before the cast) and in the output dtype elsewhere."""
    return module_call(x, gn.weight, gn.bias, num_groups=gn.num_groups, eps=gn.eps, apply_silu=silu)
