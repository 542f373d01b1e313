"""GroupNorm (+ optional SiLU) over channel-last input.

Counterpart of `cflearn_tpu/ops/group_norm.py`:

* `group_norm` — the JAX package's default path (`gn_call` without
  `CFLEARN_TPU_FUSED_GN`, i.e. flax's GroupNorm left to XLA) in plain
  PyTorch: statistics in f32 with var = E[x^2] - E[x]^2 clipped at 0, the
  affine in f32, the result cast to the promoted input/parameter dtype, SiLU
  after the cast. CPU tensors take it.
* `group_norm_silu` — wrapper of the hand-written Hopper kernel
  (`csrc/group_norm.cu`), which replaces the TPU's `_gn_silu_kernel`
  (`_group_norm_pallas`); `group_norm_silu_plain` is its plain version:
  statistics, affine and SiLU in f32, one cast at the end to x's dtype.
* `FusedGroupNorm` / `fused_group_norm` — the differentiable entry, as the JAX
  package's `fused_group_norm`: the kernel forward, the backward recomputed
  through the plain version. The JAX package has no backward kernel, so the
  port has none.
* `gn_call` / `module_call` — what the modules call.

The JAX package keeps its kernel opt-in because XLA fuses GroupNorm into its
neighbours; eager PyTorch fuses nothing, so on a CUDA tensor every eligible
GroupNorm (affine present, C % groups == 0, bf16 / fp16 / f32) goes through the kernel, with or without a gradient. Two gates of the JAX
dispatcher are dropped: `fits_vmem` and `spatial % 8 == 0` describe the TPU's
VMEM and tiling, and this kernel walks slabs of rows of any spatial size
(the VAE's 512^2 x 128 included). There is no switch back to the plain
version on the card.

The one place where the kernel's arithmetic differs from the TPU kernel's:
the variance is clamped at 0 before `+ eps`, as flax and the port's default
path do. The Pallas kernel has no clamp; E[x^2] - mean^2 can round below zero
for a constant group, and a negative var + eps would give NaN.
"""

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

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
    """(slabs, rows per slab) of the kernel for a (batch, spatial, channels)
    input: the slabs of rows one CTA takes, sized so that about
    `_TARGET_CTAS` CTAs are in flight and each of a CTA's threads has a few
    rows (a thread owns a 16-byte chunk of channels where C allows it; the
    threads left over after one row's chunks take further rows)."""
    chunk = 16 // itemsize
    chunks = channels // chunk if channels % chunk == 0 else channels
    rows_at_once = _THREADS // min(chunks, _THREADS)
    per_sample = max(1, _TARGET_CTAS // batch)
    rows = max(-(-spatial // per_sample), 4 * rows_at_once)
    return -(-spatial // rows), rows


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
) -> torch.Tensor:
    """GroupNorm (+ SiLU) of x (B, ..., C) in x's dtype. CPU tensors take the
    plain version; CUDA tensors launch the kernel (bf16 / fp16 / f32 x; w and
    b of one of these dtypes; C % num_groups == 0) or raise."""
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
    slabs, rows = kernel_plan(bsz, spatial, c, x.element_size())
    partial = torch.empty((bsz, slabs, num_groups, 2), dtype=torch.float32, device=x.device)
    stats = torch.empty((bsz, num_groups, 2), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    fn = _native.library("group_norm")
    err = fn(
        _DTYPES[x.dtype], _DTYPES[weight.dtype], x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        partial.data_ptr(), stats.data_ptr(), bsz, spatial, c, num_groups, float(eps), int(apply_silu),
        slabs, rows, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _native.check(err, "group_norm_silu")
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
