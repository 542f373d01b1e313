"""3x3 conv ops: the implicit-GEMM CUDA kernels and the conv dispatcher.

Counterpart of `cflearn_tpu/ops/conv.py`:

* `conv3x3` — wrapper of the hand-written Hopper kernel
  (`csrc/conv3x3.cu`), which replaces the TPU's `_conv3x3_kernel`
  (`conv3x3_pallas`, fold=False). On a CPU tensor it runs `conv3x3_plain`,
  the same 9 shifted f32 matmuls in plain PyTorch; on a CUDA tensor it
  launches the kernel or raises. Where an input needs a gradient it goes
  through `Conv3x3Function`, the JAX package's conv VJP: dx is the forward
  kernel on dy with `flip_weights(w)`, dw the weight-gradient kernel, db a sum
  of dy in f32.
* `conv3x3_wgrad` — wrapper of the weight-gradient kernel
  (`csrc/conv3x3_wgrad.cu`), which replaces `_conv3x3_wgrad_kernel`
  (`conv3x3_wgrad_pallas`); `conv3x3_wgrad_plain` is its plain version. The
  JAX package keeps its kernel behind `CFLEARN_TPU_WGRAD_PALLAS` because XLA's
  weight gradient was faster on its chip; that is a measurement of that chip,
  not a semantic, so here every conv whose forward was routed to the kernel
  takes both kernels in its backward.
* `use_kernel_conv` / `conv_call` — the dispatcher with the predicates of
  the JAX package's `use_pallas_conv` and `_shape_wins`: bf16/fp16, C and
  Co >= 64, and H*W >= 128^2 or the pinned (64, 64, 512, 512) shape. Every
  other conv runs through `F.conv2d`, as the JAX package leaves it to XLA.

Tensors are NHWC; weights are the port's OIHW, and (Co, 3, 3, C) at the
kernels (where the JAX package has (3, 3, C, Co)). W8A8 and the dj-fold
variant belong to later slices.
"""

from typing import Any, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from . import _native

_DTYPES = {torch.bfloat16: 0, torch.float16: 1}
# (h, w, c, co) shapes routed to the kernel below 128^2 (the VAE decoder's
# 64^2 level), as in the JAX package's `_PINNED_CONFIGS`
PINNED_SHAPES = {(64, 64, 512, 512)}


def kernel_weight(weight: torch.Tensor) -> torch.Tensor:
    """OIHW -> the kernel's (Co, 3, 3, C) layout (each output channel's
    9*C taps contiguous)."""
    return weight.permute(0, 2, 3, 1).contiguous()


def conv3x3_plain(
    x: torch.Tensor, w_ohwi: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: y[b,i,j] = sum over the 9
    taps of x[b, i+di-1, j+dj-1] @ w[:, di, dj, :].T in f32 (zero halo),
    plus the bias in f32, cast to x's dtype."""
    b, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w_ohwi.float()
    acc = None
    for di in range(3):
        for dj in range(3):
            part = xp[:, di : di + h, dj : dj + w, :].reshape(-1, c) @ wf[:, di, dj, :].T
            acc = part if acc is None else acc + part
    if bias is not None:
        acc = acc + bias.float()
    return acc.reshape(b, h, w, -1).to(x.dtype)


def _needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _launch_conv3x3(x: torch.Tensor, w_ohwi: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Check the arguments and launch the forward kernel on CUDA tensors."""
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3x3: no kernel for device {x.device}")
    bsz, h, w, c = x.shape
    co = w_ohwi.shape[0]
    if x.dtype not in _DTYPES or w_ohwi.dtype != x.dtype or (bias is not None and bias.dtype != x.dtype):
        raise TypeError(f"conv3x3 kernel takes bf16/fp16 x, w, bias of one dtype; got {x.dtype}, {w_ohwi.dtype}")
    if tuple(w_ohwi.shape) != (co, 3, 3, c) or (bias is not None and tuple(bias.shape) != (co,)):
        raise ValueError(f"conv3x3: x {tuple(x.shape)} w {tuple(w_ohwi.shape)}")
    if c % 8 != 0 or co % 8 != 0:
        raise ValueError(f"conv3x3 kernel takes C % 8 == 0 and Co % 8 == 0; got C={c}, Co={co}")
    x = x.contiguous()
    w_ohwi = w_ohwi.contiguous()
    bias = None if bias is None else bias.contiguous()
    y = torch.empty((bsz, h, w, co), dtype=x.dtype, device=x.device)
    fn = _native.library("conv3x3")
    err = fn(
        _DTYPES[x.dtype], x.data_ptr(), w_ohwi.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        bsz, h, w, c, co, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _native.check(err, "conv3x3")
    _WRAPPER.launches += 1
    return y


def conv3x3(
    x: torch.Tensor, w_ohwi: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """3x3 stride-1 SAME conv. x: (B, H, W, C), w: (Co, 3, 3, C), bias:
    (Co,) -> (B, H, W, Co). CPU tensors take the plain version (autograd runs
    through it); CUDA tensors launch the kernel (bf16 / fp16, C % 8 == 0,
    Co % 8 == 0) or raise. On the card a call whose inputs need a gradient
    goes through `Conv3x3Function`."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w_ohwi, bias)
    if _needs_grad(x, w_ohwi, bias):
        return Conv3x3Function.apply(x, w_ohwi, bias)
    return _launch_conv3x3(x, w_ohwi, bias)


conv3x3.launches = 0
# the counter's holder, whatever a caller may have bound the module's name to
_WRAPPER = conv3x3

# the card's SM count times the CTAs of the weight-gradient kernel that fit
# one SM: how many CTAs the split of K aims at
_WGRAD_CTAS = 2 * 132
_WGRAD_BK = 32  # pixels per K tile of the kernel
_WGRAD_MIN_KT = 8  # least K tiles per split: below it the partial sums cost more than they spread


def wgrad_splits(pixels: int, c: int, co: int) -> int:
    """Into how many contiguous ranges the weight-gradient kernel splits its
    contraction over `pixels` = B*H*W: enough CTAs to fill the card when the
    output (9 tiles of 128 x 128 at C = Co = 128) is small, every split
    non-empty."""
    tiles = 9 * -(-co // 128) * -(-c // 128)
    kt = -(-pixels // _WGRAD_BK)
    splits = max(1, min(-(-_WGRAD_CTAS // tiles), kt // _WGRAD_MIN_KT))
    per = -(-kt // splits)
    return -(-kt // per)


def conv3x3_wgrad_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The weight-gradient kernel's function in plain PyTorch:
    dw[co, di, dj, c] = sum over (b, i, j) of dy[b, i, j, co] *
    x[b, i+di-1, j+dj-1, c] (zero halo) as nine f32 products, cast to x's
    dtype. (Co, 3, 3, C): the forward kernel's weight layout."""
    b, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    dyf = dy.float().reshape(-1, dy.shape[-1])
    taps = [
        dyf.T @ xp[:, di : di + h, dj : dj + w, :].reshape(-1, c)
        for di in range(3)
        for dj in range(3)
    ]
    return torch.stack(taps, dim=1).reshape(dy.shape[-1], 3, 3, c).to(x.dtype)


def conv3x3_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dL/dw of `conv3x3`: x (B, H, W, C), dy (B, H, W, Co) -> (Co, 3, 3, C)
    in x's dtype, summed in f32 in a fixed order (bit-reproducible). CPU
    tensors take the plain version; CUDA tensors launch the kernel (bf16 /
    fp16, C % 8 == 0, Co % 8 == 0) or raise."""
    if x.device.type == "cpu":
        return conv3x3_wgrad_plain(x, dy)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3x3_wgrad: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"conv3x3_wgrad kernel takes bf16/fp16 x and dy of one dtype; got {x.dtype}, {dy.dtype}")
    if x.ndim != 4 or dy.ndim != 4 or tuple(dy.shape[:3]) != tuple(x.shape[:3]):
        raise ValueError(f"conv3x3_wgrad: x {tuple(x.shape)} dy {tuple(dy.shape)}")
    bsz, h, w, c = x.shape
    co = dy.shape[-1]
    if c % 8 != 0 or co % 8 != 0:
        raise ValueError(f"conv3x3_wgrad kernel takes C % 8 == 0 and Co % 8 == 0; got C={c}, Co={co}")
    x = x.contiguous()
    dy = dy.contiguous()
    splits = wgrad_splits(bsz * h * w, c, co)
    ws = torch.empty((splits, co, 9, c), dtype=torch.float32, device=x.device)
    out = torch.empty((co, 3, 3, c), dtype=x.dtype, device=x.device)
    fn = _native.library("conv3x3_wgrad")
    err = fn(
        _DTYPES[x.dtype], x.data_ptr(), dy.data_ptr(), ws.data_ptr(), out.data_ptr(),
        bsz, h, w, c, co, splits, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _native.check(err, "conv3x3_wgrad")
    _WGRAD_WRAPPER.launches += 1
    return out


conv3x3_wgrad.launches = 0
_WGRAD_WRAPPER = conv3x3_wgrad


def flip_weights(w_ohwi: torch.Tensor) -> torch.Tensor:
    """Input-gradient weights, the JAX package's `_flip_weights` in the
    kernel's layout: (Co, 3, 3, C) -> (C, 3, 3, Co), rotated by 180 degrees,
    so that dx = conv3x3(dy, flip_weights(w))."""
    return w_ohwi.flip(1, 2).permute(3, 1, 2, 0).contiguous()


class Conv3x3Function(torch.autograd.Function):
    """The conv VJP on the card (the JAX package's `_conv3x3_bwd`): forward
    through the kernel; backward dx through the same kernel with flipped
    weights, dw through the weight-gradient kernel, db = sum of dy in f32."""

    @staticmethod
    def forward(ctx, x, w_ohwi, bias):  # type: ignore[override]
        ctx.save_for_backward(x, w_ohwi)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _launch_conv3x3(x, w_ohwi, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):  # type: ignore[override]
        x, w_ohwi = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _launch_conv3x3(dy, flip_weights(w_ohwi), None)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(x, dy)
        if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
            db = dy.float().sum(dim=(0, 1, 2)).to(ctx.bias_dtype)
        return dx, dw, db


_Padding = Union[str, Any]


def _is_same_padding(padding: _Padding) -> bool:
    if isinstance(padding, str):
        return padding.upper() == "SAME"
    try:
        return tuple(map(tuple, padding)) == ((1, 1), (1, 1))
    except TypeError:
        return False


def shape_wins(x_shape: Tuple[int, ...], x_dtype: torch.dtype, co: int) -> bool:
    """The JAX package's `_shape_wins`: >= 128^2 spatial, or a pinned shape;
    2-byte activations only."""
    if torch.empty((), dtype=x_dtype).element_size() > 2:
        return False
    h, w, c = x_shape[1], x_shape[2], x_shape[-1]
    return h * w >= 128 * 128 or (h, w, c, co) in PINNED_SHAPES


def use_kernel_conv(
    x: torch.Tensor, weight: torch.Tensor, strides: Any, padding: _Padding
) -> bool:
    """The JAX package's `use_pallas_conv` without its backend test. `weight`
    is OIHW; `strides` a pair; `padding` "SAME" or ((lo, hi), (lo, hi))."""
    if weight.ndim != 4 or tuple(weight.shape[2:]) != (3, 3) or x.ndim != 4:
        return False
    if tuple(strides) != (1, 1) or not _is_same_padding(padding):
        return False
    if weight.element_size() > 2:  # conv_call casts x to the kernel dtype
        return False
    co = weight.shape[0]
    return x.shape[-1] >= 64 and co >= 64 and shape_wins(tuple(x.shape), x.dtype, co)


def conv_call(conv: Any, x: torch.Tensor) -> torch.Tensor:
    """Run a port `Conv` module on NHWC `x` through the kernel where the
    predicate routes it, else through the module itself (`F.conv2d`)."""
    plain = tuple(conv.dilation) == (1, 1) and conv.groups == 1
    if plain and use_kernel_conv(x, conv.weight, conv.strides, conv.padding):
        w = conv.kernel_weight()
        bias = conv.bias
        x = x.to(w.dtype)
        return conv3x3(x, w, bias)
    return conv(x)
