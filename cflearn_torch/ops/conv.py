"""3x3 conv ops: the implicit-GEMM CUDA kernel and the conv dispatcher.

Counterpart of `cflearn_tpu/ops/conv.py`:

* `conv3x3` — wrapper of the hand-written Hopper kernel
  (`csrc/conv3x3.cu`), which replaces the TPU's `_conv3x3_kernel`
  (`conv3x3_pallas`, fold=False). On a CPU tensor it runs `conv3x3_plain`,
  the same 9 shifted f32 matmuls in plain PyTorch; on a CUDA tensor it
  launches the kernel or raises.
* `use_kernel_conv` / `conv_call` — the dispatcher with the predicates of
  the JAX package's `use_pallas_conv` and `_shape_wins`: bf16/fp16, C and
  Co >= 64, and H*W >= 128^2 or the pinned (64, 64, 512, 512) shape. Every
  other conv runs through `F.conv2d`, as the JAX package leaves it to XLA.

Tensors are NHWC; weights are the port's OIHW. The conv VJP, W8A8,
weight-grad and the dj-fold variant belong to later slices.
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


def conv3x3(
    x: torch.Tensor, w_ohwi: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """3x3 stride-1 SAME conv. x: (B, H, W, C), w: (Co, 3, 3, C), bias:
    (Co,) -> (B, H, W, Co). CPU tensors take the plain version; CUDA tensors
    launch the kernel (bf16 / fp16, C % 8 == 0, Co % 8 == 0) or raise. The
    kernel is forward only: on the card it refuses tensors that need a
    gradient, so that no graph silently loses what lies upstream."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w_ohwi, bias)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3x3: no kernel for device {x.device}")
    if _needs_grad(x, w_ohwi, bias):
        raise RuntimeError(
            "conv3x3: the CUDA kernel has no backward yet (the conv VJP, dx through the forward "
            "kernel with flipped weights and the weight-gradient kernel, is not ported); "
            "call it under torch.no_grad() or on tensors that need no gradient"
        )
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
    conv3x3.launches += 1
    return y


conv3x3.launches = 0

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
