"""3x3 conv ops: the implicit-GEMM CUDA kernels and the conv dispatcher.

Counterpart of `cflearn_tpu/ops/conv.py`:

* `conv3x3` — wrapper of the hand-written Hopper kernel
  (`csrc/conv3x3.cu`: wgmma fed by TMA, see `conv3x3_plan`), which
  replaces the TPU's `_conv3x3_kernel`
  (`conv3x3_pallas`, fold=False). On a CPU tensor it runs
  `conv3x3_plain`, the same 9 shifted f32 matmuls in plain PyTorch; on a
  CUDA tensor it launches the kernel or raises. Under a trace it goes
  through `conv3x3_op`, an operation of PyTorch's dispatcher (plain version
  for the CPU, kernel for CUDA, a fake implementation) that `torch.export`
  keeps. Where an input needs a gradient it goes through
  `Conv3x3Function`, the JAX package's conv VJP: dx is the forward kernel
  on dy with `flip_weights(w)`, dw the weight-gradient kernel, db a sum of
  dy in f32.
* `conv3x3_wgrad` — wrapper of the weight-gradient kernel
  (`csrc/conv3x3_wgrad.cu`: wgmma fed by TMA, see `wgrad_plan`), which
  replaces `_conv3x3_wgrad_kernel`
  (`conv3x3_wgrad_pallas`); `conv3x3_wgrad_plain` is its plain version. The
  JAX package keeps its kernel behind `CFLEARN_TPU_WGRAD_PALLAS` because XLA's
  weight gradient was faster on its chip; that is a measurement of that chip,
  not a semantic, so here every conv whose forward was routed to the kernel
  takes both kernels in its backward.
* `conv3x3_fold` — wrapper of the dj-folded kernel (`csrc/conv3x3_fold.cu`:
  wgmma fed by TMA, one x box feeding all three dj taps, see
  `conv3x3_fold_plan`), which replaces `_conv3x3_kernel_fold`
  (`conv3x3_pallas(fold=True)`): the same conv as three products 3C deep
  over (dj, channel). `conv3x3_fold_plain` is its plain version; the
  previous design, the mma.sync implicit GEMM, stays reachable as the
  yardstick through `kernel="mma_sync"`. `conv3x3(..., fold=None)` reads
  the module default `FOLD` (False, as the JAX package defaults `fold`).
* `conv3x3_w8a8` — the dynamically quantised W8A8 conv: `quantize_w8a8`, the
  wrapper of the one-launch quantiser (`csrc/quantize_w8a8.cu`: the
  per-tensor activation scale, the per-output-channel weight scales, both
  int8 tensors and the combined scale), as the JAX package quantises outside
  its kernel, then `conv3x3_int8`, the wrapper of the int8 kernel
  (`csrc/conv3x3_w8a8.cu`: s8 wgmma fed by TMA, see `conv3x3_w8a8_plan`),
  which replaces `_conv3x3_kernel_q`. `w8a8_operands` (`quantize_activation`
  and `quantize_weight`) and `conv3x3_int8_plain` / `conv3x3_w8a8_plain` are
  the plain versions: the same quantisation, the int8 taps summed exactly,
  then the kernel's epilogue. The previous design of the int8 kernel, the
  mma.sync implicit GEMM, stays reachable as the yardstick through
  `kernel="mma_sync"`.
* `use_kernel_conv` / `conv_call` — the dispatcher with the predicates of
  the JAX package's `use_pallas_conv` and `_shape_wins`: bf16/fp16, C and
  Co >= 64, and H*W >= 128^2 or the pinned (64, 64, 512, 512) shape. Every
  other conv runs through `F.conv2d`, as the JAX package leaves it to XLA.
  `quantized=True` (default `W8A8_DEFAULT`, from `CFLEARN_TORCH_CONV_W8A8`)
  sends the routed convs through W8A8 instead.

* `conv3x3_plan` / `wgrad_plan` / `conv3x3_fold_plan` / `conv3x3_w8a8_plan`
  — the host's tile planner of the four wgmma kernels: which spatial box of
  pixels a tile is, how many output channels it takes, how many CTAs run, how
  K is split and (the fold) its x boxes and rings. Plain Python, so that the
  CPU tests hold its coverage and TMA's box limits.

Tensors are NHWC; weights are the port's OIHW, and (Co, 3, 3, C) at the
kernels (where the JAX package has (3, 3, C, Co)).
"""

import functools
import os
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..device import SM_COUNT, sm_count, stream_ptr
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


def conv3x3_fold_plain(
    x: torch.Tensor, w_ohwi: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The fold kernel's function in plain PyTorch: the three horizontal taps
    side by side on the channel axis, then three f32 products 3C deep,
    y[b,i,j] = sum over di of [x[b,i+di-1,j-1], x[b,i+di-1,j], x[b,i+di-1,j+1]]
    @ w[:, di].reshape(Co, 3C).T (zero halo), plus the bias in f32, cast to
    x's dtype."""
    b, h, w, c = x.shape
    co = w_ohwi.shape[0]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    xc = torch.cat([xp[:, :, dj : dj + w, :] for dj in range(3)], dim=-1)  # (B, H+2, W, 3C)
    wf = w_ohwi.float().reshape(co, 3, 3 * c)
    acc = None
    for di in range(3):
        part = xc[:, di : di + h].reshape(-1, 3 * c) @ wf[:, di].T
        acc = part if acc is None else acc + part
    if bias is not None:
        acc = acc + bias.float()
    return acc.reshape(b, h, w, co).to(x.dtype)


# ---- the tile planner of the Hopper kernels `conv3x3` and `conv3x3_wgrad` ----

BOX_CHANNELS = 64  # channels per TMA box: 128 bytes of 16-bit values, the 128-byte swizzle's row
TMA_BOX_MAX = 256  # the largest extent of a TMA box in any dimension
CONV_PIXELS = 128  # output pixels per forward tile: two consumer warpgroups x 64 wgmma rows
WGRAD_PIXELS = 64  # pixels per K step of the weight gradient: columns of one image row
WGRAD_BM = WGRAD_BN = 128  # output x input channels of one weight-gradient CTA, per tap
_WGRAD_MIN_KT = 8  # least K steps per split: below it the partial sums cost more than they spread


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pixel_box(h: int, w: int, pixels: int) -> Tuple[int, int]:
    """(th, tw): the box of th x tw = `pixels` pixels of one image, tw a
    power of two >= 8, that covers an h x w image in the fewest boxes (the
    widest box among ties). Its pixels past the image's edge are TMA's zero
    fill on load and are not stored."""
    best = None
    tw = pixels
    while tw >= 8:
        th = pixels // tw
        n = _cdiv(h, th) * _cdiv(w, tw)
        if best is None or n < best[0]:
            best = (n, th, tw)
        tw //= 2
    return best[1], best[2]


class ConvPlan(NamedTuple):
    th: int  # box rows of an output tile
    tw: int  # box columns
    bn: int  # output channels per tile
    m_tiles: int  # pixel boxes over the batch
    n_tiles: int  # output-channel tiles
    ctas: int  # persistent CTAs, each walking tiles `ctas` apart


@functools.lru_cache(maxsize=1024)
def conv3x3_plan(b: int, h: int, w: int, c: int, co: int, sms: int = SM_COUNT) -> ConvPlan:
    """The forward kernel's tiles at x (b, h, w, c) -> co channels: a
    128-pixel box, and 256 output channels per tile where the grid still
    fills the card (each byte loaded from L2 then does 85 operations, not
    64), else 128."""
    th, tw = pixel_box(h, w, CONV_PIXELS)
    m_tiles = b * _cdiv(h, th) * _cdiv(w, tw)
    bn = 256 if co > 128 and m_tiles * _cdiv(co, 256) >= sms else 128
    n_tiles = _cdiv(co, bn)
    return ConvPlan(th, tw, bn, m_tiles, n_tiles, min(m_tiles * n_tiles, sms))


def box_pixels(h: int, w: int, th: int, tw: int, m: int):
    """The pixels (b, i, j) inside an h x w image of box `m` of th x tw, the
    boxes numbered as the kernels walk them: columns fastest, then rows, then
    the batch. A forward tile's box is its index // `n_tiles`, a K step's its
    index."""
    rows_t, cols_t = _cdiv(h, th), _cdiv(w, tw)
    j0, i0, b = (m % cols_t) * tw, (m // cols_t % rows_t) * th, m // (cols_t * rows_t)
    return [(b, i0 + r // tw, j0 + r % tw) for r in range(th * tw) if i0 + r // tw < h and j0 + r % tw < w]


class WgradPlan(NamedTuple):
    k_tiles: int  # K steps over the batch: one image row of WGRAD_PIXELS columns each
    units: int  # CTAs per split: 3 tap rows x output-channel tiles x input-channel tiles
    splits: int  # contiguous ranges of K steps, each its own CTAs and workspace slice
    per: int  # K steps per split (the last may have fewer)


def _wgrad_units(c: int, co: int) -> int:
    """Weight-gradient CTAs per split: 3 tap rows x output- x input-channel tiles."""
    return 3 * _cdiv(co, WGRAD_BM) * _cdiv(c, WGRAD_BN)


def wgrad_splits(k_tiles: int, c: int, co: int, sms: int = SM_COUNT) -> int:
    """Into how many contiguous ranges of its `k_tiles` K steps the
    weight-gradient kernel splits the contraction: the split whose CTAs
    (one per SM at a time, at most two waves) keep the largest share of the
    SMs busy, the fewest splits among ties, at least `_WGRAD_MIN_KT` K steps
    a split; every split non-empty."""
    units = _wgrad_units(c, co)
    best, best_fill = 1, 0.0
    for splits in range(1, min(k_tiles // _WGRAD_MIN_KT, 2 * sms // units) + 1):
        fill = units * splits / (_cdiv(units * splits, sms) * sms)
        if fill > best_fill:
            best, best_fill = splits, fill
    per = _cdiv(k_tiles, best)
    return _cdiv(k_tiles, per)


@functools.lru_cache(maxsize=1024)
def wgrad_plan(b: int, h: int, w: int, c: int, co: int, sms: int = SM_COUNT) -> WgradPlan:
    """The weight-gradient kernel's tiles at x (b, h, w, c), dy (b, h, w, co).
    A K step is the box of one image row and WGRAD_PIXELS columns (1 x 64);
    x comes as one box two pixels wider than dy's, whose three shifted
    windows feed the three taps dj."""
    kt = b * h * _cdiv(w, WGRAD_PIXELS)
    splits = wgrad_splits(kt, c, co, sms)
    return WgradPlan(kt, _wgrad_units(c, co), splits, _cdiv(kt, splits))


# the fold kernel's rings (`csrc/conv3x3_fold.cu`): x boxes of up to 2 x 66 or 1 x 130 pixels rounded to the
# 1024-byte swizzle atom, and as many weight tiles of BN rows as the rest of its shared memory holds
FOLD_A_STAGES = 3
FOLD_A_STRIDE = 17 * 1024
_FOLD_SMEM_BUDGET = 220 * 1024
SWIZZLE_ATOM = 1024
FOLD_BOXES = ((1, 128), (2, 64))  # (th, tw): a consumer's 64 tile rows lie in one image row of the x box


class FoldPlan(NamedTuple):
    kernel: str  # "sm90" (wgmma + TMA) or "mma_sync" (the previous design, `conv3x3_igemm.cuh`: the yardstick)
    th: int  # box rows of an output tile (sm90; 0 for mma_sync)
    tw: int  # box columns (64 or 128)
    bn: int  # output channels per tile
    m_tiles: int  # pixel tiles over the batch
    n_tiles: int  # output-channel tiles
    ctas: int  # CTAs: persistent, each walking tiles `ctas` apart (mma_sync: one per tile)
    x_box: Tuple[int, ...]  # sm90: the x box (channels, columns, rows), two columns wider than the tile
    k_slices: int  # 64-channel slices of each dj tap (sm90: zero past C; each tap padded on its own)
    a_stages: int  # sm90: x boxes in flight
    b_stages: int  # sm90: weight tiles in flight (one per dj)
    smem: int  # dynamic shared memory bytes of a CTA


def fold_x_row0(g: int, tw: int) -> int:
    """The row of the x box that holds consumer warpgroup `g`'s first pixel at
    dj = 0 (the kernel's `a_row0`); tap dj's operand is the 64 box rows from
    there plus dj."""
    return (g * 64 // tw) * (tw + 2) + (g * 64) % tw


@functools.lru_cache(maxsize=1024)
def conv3x3_fold_plan(
    b: int, h: int, w: int, c: int, co: int, sms: int = SM_COUNT, kernel: Optional[str] = None
) -> FoldPlan:
    """The fold kernel's tiles at x (b, h, w, c) -> co channels: a 128-pixel
    box of 1 x 128 or 2 x 64 (the fewer boxes, the wider among ties), so that
    each consumer's 64 rows are consecutive rows of an x box two columns
    wider; 256 output channels per tile where the grid still fills the card,
    else 128, as `conv3x3_plan`. `kernel="mma_sync"` plans the previous
    design, 128 x 128 tiles of one CTA each."""
    if kernel not in (None, "sm90", "mma_sync"):
        raise ValueError(f"conv3x3_fold_plan: kernel {kernel!r} is not 'sm90' or 'mma_sync'")
    k_slices = _cdiv(c, BOX_CHANNELS)
    if kernel == "mma_sync":
        m_tiles, n_tiles = _cdiv(b * h * w, CONV_PIXELS), _cdiv(co, 128)
        return FoldPlan("mma_sync", 0, 0, 128, m_tiles, n_tiles, m_tiles * n_tiles, (), k_slices, 3, 0,
                        3 * (128 + 128) * 80)
    th, tw = min(FOLD_BOXES, key=lambda box: (_cdiv(h, box[0]) * _cdiv(w, box[1]), -box[1]))
    m_tiles = b * _cdiv(h, th) * _cdiv(w, tw)
    bn = 256 if co > 128 and m_tiles * _cdiv(co, 256) >= sms else 128
    n_tiles = _cdiv(co, bn)
    b_bytes = bn * BOX_CHANNELS * 2
    b_stages = (_FOLD_SMEM_BUDGET - FOLD_A_STAGES * FOLD_A_STRIDE) // b_bytes
    smem = FOLD_A_STAGES * FOLD_A_STRIDE + b_stages * b_bytes + 2 * (FOLD_A_STAGES + b_stages) * 8 + SWIZZLE_ATOM
    return FoldPlan("sm90", th, tw, bn, m_tiles, n_tiles, min(m_tiles * n_tiles, sms), (BOX_CHANNELS, tw + 2, th),
                    k_slices, FOLD_A_STAGES, b_stages, smem)


# the int8 kernel's tiles (`csrc/conv3x3_w8a8.cu`): 128 int8 channels fill the 128-byte swizzled row of a box; a
# tile is 128 pixels by 128 output channels, owned by one of two ping-ponged consumer warpgroups, each of which
# stages its dequantised 16-bit output tile in shared memory for a TMA store
W8A8_BOX_CHANNELS = 128
W8A8_BN = 128
W8A8_STAGES = 5
W8A8_OUT_BYTES = CONV_PIXELS * W8A8_BN * 2


class W8A8Plan(NamedTuple):
    th: int  # box rows of an output tile
    tw: int  # box columns
    bn: int  # output channels per tile
    m_tiles: int  # pixel tiles over the batch
    n_tiles: int  # output-channel tiles
    ctas: int  # CTAs: persistent, each walking tiles `ctas` apart, its consumers every other one
    k_slices: int  # 128-channel slices of each tap (zero past C)
    stages: int  # (x box, weight box) stages in the ring
    smem: int  # dynamic shared memory bytes of a CTA: the ring, two staged output tiles, the barriers


@functools.lru_cache(maxsize=1024)
def conv3x3_w8a8_plan(b: int, h: int, w: int, c: int, co: int, sms: int = SM_COUNT) -> W8A8Plan:
    """The s8 wgmma kernel's tiles at x (b, h, w, c) -> co channels: a
    128-pixel box (`pixel_box`) by 128 output channels, one CTA an SM walking
    them. (The mma.sync yardstick, `conv3x3_int8(kernel="mma_sync")`, plans
    its own tiles in `conv3x3_igemm.cuh`.)"""
    th, tw = pixel_box(h, w, CONV_PIXELS)
    m_tiles = b * _cdiv(h, th) * _cdiv(w, tw)
    n_tiles = _cdiv(co, W8A8_BN)
    stage = (CONV_PIXELS + W8A8_BN) * W8A8_BOX_CHANNELS
    smem = W8A8_STAGES * stage + 2 * W8A8_OUT_BYTES + 2 * W8A8_STAGES * 8 + SWIZZLE_ATOM
    return W8A8Plan(th, tw, W8A8_BN, m_tiles, n_tiles, min(m_tiles * n_tiles, sms), _cdiv(c, W8A8_BOX_CHANNELS),
                    W8A8_STAGES, smem)


def _needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _check_conv_args(
    name: str, x: torch.Tensor, w_ohwi: torch.Tensor, bias: Optional[torch.Tensor], dtypes: Any, multiple: int
) -> Tuple[int, int, int, int, int]:
    """What every conv kernel refuses: another device, dtype or layout, or a
    channel count that is not a whole number of 16-byte chunks."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    if x.ndim != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    co = w_ohwi.shape[0]
    if x.dtype not in dtypes or w_ohwi.dtype != x.dtype:
        raise TypeError(f"{name} kernel takes x and w of one dtype in {list(dtypes)}; got {x.dtype}, {w_ohwi.dtype}")
    if tuple(w_ohwi.shape) != (co, 3, 3, c) or (bias is not None and tuple(bias.shape) != (co,)):
        raise ValueError(f"{name}: x {tuple(x.shape)} w {tuple(w_ohwi.shape)}")
    if c % multiple != 0 or co % 8 != 0:
        raise ValueError(f"{name} kernel takes C % {multiple} == 0 and Co % 8 == 0; got C={c}, Co={co}")
    return bsz, h, w, c, co


def _no_plan(*dims: Any) -> Tuple[int, ...]:
    return ()


def _launch_forward(
    name: str, counter: Any, x: torch.Tensor, w_ohwi: torch.Tensor, bias: Optional[torch.Tensor],
    plan: Callable[..., Tuple[int, ...]] = _no_plan,
) -> torch.Tensor:
    """Check the arguments and launch forward kernel `name` ("conv3x3",
    "conv3x3_fold" or its yardstick "conv3x3_fold_mma_sync") on CUDA
    tensors; `plan(b, h, w, c, co, device)` gives the kernel's arguments
    after Co, and `counter` holds the launch count."""
    bsz, h, w, c, co = _check_conv_args(name, x, w_ohwi, bias, _DTYPES, 8)
    if bias is not None and bias.dtype != x.dtype:
        raise TypeError(f"{name} kernel takes bf16/fp16 x, w, bias of one dtype; got bias {bias.dtype}")
    x = x.contiguous()
    w_ohwi = w_ohwi.contiguous()
    bias = None if bias is None else bias.contiguous()
    y = torch.empty((bsz, h, w, co), dtype=x.dtype, device=x.device)
    fn = _native.library(name)
    err = fn(
        _DTYPES[x.dtype], x.data_ptr(), w_ohwi.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        bsz, h, w, c, co, *plan(bsz, h, w, c, co, x.device), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _native.check(err, name)
    _native.count_launch(counter)
    return y


def _conv3x3_tiles(b: int, h: int, w: int, c: int, co: int, device: torch.device) -> Tuple[int, ...]:
    """The wgmma kernel's (box rows, box columns, output channels per tile, CTAs) on `device`."""
    p = conv3x3_plan(b, h, w, c, co, sm_count(device.index))
    return p.th, p.tw, p.bn, p.ctas


def _kernel_conv3x3(x: torch.Tensor, w_ohwi: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return _launch_forward("conv3x3", _WRAPPER, x, w_ohwi, bias, _conv3x3_tiles)


def _launch_conv3x3(x: torch.Tensor, w_ohwi: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The conv kernel on CUDA tensors (any other device raises): launched
    directly, or under a trace (`torch.export`, `torch.compile`) through
    `conv3x3_op`, which the trace keeps as one node."""
    if torch.compiler.is_compiling():
        return conv3x3_op(x, w_ohwi, bias)
    return _kernel_conv3x3(x, w_ohwi, bias)


def _fold_tiles(b: int, h: int, w: int, c: int, co: int, device: torch.device) -> Tuple[int, ...]:
    """The fold kernel's (box rows, box columns, output channels per tile, CTAs) on `device`."""
    p = conv3x3_fold_plan(b, h, w, c, co, sm_count(device.index))
    return p.th, p.tw, p.bn, p.ctas


def _launch_conv3x3_fold(
    x: torch.Tensor, w_ohwi: torch.Tensor, bias: Optional[torch.Tensor], kernel: Optional[str] = None
) -> torch.Tensor:
    if kernel not in (None, "sm90", "mma_sync"):
        raise ValueError(f"conv3x3_fold: kernel {kernel!r} is not 'sm90' or 'mma_sync'")
    if kernel == "mma_sync":
        return _launch_forward("conv3x3_fold_mma_sync", _FOLD_WRAPPER, x, w_ohwi, bias)
    return _launch_forward("conv3x3_fold", _FOLD_WRAPPER, x, w_ohwi, bias, _fold_tiles)


# the default of `conv3x3(fold=None)`: the JAX package defaults `fold` to False
FOLD = False


@torch.library.custom_op("cflearn_torch::conv3x3", mutates_args=(), device_types="cpu")
def conv3x3_op(x: torch.Tensor, w_ohwi: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The conv forward as one operation of PyTorch's dispatcher: the plain
    version registered for the CPU, the kernel for CUDA (which counts the
    launch) and a fake implementation for tracing, so that `torch.export`
    keeps it in its graph on either device."""
    return conv3x3_plain(x, w_ohwi, bias)


@conv3x3_op.register_kernel("cuda")
def _conv3x3_cuda(x, w_ohwi, bias):  # type: ignore[no-untyped-def]
    return _kernel_conv3x3(x, w_ohwi, bias)


@conv3x3_op.register_fake
def _conv3x3_fake(x, w_ohwi, bias):  # type: ignore[no-untyped-def]
    return x.new_empty((*x.shape[:3], w_ohwi.shape[0]))


def conv3x3(
    x: torch.Tensor, w_ohwi: torch.Tensor, bias: Optional[torch.Tensor] = None, fold: Optional[bool] = None
) -> torch.Tensor:
    """3x3 stride-1 SAME conv. x: (B, H, W, C), w: (Co, 3, 3, C), bias:
    (Co,) -> (B, H, W, Co). CPU tensors take the plain version; CUDA
    tensors launch the kernel (bf16 / fp16, C % 8 == 0, Co % 8 == 0); any
    other device raises. Under a trace a call without a gradient goes
    through `conv3x3_op` on either device. A call whose inputs need a
    gradient goes through `Conv3x3Function` on the card and through the
    plain version (autograd runs through it) on the CPU. `fold` (default
    `FOLD`) takes the dj-folded kernel, `conv3x3_fold`."""
    if FOLD if fold is None else fold:
        return conv3x3_fold(x, w_ohwi, bias)
    if x.device.type == "cpu":
        if torch.compiler.is_compiling() and not _needs_grad(x, w_ohwi, bias):
            return conv3x3_op(x, w_ohwi, bias)
        return conv3x3_plain(x, w_ohwi, bias)
    if _needs_grad(x, w_ohwi, bias):
        return Conv3x3Function.apply(x, w_ohwi, bias)
    return _launch_conv3x3(x, w_ohwi, bias)


conv3x3.launches = 0
# the counter's holder, whatever a caller may have bound the module's name to
_WRAPPER = conv3x3


def conv3x3_fold(
    x: torch.Tensor, w_ohwi: torch.Tensor, bias: Optional[torch.Tensor] = None, *, kernel: Optional[str] = None
) -> torch.Tensor:
    """The conv of `conv3x3` through the dj-folded kernel: CPU tensors take
    `conv3x3_fold_plain`; CUDA tensors launch the wgmma + TMA kernel (or
    `kernel="mma_sync"`, the previous design, as a yardstick; bf16 / fp16,
    C % 8 == 0, Co % 8 == 0) or raise. A forward kernel: on the card a call
    whose inputs need a gradient goes through `Conv3x3Function` with the
    folded forward (its backward is the one of `conv3x3`)."""
    if x.device.type == "cpu":
        return conv3x3_fold_plain(x, w_ohwi, bias)
    if _needs_grad(x, w_ohwi, bias):
        return Conv3x3Function.apply(x, w_ohwi, bias, True)
    return _launch_conv3x3_fold(x, w_ohwi, bias, kernel)


conv3x3_fold.launches = 0
_FOLD_WRAPPER = conv3x3_fold

# the largest C whose int32 sums stay exact: 127 * 127 * 9 * C < 2^31
W8A8_MAX_C = (2**31 - 1) // (127 * 127 * 9)
# the default of `conv_call(quantized=None)`, as `CFLEARN_TPU_CONV_W8A8` sets it for the JAX package
W8A8_DEFAULT = bool(int(os.environ.get("CFLEARN_TORCH_CONV_W8A8", "0")))


# f32(1 / 127) and f32(1e-12), as Python floats
_INV_127 = float(np.float32(1.0 / 127.0))
_EPS = float(np.float32(1e-12))


def _quant_scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 + 1e-12 as the JAX package's jitted quantiser computes it:
    XLA turns the division by a constant into the product with the f32
    reciprocal and fuses it with the add into one multiply-add, rounded once
    to f32. The f64 product of two f32 values is exact, so the f64 sum
    rounded to f32 gives the same value."""
    return (amax.double() * _INV_127 + _EPS).float()


def _to_int8(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """t / scale in f32, rounded half to even, clipped to +-127, as int8: one
    f32 copy, updated in place."""
    q = t.to(torch.float32, copy=True)
    return q.div_(scale).round_().clamp_(-127, 127).to(torch.int8)


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: s_x = max|x| / 127 + 1e-12 (`_quant_scale`;
    the maximum is exact in x's dtype), then x / s_x in f32 rounded half to
    even and clipped to +-127. Returns (int8 x, the 0-d f32 scale); nothing
    leaves the device."""
    s_x = _quant_scale(torch.linalg.vector_norm(x, float("inf")).float())
    return _to_int8(x, s_x), s_x


def quantize_weight(w_ohwi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a (Co, 3, 3, C) weight: s_w[co] =
    max over (di, dj, c) of |w| / 127 + 1e-12 (`_quant_scale`). Returns
    (int8 w, the (Co,) f32 scales)."""
    s_w = _quant_scale(torch.linalg.vector_norm(w_ohwi, float("inf"), dim=(1, 2, 3)).float())
    return _to_int8(w_ohwi, s_w[:, None, None, None]), s_w


def w8a8_operands(x: torch.Tensor, w_ohwi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(int8 x, int8 w, the (Co,) f32 combined scale s_x * s_w)."""
    x8, s_x = quantize_activation(x)
    w8, s_w = quantize_weight(w_ohwi)
    return x8, w8, (s_x * s_w).float()


def conv3x3_int8_plain(
    x8: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor], out_dtype: torch.dtype
) -> torch.Tensor:
    """The int8 kernel's function in plain PyTorch: the nine taps of the int8
    values summed exactly (int64 products on the CPU, f64 on the card: exact
    below 2^53), then the kernel's epilogue: f32(sum) * scale[co] in f32, one
    cast to `out_dtype`, + bias in `out_dtype`."""
    b, h, w, c = x8.shape
    acc_dtype = torch.int64 if x8.device.type == "cpu" else torch.float64
    xp = F.pad(x8.to(acc_dtype), (0, 0, 1, 1, 1, 1))
    wf = w8.to(acc_dtype)
    acc = None
    for di in range(3):
        for dj in range(3):
            part = xp[:, di : di + h, dj : dj + w, :].reshape(-1, c) @ wf[:, di, dj, :].T
            acc = part if acc is None else acc + part
    out = (acc.float() * scale.float()).to(out_dtype)
    if bias is not None:
        out = out + bias.to(out_dtype)
    return out.reshape(b, h, w, -1)


def conv3x3_w8a8_plain(
    x: torch.Tensor, w_ohwi: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """`conv3x3_w8a8` in plain PyTorch: the same quantisation, then
    `conv3x3_int8_plain`, out in x's dtype."""
    return conv3x3_int8_plain(*w8a8_operands(x, w_ohwi), bias, x.dtype)


# the quantiser's CTAs (`csrc/quantize_w8a8.cu`): 512 threads, two an SM, all resident (one grid barrier)
QUANT_THREADS = 512
QUANT_CTAS_PER_SM = 2


def quantize_ctas(n: int, co: int, sms: int = SM_COUNT) -> int:
    """The quantiser's cooperative grid for an activation of `n` values and
    `co` weight rows: two CTAs an SM, fewer where the chunks of 8 values and
    the rows give them less to do than one chunk a thread or one row a CTA."""
    return max(1, min(QUANT_CTAS_PER_SM * sms, max(_cdiv(n // 8, QUANT_THREADS), co)))


def quantize_w8a8(x: torch.Tensor, w_ohwi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`w8a8_operands` — (int8 x, int8 w, the (Co,) f32 combined scale
    s_x * s_w) — bit for bit. CPU tensors take the plain version; CUDA
    tensors launch the one-launch quantiser (bf16 / fp16 x and w of one
    dtype, C % 8 == 0) or raise. Nothing leaves the device."""
    if x.device.type == "cpu":
        return w8a8_operands(x, w_ohwi)
    name = "quantize_w8a8"
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or w_ohwi.dtype != x.dtype:
        raise TypeError(f"{name} kernel takes bf16/fp16 x and w of one dtype; got {x.dtype}, {w_ohwi.dtype}")
    c, co = x.shape[-1], w_ohwi.shape[0]
    if x.ndim != 4 or tuple(w_ohwi.shape) != (co, 3, 3, c) or c % 8 != 0:
        raise ValueError(f"{name} kernel takes x (B, H, W, C), w (Co, 3, 3, C), C % 8 == 0; got x "
                         f"{tuple(x.shape)} w {tuple(w_ohwi.shape)}")
    x, w_ohwi = x.contiguous(), w_ohwi.contiguous()
    ctas = quantize_ctas(x.numel(), co, sm_count(x.device.index))
    x8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    w8 = torch.empty(w_ohwi.shape, dtype=torch.int8, device=x.device)
    # the scale and, past it, the CTAs' partial maxima (scratch): one allocation, as the host's time counts here
    scratch = torch.empty((co + ctas,), dtype=torch.float32, device=x.device)
    scale = scratch[:co]
    fn = _native.library(name)
    err = fn(
        _DTYPES[x.dtype], x.data_ptr(), w_ohwi.data_ptr(), x8.data_ptr(), w8.data_ptr(), scale.data_ptr(),
        scratch.data_ptr() + 4 * co, x.numel() // 8, co, 9 * c // 8, ctas, stream_ptr(x.device),
    )
    _native.check(err, name)
    _native.count_launch(_QUANT_WRAPPER)
    return x8, w8, scale


quantize_w8a8.launches = 0
_QUANT_WRAPPER = quantize_w8a8


def _w8a8_tiles(b: int, h: int, w: int, c: int, co: int, device: torch.device) -> Tuple[int, ...]:
    """The s8 wgmma kernel's (box rows, box columns, CTAs) on `device`."""
    p = conv3x3_w8a8_plan(b, h, w, c, co, sm_count(device.index))
    return p.th, p.tw, p.ctas


def conv3x3_int8(
    x8: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor], out_dtype: torch.dtype,
    *, kernel: Optional[str] = None,
) -> torch.Tensor:
    """The int8 conv on quantised operands: x8 (B, H, W, C) int8, w8 (Co, 3,
    3, C) int8, scale (Co,) f32, bias (Co,) -> (B, H, W, Co) in `out_dtype`.
    CPU tensors take the plain version; CUDA tensors launch the s8 wgmma +
    TMA kernel (or `kernel="mma_sync"`, the previous design, as a yardstick;
    bf16 / fp16 out, C % 16 == 0, Co % 8 == 0, C <= W8A8_MAX_C) or raise.
    The launch counts on `conv3x3_w8a8`."""
    if kernel not in (None, "sm90", "mma_sync"):
        raise ValueError(f"conv3x3_int8: kernel {kernel!r} is not 'sm90' or 'mma_sync'")
    if x8.device.type == "cpu":
        return conv3x3_int8_plain(x8, w8, scale, bias, out_dtype)
    name = "conv3x3_w8a8"
    bsz, h, w, c, co = _check_conv_args(name, x8, w8, bias, (torch.int8,), 16)
    if out_dtype not in _DTYPES or (bias is not None and bias.dtype != out_dtype):
        raise TypeError(f"{name} kernel writes bf16/fp16 with a bias of that dtype; got {out_dtype}, {bias}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (co,):
        raise ValueError(f"{name}: scale {scale.dtype} {tuple(scale.shape)}, want f32 ({co},)")
    if c > W8A8_MAX_C:
        raise ValueError(f"{name}: C={c} > {W8A8_MAX_C}, the int32 sums would not stay exact")
    x8, w8, scale = x8.contiguous(), w8.contiguous(), scale.contiguous()
    bias = None if bias is None else bias.contiguous()
    y = torch.empty((bsz, h, w, co), dtype=out_dtype, device=x8.device)
    plan = () if kernel == "mma_sync" else _w8a8_tiles(bsz, h, w, c, co, x8.device)
    fn = _native.library(name + "_mma_sync" if kernel == "mma_sync" else name)
    err = fn(
        _DTYPES[out_dtype], x8.data_ptr(), w8.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        bsz, h, w, c, co, *plan, stream_ptr(x8.device),
    )
    _native.check(err, name)
    _native.count_launch(_W8A8_WRAPPER)
    return y


def conv3x3_w8a8(
    x: torch.Tensor, w_ohwi: torch.Tensor, bias: Optional[torch.Tensor] = None, *, kernel: Optional[str] = None
) -> torch.Tensor:
    """Dynamically quantised W8A8 3x3 stride-1 SAME conv (the JAX package's
    `conv3x3_w8a8`): per-tensor activation scale, per-output-channel weight
    scale, the int8 kernel with its in-kernel dequantisation, out in x's
    dtype. On the card: one quantiser launch (`quantize_w8a8`) and one conv
    launch (`kernel="mma_sync"`: the previous design), nothing else. An
    inference route: on the card it refuses inputs that need a gradient."""
    if x.device.type == "cuda" and _needs_grad(x, w_ohwi, bias):
        raise RuntimeError("conv3x3_w8a8: the W8A8 route has no gradient; call it under torch.no_grad()")
    return conv3x3_int8(*quantize_w8a8(x, w_ohwi), bias, x.dtype, kernel=kernel)


conv3x3_w8a8.launches = 0
_W8A8_WRAPPER = conv3x3_w8a8

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
    plan = wgrad_plan(bsz, h, w, c, co, sm_count(x.device.index))
    ws = torch.empty((plan.splits, co, 9, c), dtype=torch.float32, device=x.device)
    out = torch.empty((co, 3, 3, c), dtype=x.dtype, device=x.device)
    fn = _native.library("conv3x3_wgrad")
    err = fn(
        _DTYPES[x.dtype], x.data_ptr(), dy.data_ptr(), ws.data_ptr(), out.data_ptr(),
        bsz, h, w, c, co, plan.splits, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _native.check(err, "conv3x3_wgrad")
    _native.count_launch(_WGRAD_WRAPPER)
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
    def forward(ctx, x, w_ohwi, bias, fold=False):  # type: ignore[override]
        ctx.save_for_backward(x, w_ohwi)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return (_launch_conv3x3_fold if fold else _launch_conv3x3)(x, w_ohwi, bias)

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
        return dx, dw, db, None


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


def conv_call(conv: Any, x: torch.Tensor, *, quantized: Optional[bool] = None) -> torch.Tensor:
    """Run a port `Conv` module on NHWC `x` through the kernel where the
    predicate routes it, else through the module itself (`F.conv2d`).
    `quantized` (default `W8A8_DEFAULT`) sends the routed convs through
    `conv3x3_w8a8`: an inference-serving trade of some output fidelity for
    int8 tensor-core rates."""
    plain = tuple(conv.dilation) == (1, 1) and conv.groups == 1
    if plain and use_kernel_conv(x, conv.weight, conv.strides, conv.padding):
        w = conv.kernel_weight()
        bias = conv.bias
        x = x.to(w.dtype)
        if W8A8_DEFAULT if quantized is None else quantized:
            return conv3x3_w8a8(x, w, bias)
        return conv3x3(x, w, bias)
    return conv(x)
