"""CV encoders (counterpart of `cflearn_tpu/modules/cv/encoder.py`):
"vanilla" and "vanilla_1d" (4x4 stride-2 convs, SAME as XLA pads it, with
BatchNorm and leaky ReLU 0.2), "vit" (patches through a
`MixedStackedEncoder` with a head token), "backbone" (the "simple", "vgg16"
and "mobilenet" conv stacks), the backbone registry (`RepVGG` with its
structural reparameterisation, `MixViT` with spatial-reduction attention)
behind `Backbone`, and "backbone_1d". Channel-last throughout; the norms
are the port's flax-convention `BatchNorm` / `LayerNorm`."""

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...constants import LATENT_KEY
from ..common import register_module
from ..core.convs import SEBlock
from ..core.high_level import VanillaPatchEmbed
from ..core.mixed_stacks import MixedStackedEncoder, MixFeedForward
from ..core.norms import NormFactory
from ..layers import BatchNorm, Conv, LayerNorm, Linear
from .common import encoders


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


@encoders.register("vanilla")
class VanillaEncoder(nn.Module):
    """`num_downsample` x (4x4 stride-2 conv, SAME -> norm -> leaky ReLU
    0.2), widths doubling up to `latent_channels` (at least 16), then a 3x3
    conv to `latent_channels`."""

    def __init__(
        self,
        *,
        img_size: int = 64,
        in_channels: int = 3,
        latent_channels: int = 128,
        num_downsample: int = 2,
        norm_type: Optional[str] = "batch_norm",
    ) -> None:
        super().__init__()
        self.num_downsample = num_downsample
        self.in_channels = in_channels
        blocks: List[nn.Module] = []
        ch = in_channels
        out_ch = max(16, latent_channels // (2 ** max(0, num_downsample - 1)))
        for _ in range(num_downsample):
            blocks.append(Conv(ch, out_ch, (4, 4), strides=(2, 2)))
            blocks.append(NormFactory(norm_type).make(out_ch))
            ch = out_ch
            out_ch = min(latent_channels, out_ch * 2)
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = Conv(ch, latent_channels, (3, 3))
        self.latent_channels = latent_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = x
        for i in range(0, len(self.blocks), 2):
            net = _lrelu(self.blocks[i + 1](self.blocks[i](net)))
        return self.conv_out(net)


@encoders.register("vanilla_1d")
class VanillaEncoder1D(nn.Module):
    """`VanillaEncoder` averaged over the pixels: (B, latent_dim)."""

    def __init__(
        self,
        *,
        img_size: int = 64,
        in_channels: int = 3,
        latent_dim: int = 128,
        num_downsample: int = 3,
        norm_type: Optional[str] = "batch_norm",
    ) -> None:
        super().__init__()
        self.in_channels = in_channels
        self.encoder = VanillaEncoder(
            img_size=img_size, in_channels=in_channels, latent_channels=latent_dim,
            num_downsample=num_downsample, norm_type=norm_type,
        )
        self.latent_dim = latent_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x).mean(dim=(1, 2))


@register_module("vit")
@encoders.register("vit")
class ViTEncoder(nn.Module):
    """ViT: `patch_size` patches of width `latent_dim`, a head token and a
    positional table, `num_layers` attention blocks of `num_heads` heads.
    As in the JAX package, the attention mixer projects to 4 x latent_dim
    (the stack's latent ratio), so a head is 4 x latent_dim / num_heads wide:
    256 at the defaults (ViT-S/16, 384 / 6). Returns the head token's row,
    or every token with `return_tokens`."""

    def __init__(
        self,
        *,
        img_size: int = 224,
        patch_size: int = 16,
        in_channels: int = 3,
        latent_dim: int = 384,
        num_layers: int = 12,
        num_heads: int = 6,
        dropout: float = 0.0,
        pipeline_parallel: bool = False,
        pp_microbatches: Optional[int] = None,
    ) -> None:
        super().__init__()
        self.in_channels = in_channels
        self.patch_embed = VanillaPatchEmbed(img_size, patch_size, in_channels, latent_dim)
        self.encoder = MixedStackedEncoder(
            latent_dim,
            self.patch_embed.num_patches,
            token_mixing_type="attention",
            token_mixing_config={"num_heads": num_heads},
            num_layers=num_layers,
            dropout=dropout,
            use_head_token=True,
            use_positional_encoding=True,
            pipeline_parallel=pipeline_parallel,
            pp_microbatches=pp_microbatches,
        )
        self.latent_dim = latent_dim

    def forward(self, x: torch.Tensor, *, return_tokens: bool = False) -> torch.Tensor:
        return self.encoder(self.patch_embed(x), return_tokens=return_tokens)


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool at stride 2, VALID, of NHWC `x`."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class _VGGStage(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_convs: int) -> None:
        super().__init__()
        self.convs = nn.ModuleList(Conv(in_ch if i == 0 else out_ch, out_ch, (3, 3)) for i in range(num_convs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = F.relu(conv(x))
        return _max_pool2(x)


class _MBConvStage(nn.Module):
    """MobileNet-style: a depthwise stride-2 3x3 conv, a pointwise conv,
    BatchNorm, ReLU6."""

    def __init__(self, in_ch: int, out_ch: int) -> None:
        super().__init__()
        self.dw = Conv(in_ch, in_ch, (3, 3), strides=(2, 2), groups=in_ch)
        self.pw = Conv(in_ch, out_ch, (1, 1))
        self.bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu6(self.bn(self.pw(self.dw(x))))


@register_module("backbone")
@encoders.register("backbone")
class BackboneEncoder(nn.Module):
    """A conv stack by preset name: "simple" (stride-2 3x3 convs with ReLU),
    "vgg16" (VGG stages, max-pooled) or "mobilenet" (`_MBConvStage`s).
    Returns the last feature map, or every stage's with `return_stages`."""

    presets = ("simple", "vgg16", "mobilenet")

    def __init__(self, name: str = "simple", *, in_channels: int = 3, latent_channels: int = 256, num_stages: int = 4) -> None:
        super().__init__()
        self.name = name
        self.in_channels = in_channels
        stages: List[nn.Module] = []
        if name == "vgg16":
            cfg = [(in_channels, 64, 2), (64, 128, 2), (128, 256, 3), (256, 512, 3)][:num_stages]
            stages = [_VGGStage(i, o, n) for i, o, n in cfg]
            ch = cfg[-1][1]
        else:
            ch = in_channels
            out = max(32, latent_channels // (2 ** (num_stages - 1)))
            for _ in range(num_stages):
                stages.append(_MBConvStage(ch, out) if name == "mobilenet" else Conv(ch, out, (3, 3), strides=(2, 2)))
                ch = out
                out = min(latent_channels, out * 2)
        self.stages = nn.ModuleList(stages)
        self.latent_channels = ch

    def forward(self, x: torch.Tensor, *, return_stages: bool = False) -> Any:
        feats = []
        net = x
        for stage in self.stages:
            net = F.relu(stage(net)) if isinstance(stage, Conv) else stage(net)
            feats.append(net)
        return feats if return_stages else net


class BackboneInfo:
    def __init__(self, fn: Any, out_channels: List[int], stage_names: List[str]) -> None:
        self.fn = fn
        self.out_channels = out_channels
        self.stage_names = stage_names


backbone_info_dict: Dict[str, BackboneInfo] = {}


def register_backbone(name: str, out_channels: List[int], stage_names: List[str]) -> Any:
    def _register(fn: Any) -> Any:
        backbone_info_dict[name] = BackboneInfo(fn, out_channels, stage_names)
        return fn

    return _register


def _fuse_bn(kernel: torch.Tensor, bn: BatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """An OIHW kernel followed by eval-mode `bn` as one kernel and bias."""
    std = torch.sqrt(bn.var + bn.eps)
    t = bn.weight / std
    return kernel * t.reshape(-1, 1, 1, 1), bn.bias - bn.mean * t


class RepVGGBlock(nn.Module):
    """RepVGG's block: in training form a 3x3 conv + BatchNorm, a 1x1 conv +
    BatchNorm and (same width, stride 1) an identity BatchNorm, summed, ReLU,
    then a squeeze-excite (`use_post_se`). `switch_to_deploy` fuses the
    three branches, with the norms' running statistics, into one 3x3 conv
    with a bias (`conv_fused`) and drops them."""

    def __init__(self, in_channels: int, out_channels: int, *, stride: int = 1, use_post_se: bool = True) -> None:
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.stride = stride
        self.deploy = False
        self.dense = Conv(in_channels, out_channels, (3, 3), strides=(stride, stride), padding=[(1, 1), (1, 1)],
                          use_bias=False)
        self.dense_bn = BatchNorm(out_channels)
        self.side = Conv(in_channels, out_channels, (1, 1), strides=(stride, stride), use_bias=False)
        self.side_bn = BatchNorm(out_channels)
        self.identity = BatchNorm(out_channels) if out_channels == in_channels and stride == 1 else None
        self.post_se = SEBlock(out_channels, max(1, out_channels // 4)) if use_post_se else None
        self.conv_fused: Optional[Conv] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv_fused is not None:
            net = F.relu(self.conv_fused(x))
        else:
            out = self.dense_bn(self.dense(x)) + self.side_bn(self.side(x))
            if self.identity is not None:
                out = out + self.identity(x)
            net = F.relu(out)
        return net if self.post_se is None else self.post_se(net)

    @torch.no_grad()
    def switch_to_deploy(self) -> None:
        if self.conv_fused is not None:
            return
        k3, b3 = _fuse_bn(self.dense.weight, self.dense_bn)
        k1, b1 = _fuse_bn(F.pad(self.side.weight, (1, 1, 1, 1)), self.side_bn)
        kernel, bias = k3 + k1, b3 + b1
        if self.identity is not None:
            kid = torch.zeros_like(kernel)
            idx = torch.arange(self.in_channels, device=kernel.device)
            kid[idx, idx, 1, 1] = 1.0
            kf, bf = _fuse_bn(kid, self.identity)
            kernel, bias = kernel + kf, bias + bf
        fused = Conv(self.in_channels, self.out_channels, (3, 3), strides=(self.stride, self.stride),
                     padding=[(1, 1), (1, 1)]).to(device=kernel.device, dtype=kernel.dtype)
        fused.weight.copy_(kernel)
        fused.bias.copy_(bias)
        self.conv_fused = fused
        self.dense = self.dense_bn = self.side = self.side_bn = self.identity = None
        self.deploy = True


class RepVGGStage(nn.Module):
    def __init__(self, in_channels: int, latent_channels: int, num_blocks: int, *, stride: int = 1,
                 use_post_se: bool = True) -> None:
        super().__init__()
        strides = [stride] + [1] * (num_blocks - 1)
        self.net = nn.ModuleList(
            RepVGGBlock(in_channels if i == 0 else latent_channels, latent_channels, stride=s, use_post_se=use_post_se)
            for i, s in enumerate(strides)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.net:
            x = block(x)
        return x

    def switch_to_deploy(self) -> None:
        for block in self.net:
            block.switch_to_deploy()


_REP_VGG_STAGES = ("stage1", "stage2", "stage3", "stage4_first", "stage4_second", "stage5")


class RepVGG(nn.Module):
    """RepVGG (the B / lite / large widths by `width_multiplier`)."""

    def __init__(self, num_blocks: List[int], width_multiplier: List[float], *, in_channels: int = 3,
                 use_post_se: bool = True) -> None:
        super().__init__()
        w = width_multiplier
        c0 = min(64, int(64 * w[0]))
        kw = dict(use_post_se=use_post_se)
        self.stage1 = RepVGGBlock(in_channels, c0, stride=2, **kw)
        self.stage2 = RepVGGStage(c0, int(64 * w[0]), num_blocks[0], stride=2, **kw)
        self.stage3 = RepVGGStage(int(64 * w[0]), int(128 * w[1]), num_blocks[1], stride=2, **kw)
        self.stage4_first = RepVGGStage(int(128 * w[1]), int(256 * w[2]), num_blocks[2] // 2, stride=2, **kw)
        self.stage4_second = RepVGGStage(int(256 * w[2]), int(256 * w[2]), num_blocks[2] // 2, stride=1, **kw)
        self.stage5 = RepVGGStage(int(256 * w[2]), int(512 * w[3]), num_blocks[3], stride=2, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in _REP_VGG_STAGES:
            x = getattr(self, name)(x)
        return x

    def switch_to_deploy(self) -> None:
        for name in _REP_VGG_STAGES:
            getattr(self, name).switch_to_deploy()


def _rep_vgg_ctor(num_blocks: List[int], width_multiplier: List[float]) -> Any:
    def ctor(pretrained: bool = False, **kwargs: Any) -> RepVGG:
        if pretrained:
            raise ValueError("`RepVGG` does not support `pretrained`")
        return RepVGG(num_blocks, width_multiplier, **kwargs)

    return ctor


rep_vgg = register_backbone("rep_vgg", [64, 128, 256, 512, 512, 2048], list(_REP_VGG_STAGES))(
    _rep_vgg_ctor([4, 6, 16, 1], [2.0, 2.0, 2.0, 4.0])
)
rep_vgg_lite = register_backbone("rep_vgg_lite", [48, 48, 96, 192, 192, 1280], list(_REP_VGG_STAGES))(
    _rep_vgg_ctor([2, 4, 14, 1], [0.75, 0.75, 0.75, 2.5])
)
rep_vgg_large = register_backbone("rep_vgg_large", [160, 160, 320, 640, 640, 2560], list(_REP_VGG_STAGES))(
    _rep_vgg_ctor([8, 14, 24, 1], [2.5, 2.5, 2.5, 5.0])
)


class OverlapPatchEmbed(nn.Module):
    """MixViT's overlapping patches: a `patch_size` conv at `stride`, padded
    by patch_size // 2, the tokens layer-normed; returns (tokens, (h, w))."""

    def __init__(self, in_channels: int, latent_dim: int, *, patch_size: int, stride: int) -> None:
        super().__init__()
        pad = patch_size // 2
        self.proj = Conv(in_channels, latent_dim, (patch_size, patch_size), strides=(stride, stride),
                         padding=[(pad, pad), (pad, pad)])
        self.norm = LayerNorm(latent_dim)

    def forward(self, x: torch.Tensor) -> Any:
        net = self.proj(x)
        b, h, w, c = net.shape
        return self.norm(net.reshape(b, h * w, c)), (h, w)


class SRAttention(nn.Module):
    """Spatial-reduction attention: k and v from a `reduction_ratio`-strided
    conv (and a LayerNorm) over the feature map. Scores by plain matmul and
    softmax, as the JAX package computes them outside its kernels."""

    def __init__(self, dim: int, num_heads: int, *, reduction_ratio: int = 1) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, dim * 2)
        self.proj = Linear(dim, dim)
        self.reduction_ratio = reduction_ratio
        if reduction_ratio > 1:
            r = reduction_ratio
            self.sr = Conv(dim, dim, (r, r), strides=(r, r))
            self.sr_norm = LayerNorm(dim)
        else:
            self.sr = self.sr_norm = None

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        b, n, c = x.shape
        h, w = hw
        q = self.q(x).reshape(b, n, self.num_heads, self.head_dim)
        kv_in = x
        if self.sr is not None:
            kv_in = self.sr_norm(self.sr(x.reshape(b, h, w, c)).reshape(b, -1, c))
        kv = self.kv(kv_in).reshape(b, -1, 2, self.num_heads, self.head_dim)
        k, v = kv[:, :, 0], kv[:, :, 1]
        attn = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(self.head_dim), dim=-1)
        return self.proj(torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c))


class MixViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, *, reduction_ratio: int, ff_ratio: float) -> None:
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = SRAttention(dim, num_heads, reduction_ratio=reduction_ratio)
        self.norm2 = LayerNorm(dim)
        self.ff = MixFeedForward(dim, int(dim * ff_ratio))

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), hw)
        return x + self.ff(self.norm2(x))


class MixViTStage(nn.Module):
    def __init__(self, in_channels: int, dim: int, *, patch_size: int, stride: int, num_heads: int, num_layers: int,
                 reduction_ratio: int, ff_ratio: float) -> None:
        super().__init__()
        self.embed = OverlapPatchEmbed(in_channels, dim, patch_size=patch_size, stride=stride)
        self.blocks = nn.ModuleList(
            MixViTBlock(dim, num_heads, reduction_ratio=reduction_ratio, ff_ratio=ff_ratio) for _ in range(num_layers)
        )
        self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net, hw = self.embed(x)
        for block in self.blocks:
            net = block(net, hw)
        net = self.norm(net)
        return net.reshape(net.shape[0], hw[0], hw[1], -1)


class MixViT(nn.Module):
    """The hierarchical mix transformer (SegFormer's encoder): one
    `MixViTStage` per width, the first on 7x7 patches at stride 4, the
    others 3x3 at stride 2."""

    def __init__(
        self,
        in_channels: int,
        latent_dims: List[int],
        *,
        num_heads_list: List[int],
        feedforward_dim_ratios: List[float],
        num_layers_list: List[int],
        reduction_ratios: List[int],
    ) -> None:
        super().__init__()
        ch = in_channels
        for i, dim in enumerate(latent_dims):
            patch_size, stride = (7, 4) if i == 0 else (3, 2)
            setattr(self, f"stage{i + 1}", MixViTStage(
                ch, dim, patch_size=patch_size, stride=stride, num_heads=num_heads_list[i],
                num_layers=num_layers_list[i], reduction_ratio=reduction_ratios[i], ff_ratio=feedforward_dim_ratios[i],
            ))
            ch = dim
        self.num_stages = len(latent_dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_stages):
            x = getattr(self, f"stage{i + 1}")(x)
        return x


def _mix_vit_ctor(latent_dims: List[int], num_heads_list: List[int], num_layers_list: List[int]) -> Any:
    def ctor(pretrained: bool = False, *, in_channels: int = 3, **kwargs: Any) -> MixViT:
        if pretrained:
            raise ValueError("`MixViT` does not support `pretrained`")
        return MixViT(
            in_channels, latent_dims, num_heads_list=num_heads_list, feedforward_dim_ratios=[4.0] * len(latent_dims),
            num_layers_list=num_layers_list, reduction_ratios=[8, 4, 2, 1],
        )

    return ctor


_MIX_VIT_STAGES = ["stage1", "stage2", "stage3", "stage4"]
mix_vit = register_backbone("mix_vit", [64, 128, 320, 512], _MIX_VIT_STAGES)(
    _mix_vit_ctor([64, 128, 320, 512], [1, 2, 5, 8], [3, 4, 18, 3])
)
mix_vit_lite = register_backbone("mix_vit_lite", [32, 64, 160, 256], _MIX_VIT_STAGES)(
    _mix_vit_ctor([32, 64, 160, 256], [1, 2, 5, 8], [2, 2, 2, 2])
)
mix_vit_large = register_backbone("mix_vit_large", [64, 128, 320, 512], _MIX_VIT_STAGES)(
    _mix_vit_ctor([64, 128, 320, 512], [1, 2, 5, 8], [3, 6, 40, 3])
)


class Backbone(nn.Module):
    """A registered backbone by name: {stage name: its output, LATENT_KEY:
    the last}."""

    def __init__(self, name: str = "rep_vgg", *, pretrained: bool = False, **kwargs: Any) -> None:
        super().__init__()
        info = backbone_info_dict.get(name)
        if info is None:
            raise ValueError(f"backbone '{name}' is not recognized (available: {sorted(backbone_info_dict)})")
        self.name = name
        self.out_channels = list(info.out_channels)
        self.latent_channels = self.out_channels[-1]
        self.stage_names = list(info.stage_names)
        self.core = info.fn(pretrained, **kwargs)
        self.num_downsample = len(self.stage_names)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        net = x
        for stage_name in self.stage_names:
            net = getattr(self.core, stage_name)(net)
            out[stage_name] = net
        out[LATENT_KEY] = net
        return out


@encoders.register("backbone_1d")
class BackboneEncoder1D(nn.Module):
    """A `Backbone`'s latent averaged over the pixels; `latent_dim` is the
    backbone's last width."""

    def __init__(self, name: str = "rep_vgg", **kwargs: Any) -> None:
        super().__init__()
        self.net = Backbone(name, **kwargs)
        self.latent_dim = self.net.latent_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)[LATENT_KEY].mean(dim=(1, 2))
