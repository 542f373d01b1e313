"""CV decoders (counterpart of `cflearn_tpu/modules/cv/decoder.py`):
"vanilla" (nearest 2x upsample + 3x3 conv, norm, ReLU, repeated, then a 3x3
conv) and "vanilla_1d" (a 1-D latent mapped to a square feature map
first). A conditional decoder (`num_classes`) mixes a per-class learned map
into the latent before upsampling (`ChannelPadding`); `apply_tanh` is off by
default and can be overridden per call by `DecoderInputs.apply_tanh`."""

import math
from typing import Any, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.convs import UpsampleConv2d
from ..core.high_level import ChannelPadding
from ..core.norms import NormFactory
from ..layers import Conv, Linear
from .common import DecoderInputs, decoders


def _resolve_tanh(default: bool, inputs: Any) -> bool:
    if isinstance(inputs, DecoderInputs) and inputs.apply_tanh is not None:
        return inputs.apply_tanh
    return default


@decoders.register("vanilla")
class VanillaDecoder(nn.Module):
    def __init__(
        self,
        *,
        img_size: int = 64,
        out_channels: int = 3,
        latent_channels: int = 128,
        num_upsample: int = 2,
        norm_type: Optional[str] = "batch_norm",
        num_classes: Optional[int] = None,
        latent_resolution: Optional[int] = None,
        cond_channels: int = 16,
        apply_tanh: bool = False,
    ) -> None:
        super().__init__()
        self.num_classes = num_classes
        self.latent_channels = latent_channels
        self.latent_resolution = latent_resolution
        self.apply_tanh = apply_tanh
        self.cond = None
        if num_classes is not None:
            self.cond = ChannelPadding(latent_channels, cond_channels, latent_resolution, num_classes=num_classes)
        blocks: List[nn.Module] = []
        ch = latent_channels
        for _ in range(num_upsample):
            out_ch = max(16, ch // 2)
            blocks.append(UpsampleConv2d(ch, out_ch, factor=2.0))
            blocks.append(NormFactory(norm_type).make(out_ch))
            ch = out_ch
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = Conv(ch, out_channels, (3, 3))

    def inject_cond(self, net: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
        return net if self.cond is None else self.cond(net, labels)

    def forward(self, inputs: Any) -> torch.Tensor:
        if isinstance(inputs, DecoderInputs):
            net = self.inject_cond(inputs.z, inputs.labels)
        else:
            net = self.inject_cond(inputs, None)
        for i in range(0, len(self.blocks), 2):
            net = F.relu(self.blocks[i + 1](self.blocks[i](net)))
        net = self.conv_out(net)
        return torch.tanh(net) if _resolve_tanh(self.apply_tanh, inputs) else net

    def decode(self, inputs: DecoderInputs) -> torch.Tensor:
        return self(inputs)


@decoders.register("vanilla_1d")
class VanillaDecoder1D(nn.Module):
    """A (B, latent_dim) latent through a linear map to a `latent_resolution`
    square map, then `VanillaDecoder` (log2(img_size / latent_resolution)
    upsamples unless given)."""

    def __init__(
        self,
        *,
        img_size: int = 64,
        out_channels: int = 3,
        latent_dim: int = 128,
        latent_resolution: int = 8,
        num_upsample: Optional[int] = None,
        norm_type: Optional[str] = "batch_norm",
        num_classes: Optional[int] = None,
        cond_channels: int = 16,
        apply_tanh: bool = False,
    ) -> None:
        super().__init__()
        self.latent_resolution = latent_resolution
        self.latent_dim = latent_dim
        self.num_classes = num_classes
        self.apply_tanh = apply_tanh
        if num_upsample is None:
            num_upsample = int(math.log2(img_size // latent_resolution))
        self.from_latent = Linear(latent_dim, latent_dim * latent_resolution**2)
        self.decoder = VanillaDecoder(
            img_size=img_size, out_channels=out_channels, latent_channels=latent_dim, num_upsample=num_upsample,
            norm_type=norm_type, num_classes=num_classes, latent_resolution=latent_resolution,
            cond_channels=cond_channels, apply_tanh=False,
        )

    def forward(self, inputs: Any) -> torch.Tensor:
        z, labels = (inputs.z, inputs.labels) if isinstance(inputs, DecoderInputs) else (inputs, None)
        r = self.latent_resolution
        net = self.from_latent(z).reshape(z.shape[0], r, r, self.latent_dim)
        net = self.decoder(DecoderInputs(z=net, labels=labels))
        return torch.tanh(net) if _resolve_tanh(self.apply_tanh, inputs) else net

    def decode(self, inputs: DecoderInputs) -> torch.Tensor:
        return self(inputs)
