"""ESRGAN's super-resolution net (counterpart of
`cflearn_tpu/modules/cv/classifier.py`: `RRDB`, `_DenseBlock`, `RRDBNet`,
registered "rrdb"). Its convs are plain `layers.Conv` (`F.conv2d`), as the
JAX package runs them through `nnx.Conv` and never through its conv kernel.
`ImageClassifier`, `PixelCNN` and `Siren` wait for the encoders they build
on."""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import register_module
from ..layers import Conv, resize


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class _DenseBlock(nn.Module):
    def __init__(self, channels: int, growth: int) -> None:
        super().__init__()
        self.convs = nn.ModuleList(Conv(channels + i * growth, growth) for i in range(4))
        self.conv_out = Conv(channels + 4 * growth, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for conv in self.convs:
            feats.append(_lrelu(conv(torch.cat(feats, dim=-1))))
        return x + 0.2 * self.conv_out(torch.cat(feats, dim=-1))


class RRDB(nn.Module):
    """Residual-in-residual dense block."""

    def __init__(self, channels: int, growth: int) -> None:
        super().__init__()
        self.dense_blocks = nn.ModuleList(_DenseBlock(channels, growth) for _ in range(3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = x
        for block in self.dense_blocks:
            net = block(net)
        return x + 0.2 * (net - x)


@register_module("rrdb")
class RRDBNet(nn.Module):
    """ESRGAN 4x super-resolution on NHWC images: the RRDB trunk, then two
    nearest 2x upsamplings, each followed by a conv and a leaky ReLU (0.2)."""

    def __init__(
        self,
        *,
        in_channels: int = 3,
        out_channels: int = 3,
        latent_channels: int = 64,
        growth_channels: int = 32,
        num_blocks: int = 23,
        upscale: int = 4,
    ) -> None:
        super().__init__()
        self.upscale = upscale
        self.conv_first = Conv(in_channels, latent_channels)
        self.body = nn.ModuleList(RRDB(latent_channels, growth_channels) for _ in range(num_blocks))
        self.conv_body = Conv(latent_channels, latent_channels)
        self.conv_up1 = Conv(latent_channels, latent_channels)
        self.conv_up2 = Conv(latent_channels, latent_channels)
        self.conv_hr = Conv(latent_channels, latent_channels)
        self.conv_last = Conv(latent_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv_first(x)
        net = feat
        for block in self.body:
            net = block(net)
        feat = feat + self.conv_body(net)
        for conv in (self.conv_up1, self.conv_up2):
            feat = _lrelu(conv(resize(feat, (feat.shape[1] * 2, feat.shape[2] * 2), "nearest")))
        return self.conv_last(_lrelu(self.conv_hr(feat)))
