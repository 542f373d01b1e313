"""The SD first-stage KL autoencoder (counterpart of
`cflearn_tpu/modules/cv/ae.py`: `AttnEncoder`, `AttnDecoder`,
`AutoEncoderKL`): `encode` to the Gaussian posterior, `decode`, and the
training forward that samples the posterior in between."""

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import register_module
from ..core.attentions import SpatialAttention
from ..core.convs import Downsample, ResidualBlock, UpsampleConv2d
from ..layers import Conv, GroupNorm
from .common import GaussianDistribution


class AttnEncoder(nn.Module):
    """Conv encoder: down blocks + mid attention."""

    def __init__(
        self,
        *,
        img_size: int = 256,
        in_channels: int = 3,
        inner_channels: int = 128,
        z_channels: int = 4,
        channel_multipliers: Optional[List[int]] = None,
        num_res_blocks: int = 2,
        attention_resolutions: Optional[List[int]] = None,
        double_z: bool = True,
    ) -> None:
        super().__init__()
        channel_multipliers = channel_multipliers or [1, 2, 4, 4]
        attention_resolutions = attention_resolutions or []
        self.conv_in = Conv(in_channels, inner_channels)
        blocks: List[nn.Module] = []
        ch, resolution = inner_channels, img_size
        for i, mult in enumerate(channel_multipliers):
            out_ch = inner_channels * mult
            for _ in range(num_res_blocks):
                blocks.append(ResidualBlock(ch, out_ch))
                ch = out_ch
                if resolution in attention_resolutions:
                    blocks.append(SpatialAttention(ch))
            if i != len(channel_multipliers) - 1:
                blocks.append(Downsample(ch))
                resolution //= 2
        self.blocks = nn.ModuleList(blocks)
        self.mid_res1 = ResidualBlock(ch, ch)
        self.mid_attn = SpatialAttention(ch)
        self.mid_res2 = ResidualBlock(ch, ch)
        self.norm_out = GroupNorm(ch, num_groups=32, eps=1e-6)
        self.conv_out = Conv(ch, 2 * z_channels if double_z else z_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = self.conv_in(x.to(self.conv_in.weight.dtype))
        for block in self.blocks:
            net = block(net)
        net = self.mid_res2(self.mid_attn(self.mid_res1(net)))
        return self.conv_out(F.silu(self.norm_out(net)))


class AttnDecoder(nn.Module):
    """Conv decoder: mid attention + up blocks (the SD VAE decoder)."""

    def __init__(
        self,
        *,
        img_size: int = 256,
        out_channels: int = 3,
        inner_channels: int = 128,
        z_channels: int = 4,
        channel_multipliers: Optional[List[int]] = None,
        num_res_blocks: int = 2,
        attention_resolutions: Optional[List[int]] = None,
    ) -> None:
        super().__init__()
        channel_multipliers = channel_multipliers or [1, 2, 4, 4]
        attention_resolutions = attention_resolutions or []
        ch = inner_channels * channel_multipliers[-1]
        self.conv_in = Conv(z_channels, ch)
        self.mid_res1 = ResidualBlock(ch, ch)
        self.mid_attn = SpatialAttention(ch)
        self.mid_res2 = ResidualBlock(ch, ch)
        blocks: List[nn.Module] = []
        resolution = img_size // (2 ** (len(channel_multipliers) - 1))
        for i, mult in reversed(list(enumerate(channel_multipliers))):
            out_ch = inner_channels * mult
            for _ in range(num_res_blocks + 1):
                blocks.append(ResidualBlock(ch, out_ch))
                ch = out_ch
                if resolution in attention_resolutions:
                    blocks.append(SpatialAttention(ch))
            if i != 0:
                blocks.append(UpsampleConv2d(ch, ch, factor=2.0))
                resolution *= 2
        self.blocks = nn.ModuleList(blocks)
        self.norm_out = GroupNorm(ch, num_groups=32, eps=1e-6)
        self.conv_out = Conv(ch, out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        net = self.conv_in(z.to(self.conv_in.weight.dtype))
        net = self.mid_res2(self.mid_attn(self.mid_res1(net)))
        for block in self.blocks:
            net = block(net)
        return self.conv_out(F.silu(self.norm_out(net)))


@register_module("ae_kl")
class AutoEncoderKL(nn.Module):
    """SD first-stage KL autoencoder."""

    def __init__(
        self,
        *,
        img_size: int = 256,
        in_channels: int = 3,
        out_channels: int = 3,
        inner_channels: int = 128,
        z_channels: int = 4,
        embedding_channels: int = 4,
        channel_multipliers: Optional[List[int]] = None,
        num_res_blocks: int = 2,
        attention_resolutions: Optional[List[int]] = None,
        apply_tanh: bool = False,
    ) -> None:
        super().__init__()
        self.apply_tanh = apply_tanh
        common: Any = dict(
            img_size=img_size, inner_channels=inner_channels, z_channels=z_channels,
            channel_multipliers=channel_multipliers, num_res_blocks=num_res_blocks,
            attention_resolutions=attention_resolutions,
        )
        self.encoder = AttnEncoder(in_channels=in_channels, **common)
        self.decoder = AttnDecoder(out_channels=out_channels, **common)
        self.to_embedding = Conv(2 * z_channels, 2 * embedding_channels, (1, 1))
        self.from_embedding = Conv(embedding_channels, z_channels, (1, 1))

    def encode(self, x: torch.Tensor, *, deterministic: bool = False) -> GaussianDistribution:
        return GaussianDistribution(self.to_embedding(self.encoder(x)), deterministic=deterministic)

    def decode(self, z: torch.Tensor, *, apply_tanh: Optional[bool] = None) -> torch.Tensor:
        net = self.decoder(self.from_embedding(z))
        if self.apply_tanh if apply_tanh is None else apply_tanh:
            net = torch.tanh(net)
        return net

    def forward(
        self,
        x: torch.Tensor,
        *,
        sample: bool = True,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """Encode, sample the posterior (its mode with `sample=False`) and
        decode. The JAX module draws the posterior noise from its own key
        stream; here it comes from `generator`, or the caller hands over
        `noise` (the latent's shape)."""
        dist = self.encode(x)
        z = dist.sample(generator, noise=noise) if sample else dist.mode()
        return {"predictions": self.decode(z), "distribution": dist, "z": z}
