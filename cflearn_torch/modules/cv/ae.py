"""The first-stage autoencoders (counterpart of `cflearn_tpu/modules/cv/ae.py`:
`AttnEncoder`, `AttnDecoder`, `AutoEncoderKL`, `AutoEncoderVQ`): the KL
autoencoder's `encode` to the Gaussian posterior, `decode`, and the training
forward that samples the posterior in between; the VQ autoencoder's encode
through its codebook. Both are registered as `generators` ("ae_kl",
"ae_vq"), the names an `LDM` takes for its first stage.
`attention_type="none"` drops every attention (the mid block's too: the
LDM-inpainting first stage), and `resample_with_conv=False` resamples by a
2x2 average pool and a nearest 2x resize without a conv."""

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import register_module
from ..core.attentions import SpatialAttention
from ..core.convs import Downsample, ResidualBlock, UpsampleConv2d, interpolate
from ..layers import Conv, GroupNorm
from .common import GaussianDistribution, VQCodebook, VQCodebookOutput, generators


def _mid(coder: nn.Module, net: torch.Tensor) -> torch.Tensor:
    """The mid block of an encoder or decoder: res, attention (unless
    `attention_type="none"`), res."""
    net = coder.mid_res1(net)
    if coder.mid_attn is not None:
        net = coder.mid_attn(net)
    return coder.mid_res2(net)


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
        dropout: float = 0.0,
        double_z: bool = True,
        attention_type: str = "spatial",
        resample_with_conv: bool = True,
    ) -> None:
        super().__init__()
        channel_multipliers = channel_multipliers or [1, 2, 4, 4]
        attention_resolutions = [] if attention_type == "none" else attention_resolutions or []
        self.conv_in = Conv(in_channels, inner_channels)
        blocks: List[nn.Module] = []
        ch, resolution = inner_channels, img_size
        for i, mult in enumerate(channel_multipliers):
            out_ch = inner_channels * mult
            for _ in range(num_res_blocks):
                blocks.append(ResidualBlock(ch, out_ch, dropout=dropout))
                ch = out_ch
                if resolution in attention_resolutions:
                    blocks.append(SpatialAttention(ch))
            if i != len(channel_multipliers) - 1:
                blocks.append(Downsample(ch, use_conv=resample_with_conv))
                resolution //= 2
        self.blocks = nn.ModuleList(blocks)
        self.mid_res1 = ResidualBlock(ch, ch, dropout=dropout)
        self.mid_attn = SpatialAttention(ch) if attention_type != "none" else None
        self.mid_res2 = ResidualBlock(ch, ch, dropout=dropout)
        self.norm_out = GroupNorm(ch, num_groups=32, eps=1e-6)
        self.conv_out = Conv(ch, 2 * z_channels if double_z else z_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = self.conv_in(x.to(self.conv_in.weight.dtype))
        for block in self.blocks:
            net = block(net)
        return self.conv_out(F.silu(self.norm_out(_mid(self, net))))


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
        dropout: float = 0.0,
        attention_type: str = "spatial",
        resample_with_conv: bool = True,
    ) -> None:
        super().__init__()
        channel_multipliers = channel_multipliers or [1, 2, 4, 4]
        attention_resolutions = [] if attention_type == "none" else attention_resolutions or []
        ch = inner_channels * channel_multipliers[-1]
        self.conv_in = Conv(z_channels, ch)
        self.mid_res1 = ResidualBlock(ch, ch, dropout=dropout)
        self.mid_attn = SpatialAttention(ch) if attention_type != "none" else None
        self.mid_res2 = ResidualBlock(ch, ch, dropout=dropout)
        blocks: List[nn.Module] = []
        resolution = img_size // (2 ** (len(channel_multipliers) - 1))
        for i, mult in reversed(list(enumerate(channel_multipliers))):
            out_ch = inner_channels * mult
            for _ in range(num_res_blocks + 1):
                blocks.append(ResidualBlock(ch, out_ch, dropout=dropout))
                ch = out_ch
                if resolution in attention_resolutions:
                    blocks.append(SpatialAttention(ch))
            if i != 0:
                blocks.append(UpsampleConv2d(ch, ch, factor=2.0) if resample_with_conv else Upsample2x())
                resolution *= 2
        self.blocks = nn.ModuleList(blocks)
        self.norm_out = GroupNorm(ch, num_groups=32, eps=1e-6)
        self.conv_out = Conv(ch, out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        net = _mid(self, self.conv_in(z.to(self.conv_in.weight.dtype)))
        for block in self.blocks:
            net = block(net)
        return self.conv_out(F.silu(self.norm_out(net)))


class Upsample2x(nn.Module):
    """Conv-free nearest 2x upsample (the decoder with `resample_with_conv=False`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return interpolate(x, factor=2.0)


@register_module("ae_kl")
@generators.register("ae_kl")
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
        dropout: float = 0.0,
        attention_type: str = "spatial",
        apply_tanh: bool = False,
        resample_with_conv: bool = True,
    ) -> None:
        super().__init__()
        self.apply_tanh = apply_tanh
        common: Any = dict(
            img_size=img_size, inner_channels=inner_channels, z_channels=z_channels,
            channel_multipliers=channel_multipliers, num_res_blocks=num_res_blocks,
            attention_resolutions=attention_resolutions, dropout=dropout, attention_type=attention_type,
            resample_with_conv=resample_with_conv,
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


@register_module("ae_vq")
@generators.register("ae_vq")
class AutoEncoderVQ(nn.Module):
    """VQ first-stage autoencoder: the encoder's single z, a 1x1 conv to the
    code space, the codebook, and back through a 1x1 conv to the decoder."""

    def __init__(
        self,
        *,
        img_size: int = 256,
        in_channels: int = 3,
        out_channels: int = 3,
        inner_channels: int = 128,
        z_channels: int = 4,
        embedding_channels: int = 4,
        num_code: int = 16384,
        channel_multipliers: Optional[List[int]] = None,
        num_res_blocks: int = 2,
        attention_resolutions: Optional[List[int]] = None,
        dropout: float = 0.0,
        attention_type: str = "spatial",
        apply_tanh: bool = False,
        resample_with_conv: bool = True,
    ) -> None:
        super().__init__()
        self.apply_tanh = apply_tanh
        common: Any = dict(
            img_size=img_size, inner_channels=inner_channels, z_channels=z_channels,
            channel_multipliers=channel_multipliers, num_res_blocks=num_res_blocks,
            attention_resolutions=attention_resolutions, dropout=dropout, attention_type=attention_type,
            resample_with_conv=resample_with_conv,
        )
        self.encoder = AttnEncoder(in_channels=in_channels, double_z=False, **common)
        self.decoder = AttnDecoder(out_channels=out_channels, **common)
        self.to_embedding = Conv(z_channels, embedding_channels, (1, 1))
        self.from_embedding = Conv(embedding_channels, z_channels, (1, 1))
        self.codebook = VQCodebook(num_code, embedding_channels)

    def encode(self, x: torch.Tensor) -> VQCodebookOutput:
        return self.codebook(self.to_embedding(self.encoder(x)))

    def decode(self, z_q: torch.Tensor, *, apply_tanh: Optional[bool] = None) -> torch.Tensor:
        net = self.decoder(self.from_embedding(z_q))
        if self.apply_tanh if apply_tanh is None else apply_tanh:
            net = torch.tanh(net)
        return net

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        out = self.encode(x)
        return {
            "predictions": self.decode(out.z_q),
            "codebook_loss": out.codebook_loss,
            "commitment_loss": out.commitment_loss,
            "indices": out.indices,
        }


# the reference's class names
AttentionEncoder = AttnEncoder
AttentionDecoder = AttnDecoder
AttentionAutoEncoderKL = AutoEncoderKL
AttentionAutoEncoderVQ = AutoEncoderVQ


class IAttentionAutoEncoder(nn.Module):
    """Interface of the SD first-stage autoencoders: `encode` / `decode`
    with an attention mid-block."""
