"""GAN generators and discriminators (counterpart of
`cflearn_tpu/modules/cv/gan.py`): `VanillaGenerator` (registered "gan"; a
1-D latent, optionally with a label embedding, through `VanillaDecoder1D`
and tanh), and the PatchGAN discriminators `NLayerDiscriminator` (with an
optional class-conditional head), `BasicDiscriminator` ("basic") and
`MultiScaleDiscriminator` ("multi_scale")."""

from typing import Any, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import register_module
from ..layers import BatchNorm, Conv, Embed, resize_bilinear
from .common import IConditional, discriminators, generators
from .decoder import VanillaDecoder1D

_PAD = [(1, 1), (1, 1)]
LEAKY_SLOPE = 0.2  # `jax.nn.leaky_relu(x, 0.2)`; `F.leaky_relu` defaults to 0.01


@register_module("gan")
@generators.register("gan")
class VanillaGenerator(IConditional):
    """z ~ N(0, 1) of `latent_dim` (with `num_classes`, concatenated with its
    label's embedding) through `VanillaDecoder1D`, then tanh."""

    def __init__(
        self,
        *,
        img_size: int = 64,
        out_channels: int = 3,
        latent_dim: int = 128,
        latent_resolution: int = 8,
        num_classes: Optional[int] = None,
        norm_type: Optional[str] = "batch_norm",
    ) -> None:
        super().__init__()
        self.latent_dim = latent_dim
        self.num_classes = num_classes
        in_dim = latent_dim
        self.label_embed = None
        if num_classes is not None:
            self.label_embed = Embed(num_classes, latent_dim)
            in_dim = latent_dim * 2
        self.decoder = VanillaDecoder1D(
            img_size=img_size, out_channels=out_channels, latent_dim=in_dim, latent_resolution=latent_resolution,
            norm_type=norm_type,
        )

    def decode(self, z: torch.Tensor, *, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.label_embed is not None:
            assert labels is not None, "a conditional generator needs labels"
            z = torch.cat([z, self.label_embed(labels.reshape(-1).long()).to(z.dtype)], dim=-1)
        return torch.tanh(self.decoder(z))

    def sample(self, num_samples: int, *, labels: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decode `z`, drawn N(0, 1) (`_randn`) when not given."""
        if z is None:
            z = self._randn((num_samples, self.latent_dim))
        return self.decode(z, labels=labels)

    def forward(self, num_samples_or_z: Any, *, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        if isinstance(num_samples_or_z, int):
            return self.sample(num_samples_or_z, labels=labels)
        return self.decode(num_samples_or_z, labels=labels)


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator over NHWC images: `num_layers` 4x4 convs with
    padding (1, 1) (stride 2, the last stride 1), a `BatchNorm` after every
    conv but the first, leaky ReLU 0.2, then a 4x4 conv to one logit map.
    With `num_classes`, a class head on the same features: a 4x4 conv to
    `num_classes` maps, averaged over the pixels (`forward_with_cond`)."""

    def __init__(
        self, *, in_channels: int = 3, num_layers: int = 3, start_channels: int = 64, num_classes: Optional[int] = None
    ) -> None:
        super().__init__()
        blocks: List[nn.Module] = []
        norms: List[Optional[nn.Module]] = []
        ch, out = in_channels, start_channels
        for i in range(num_layers):
            stride = 2 if i < num_layers - 1 else 1
            blocks.append(Conv(ch, out, (4, 4), strides=(stride, stride), padding=_PAD))
            norms.append(BatchNorm(out) if i > 0 else None)
            ch = out
            out = min(start_channels * 8, out * 2)
        self.blocks = nn.ModuleList(blocks)
        # an `nn.ModuleDict` keyed by the layer index: the first conv has no
        # norm, and the parameters keep the JAX package's paths (norms.1.scale)
        self.norms = nn.ModuleDict({str(i): norm for i, norm in enumerate(norms) if norm is not None})
        self.conv_out = Conv(ch, 1, (4, 4), padding=_PAD)
        self.num_classes = num_classes
        self.cond = Conv(ch, num_classes, (4, 4), padding=_PAD) if num_classes is not None else None

    def features(self, x: torch.Tensor) -> torch.Tensor:
        net = x
        for i, conv in enumerate(self.blocks):
            net = conv(net)
            if str(i) in self.norms:
                net = self.norms[str(i)](net)
            net = F.leaky_relu(net, LEAKY_SLOPE)
        return net

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.features(x))

    def forward_with_cond(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(patch logits, class logits or None) from one pass of the features."""
        feature_map = self.features(x)
        cond_logits = None if self.cond is None else self.cond(feature_map).mean(dim=(1, 2))
        return self.conv_out(feature_map), cond_logits


@discriminators.register("basic")
class BasicDiscriminator(NLayerDiscriminator):
    pass


@discriminators.register("multi_scale")
class MultiScaleDiscriminator(nn.Module):
    """`num_scales` PatchGANs, each on the image halved once more than the
    last (`jax.image.resize` "bilinear", which antialiases when it shrinks);
    returns their logit maps, largest first."""

    def __init__(self, *, in_channels: int = 3, num_scales: int = 3, num_layers: int = 3, start_channels: int = 64) -> None:
        super().__init__()
        self.nets = nn.ModuleList(
            [
                NLayerDiscriminator(in_channels=in_channels, num_layers=num_layers, start_channels=start_channels)
                for _ in range(num_scales)
            ]
        )

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        net = x
        for i, d in enumerate(self.nets):
            outs.append(d(net))
            if i != len(self.nets) - 1:
                net = resize_bilinear(net, net.shape[1] // 2, net.shape[2] // 2)
        return outs


GAN = VanillaGenerator
