"""PatchGAN discriminators (counterpart of `cflearn_tpu/modules/cv/gan.py`:
`NLayerDiscriminator`, `BasicDiscriminator`). The class-conditional head, the
latent-noise generator and `MultiScaleDiscriminator` are not ported yet."""

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm, Conv
from .common import discriminators

_PAD = [(1, 1), (1, 1)]
LEAKY_SLOPE = 0.2  # `jax.nn.leaky_relu(x, 0.2)`; `F.leaky_relu` defaults to 0.01


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator over NHWC images: `num_layers` 4x4 convs with
    padding (1, 1) (stride 2, the last stride 1), a `BatchNorm` after every
    conv but the first, leaky ReLU 0.2, then a 4x4 conv to one logit map."""

    def __init__(self, *, in_channels: int = 3, num_layers: int = 3, start_channels: int = 64) -> None:
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


@discriminators.register("basic")
class BasicDiscriminator(NLayerDiscriminator):
    pass
