"""High-level blocks (counterpart of `cflearn_tpu/modules/core/high_level.py`):
`PreNorm`, `ChannelPadding` (a learned map, per class when conditional,
concatenated to the input and projected back to its width), and the patch
embeddings `VanillaPatchEmbed` (`ImgToPatches`) and `OverlapPatchEmbed`.
Channel-last throughout."""

from typing import Any, Optional

import torch
import torch.nn as nn

from ..layers import Conv, LayerNorm, Linear
from .convs import interpolate


class PreNorm(nn.Module):
    def __init__(self, dim: int, module: nn.Module, *, norm_type: str = "layer_norm") -> None:
        super().__init__()
        from .norms import NormFactory

        self.norm = NormFactory(norm_type).make(dim)
        self.module = module

    def forward(self, x: torch.Tensor, *args: Any, **kwargs: Any) -> torch.Tensor:
        return self.module(self.norm(x), *args, **kwargs)


class ChannelPadding(nn.Module):
    """Concatenate a learned channel map to `x` and project back to
    `in_channels` with a bias-free 1x1 conv (a linear map for `is_1d`).
    `latent_map` is (num_classes or 1, map_dim or 1, map_dim or 1,
    latent_channels): a conditional module picks each sample's map by its
    label (and raises without labels); a global one (no `map_dim`) is
    broadcast over the pixels, another one resized to x's (nearest). A 2-D
    `x` (B, D) takes the map flattened."""

    def __init__(
        self,
        in_channels: int,
        latent_channels: int,
        map_dim: Optional[int] = None,
        *,
        is_1d: bool = False,
        num_classes: Optional[int] = None,
    ) -> None:
        super().__init__()
        self.in_channels = in_channels
        self.latent_channels = latent_channels
        self.latent_dim = latent_channels
        self.map_dim = map_dim
        self.is_global = map_dim is None
        self.is_1d = is_1d
        self.num_classes = num_classes
        self.latent_map = nn.Parameter(torch.empty(num_classes or 1, map_dim or 1, map_dim or 1, latent_channels))
        in_nc = in_channels + latent_channels
        if is_1d:
            self.mapping: nn.Module = Linear(in_nc, in_channels, bias=False)
        else:
            self.mapping = Conv(in_nc, in_channels, (1, 1), use_bias=False)

    @property
    def is_conditional(self) -> bool:
        return self.num_classes is not None

    def init_constants(self) -> None:
        """The map ~ N(0, 1), as the JAX module draws it."""
        with torch.no_grad():
            self.latent_map.mul_(self.latent_map[0].numel() ** 0.5)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = x.shape[0]
        if self.num_classes is None:
            latent = self.latent_map[0].expand(b, *self.latent_map.shape[1:])
        else:
            if labels is None:
                raise ValueError("`labels` should be provided in conditional `ChannelPadding`")
            latent = self.latent_map[labels.reshape(-1).long()]
        if x.ndim == 2:
            net = torch.cat([x, latent.reshape(b, -1).to(x.dtype)], dim=-1)
        else:
            if self.is_global:
                latent = latent.reshape(b, 1, 1, self.latent_channels).expand(b, x.shape[1], x.shape[2], -1)
            elif latent.shape[1] != x.shape[1]:
                latent = interpolate(latent, size=(x.shape[1], x.shape[2]))
            net = torch.cat([x, latent.to(x.dtype)], dim=-1)
        return self.mapping(net)


class VanillaPatchEmbed(nn.Module):
    """ViT patchify: a `patch_size` conv at stride `patch_size`, the patches
    flattened to (B, (img_size / patch_size)^2, latent_dim)."""

    def __init__(
        self, img_size: int, patch_size: int, in_channels: int = 3, latent_dim: int = 128, *, bias: bool = True
    ) -> None:
        super().__init__()
        assert img_size % patch_size == 0
        self.img_size = img_size
        self.patch_size = patch_size
        self.num_patches = (img_size // patch_size) ** 2
        self.projection = Conv(
            in_channels, latent_dim, (patch_size, patch_size), strides=(patch_size, patch_size), use_bias=bias
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = self.projection(x)
        b, h, w, d = net.shape
        return net.reshape(b, h * w, d)


class OverlapPatchEmbed(nn.Module):
    """Overlapping patches: a `patch_size` conv at `stride` (SAME), the
    tokens layer-normed."""

    def __init__(
        self, img_size: int, patch_size: int = 7, stride: int = 4, in_channels: int = 3, latent_dim: int = 64
    ) -> None:
        super().__init__()
        self.projection = Conv(in_channels, latent_dim, (patch_size, patch_size), strides=(stride, stride))
        self.norm = LayerNorm(latent_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = self.projection(x)
        b, h, w, d = net.shape
        return self.norm(net.reshape(b, h * w, d))


ImgToPatches = VanillaPatchEmbed
