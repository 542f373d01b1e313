"""Image classifier, ESRGAN, PixelCNN and SIREN (counterpart of
`cflearn_tpu/modules/cv/classifier.py`): `ImageClassifier` (registered
"clf" and "classifier": an encoder by name and a linear head), `RRDB`,
`_DenseBlock`, `RRDBNet` ("rrdb"), `PixelCNN` ("pixel_cnn", masked 7x7
convs over one-hot codes, with `sample`), `ImgSiren` ("siren"), `Siren`,
`make_grid` and `img_siren_head`. The convs are plain `layers.Conv`
(`F.conv2d`), as the JAX package runs them through `nnx.Conv` and never
through its conv kernel."""

from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import register_module
from ..core.high_level import ChannelPadding
from ..layers import BatchNorm, Conv, Linear, resize
from .common import IAutoRegressor, auto_regressors, encoders


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


@register_module("clf")
@register_module("classifier", allow_duplicate=True)
class ImageClassifier(nn.Module):
    """An encoder from the `encoders` registry and a linear head of
    `latent_dim` -> `num_classes`. `img_size` and `in_channels` go into the
    encoder's config, and `latent_dim` too for "vanilla_1d" and "vit"; as in
    the JAX package, an encoder whose constructor takes no `img_size`
    ("backbone") or whose config names a preset (`name`, "backbone_1d")
    cannot be built through it (a TypeError)."""

    def __init__(
        self,
        *,
        img_size: int = 28,
        in_channels: int = 1,
        num_classes: int = 10,
        encoder: str = "vanilla_1d",
        encoder_config: Optional[dict] = None,
        latent_dim: int = 128,
    ) -> None:
        super().__init__()
        config = dict(encoder_config or {})
        config.setdefault("img_size", img_size)
        config.setdefault("in_channels", in_channels)
        if encoder in ("vanilla_1d", "vit"):
            config.setdefault("latent_dim", latent_dim)
        self.encoder = encoders.build(encoder, **config)
        self.head = Linear(latent_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.encoder(x))


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


class _MaskedConv(nn.Module):
    """A `kernel_size` SAME conv whose kernel is masked to the pixels above
    and to the left of the centre (type "A"), and the centre (type "B").
    The mask is a buffer in the JAX variable's HWIO layout (k, k, 1, 1). As
    the JAX module writes the masked kernel back into its parameter on every
    call, this one re-masks its weight in place (without a gradient) and
    computes with weight x mask, so masked taps get no gradient."""

    def __init__(self, in_ch: int, out_ch: int, mask_type: str, *, kernel_size: int = 7) -> None:
        super().__init__()
        self.conv = Conv(in_ch, out_ch, (kernel_size, kernel_size))
        self.mask_type = mask_type
        self.register_buffer("mask", torch.empty(kernel_size, kernel_size, 1, 1))
        self.reset_buffers()

    def reset_buffers(self) -> None:
        if self.mask.device.type == "meta":
            return
        k = self.mask.shape[0]
        mask = np.zeros((k, k, 1, 1), dtype=np.float32)
        mask[: k // 2] = 1.0
        mask[k // 2, : k // 2] = 1.0
        if self.mask_type == "B":
            mask[k // 2, k // 2] = 1.0
        self.mask.copy_(torch.from_numpy(mask))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mask = self.mask.permute(3, 2, 0, 1)
        weight = self.conv.weight
        with torch.no_grad():
            weight.mul_(mask.to(weight.dtype))
        return self.conv.conv_with(x, weight * mask.to(weight.dtype), self.conv.padding)


@register_module("pixel_cnn")
@auto_regressors.register("pixel_cnn")
class PixelCNN(IAutoRegressor):
    """Masked-conv autoregressive model over integer codes: one-hot planes
    (with `channel_padding`, a global `ChannelPadding`, per class when
    conditional), `num_layers` masked 7x7 convs each with BatchNorm and ReLU,
    a 1x1 conv to `num_codes` logits a pixel."""

    def __init__(
        self,
        *,
        num_codes: int = 256,
        img_size: int = 28,
        in_channels: int = 1,
        latent_channels: int = 128,
        num_layers: int = 6,
        channel_padding: Optional[int] = 16,
        num_classes: Optional[int] = None,
    ) -> None:
        super().__init__()
        self.num_codes = num_codes
        self.img_size = img_size
        self.num_classes = num_classes
        ch = num_codes * in_channels
        self.channel_padding = None
        if channel_padding is not None:
            self.channel_padding = ChannelPadding(ch, channel_padding, num_classes=num_classes)
        elif num_classes is not None:
            raise ValueError("`channel_padding` should be provided when `num_classes` is provided")
        self.convs = nn.ModuleList(
            _MaskedConv(ch if i == 0 else latent_channels, latent_channels, "A" if i == 0 else "B")
            for i in range(num_layers)
        )
        self.norms = nn.ModuleList(BatchNorm(latent_channels) for _ in range(num_layers))
        self.conv_out = Conv(latent_channels, num_codes * in_channels, (1, 1))
        self.in_channels = in_channels

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Integer codes (B, H, W[, C]) -> logits (B, H, W, num_codes)."""
        if x.ndim == 3:
            x = x[..., None]
        onehot = F.one_hot(x.long(), self.num_codes).float()
        b, h, w, c, k = onehot.shape
        net = onehot.reshape(b, h, w, c * k)
        if self.channel_padding is not None:
            net = self.channel_padding(net, labels if self.num_classes is not None else None)
        for conv, norm in zip(self.convs, self.norms):
            net = F.relu(norm(conv(net)))
        return self.conv_out(net)

    @torch.no_grad()
    def sample(
        self,
        num_samples: int,
        *,
        img_size: Optional[int] = None,
        labels: Optional[torch.Tensor] = None,
        class_idx: Optional[int] = None,
    ) -> torch.Tensor:
        """Ancestral sampling: h x w full forwards, each pixel's code drawn
        from its logits (the argmax of logits + `_gumbel` noise, as
        `jax.random.categorical` draws)."""
        h = w = img_size or self.img_size
        if not self.is_conditional:
            labels = None
        elif labels is None:
            labels = self.get_sample_labels(num_samples, class_idx)
        x = torch.zeros((num_samples, h, w, self.in_channels), dtype=torch.int32, device=self._device())
        for i in range(h):
            for j in range(w):
                logits = self(x, labels)[:, i, j]
                x[:, i, j, 0] = (logits + self._gumbel(logits.shape).to(logits.dtype)).argmax(dim=-1).to(x.dtype)
        return x


def _grid(size: int, in_dim: int, device: Any = None) -> torch.Tensor:
    axes = [torch.linspace(-1.0, 1.0, size, device=device) for _ in range(in_dim)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(1, -1, in_dim)


def make_grid(size: int, in_dim: int = 2) -> torch.Tensor:
    """The [-1, 1] coordinate grid flattened to (1, size^in_dim, in_dim)."""
    return _grid(size, in_dim)


def img_siren_head(size: int, out_channels: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """Reshape flat SIREN outputs to an NHWC image."""

    def head(net: torch.Tensor) -> torch.Tensor:
        return net.reshape(net.shape[0], size, size, out_channels)

    return head


class Siren(nn.Module):
    """A sinusoidal coordinate MLP: sin(w_sin x layer) first, sin(layer)
    after, then a linear head."""

    def __init__(
        self, *, in_dim: int = 2, out_dim: int = 3, latent_dim: int = 256, num_layers: int = 5, w_sin: float = 30.0
    ) -> None:
        super().__init__()
        self.layers = nn.ModuleList(Linear(in_dim if i == 0 else latent_dim, latent_dim) for i in range(num_layers))
        self.head = Linear(latent_dim, out_dim)
        self.w_sin = w_sin

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        net = coords
        for i, layer in enumerate(self.layers):
            net = torch.sin((self.w_sin if i == 0 else 1.0) * layer(net))
        return self.head(net)


@register_module("siren")
class ImgSiren(Siren):
    """A SIREN image: the `img_size`^2 grid of 2-D coordinates (when no
    `coords` are given) through `Siren`; `to_image` reshapes and applies tanh."""

    def __init__(
        self, *, img_size: int = 64, in_dim: int = 2, out_channels: int = 3, latent_dim: int = 256,
        num_layers: int = 5, w_sin: float = 30.0,
    ) -> None:
        super().__init__(in_dim=in_dim, out_dim=out_channels, latent_dim=latent_dim, num_layers=num_layers, w_sin=w_sin)
        self.img_size = img_size

    def forward(self, coords: Optional[torch.Tensor] = None) -> torch.Tensor:
        if coords is None:
            coords = _grid(self.img_size, 2, self.head.weight.device)
        return super().forward(coords)

    def to_image(self, out: torch.Tensor) -> torch.Tensor:
        return torch.tanh(out.reshape(out.shape[0], self.img_size, self.img_size, -1))


VanillaClassifier = ImageClassifier
