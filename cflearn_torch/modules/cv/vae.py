"""The VAE and the VQ-VAE (counterpart of `cflearn_tpu/modules/cv/vae.py`):
`VanillaVAE` (registered "vae"; a Gaussian 1-D latent, optionally
class-conditional decoding) and `VQVAE` ("vq_vae"; a codebook over the
encoder's feature map, `get_code`, `reconstruct_from`, `sample_codebook`),
and `reparameterize`. Their random draws go through `IConditional`'s
`_randn` / `_randint`: a conditional decode without labels draws them, as
in the JAX package."""

from typing import Any, Dict, Optional, Tuple

import torch

from ...constants import PREDICTIONS_KEY
from ...toolkit.contexts import auto_num_layers
from ..common import register_module
from ..core.high_level import ChannelPadding
from .common import DecoderInputs, GaussianDistribution, IConditional, VQCodebook, VQCodebookOutput, generators
from .decoder import VanillaDecoder, VanillaDecoder1D
from .encoder import VanillaEncoder, VanillaEncoder1D


@register_module("vae")
@generators.register("vae")
class VanillaVAE(IConditional):
    """`VanillaEncoder1D` to 2 x latent_dim (mean and log-variance), a sample
    of the posterior, `VanillaDecoder1D` back. The forward returns the
    reconstruction, mu, log_var, the KL to N(0, 1) per sample and z."""

    def __init__(
        self,
        *,
        img_size: int = 64,
        in_channels: int = 3,
        out_channels: Optional[int] = None,
        latent_dim: int = 128,
        num_downsample: int = 3,
        num_classes: Optional[int] = None,
        apply_tanh: bool = False,
        cond_channels: int = 16,
    ) -> None:
        super().__init__()
        self.latent_dim = latent_dim
        self.num_classes = num_classes
        self.apply_tanh = apply_tanh
        self.encoder = VanillaEncoder1D(
            img_size=img_size, in_channels=in_channels, latent_dim=latent_dim * 2, num_downsample=num_downsample
        )
        self.decoder = VanillaDecoder1D(
            img_size=img_size, out_channels=out_channels or in_channels, latent_dim=latent_dim,
            num_classes=num_classes, cond_channels=cond_channels, apply_tanh=apply_tanh,
        )

    def encode(self, x: torch.Tensor) -> GaussianDistribution:
        return GaussianDistribution(self.encoder(x))

    def decode(
        self, z: torch.Tensor, *, labels: Optional[torch.Tensor] = None, apply_tanh: Optional[bool] = None
    ) -> torch.Tensor:
        if labels is None and self.num_classes is not None:
            labels = self._randint(self.num_classes, (z.shape[0],))
        return self.decoder(DecoderInputs(z=z, labels=labels, apply_tanh=apply_tanh))

    def sample(
        self,
        num_samples: int,
        *,
        labels: Optional[torch.Tensor] = None,
        class_idx: Optional[int] = None,
        z: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Decode `z` (drawn N(0, 1) when not given); `class_idx` sets the
        labels of a conditional model."""
        if z is None:
            z = self._randn((num_samples, self.latent_dim))
        if labels is None and class_idx is not None:
            labels = self.get_sample_labels(num_samples, class_idx)
        return self.decode(z, labels=labels)

    def reconstruct(self, x: torch.Tensor, *, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self(x, labels)[PREDICTIONS_KEY]

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        dist = self.encode(x)
        z = dist.sample(noise=self._randn(dist.mean.shape))
        if self.num_classes is None:
            labels = None
        return {
            PREDICTIONS_KEY: self.decode(z, labels=labels),
            "mu": dist.mean,
            "log_var": dist.logvar,
            "kl": dist.kl(),
            "z": z,
        }


@register_module("vq_vae")
@generators.register("vq_vae")
class VQVAE(IConditional):
    """`VanillaEncoder` to a `code_dimension` map, `VQCodebook` of
    `num_codes`, `VanillaDecoder` back (`num_downsample` from the image size
    down to `min_size` unless given), an optional `ChannelPadding` of the
    codes before decoding."""

    def __init__(
        self,
        *,
        img_size: int = 64,
        in_channels: int = 3,
        out_channels: Optional[int] = None,
        num_codes: Optional[int] = None,
        num_code: Optional[int] = None,
        code_dimension: Optional[int] = None,
        latent_channels: Optional[int] = None,
        num_downsample: Optional[int] = None,
        min_size: int = 8,
        num_classes: Optional[int] = None,
        latent_padding_channels: Optional[int] = None,
        apply_tanh: bool = False,
        cond_channels: int = 16,
    ) -> None:
        super().__init__()
        num_codes = num_codes if num_codes is not None else (num_code or 512)
        code_dimension = code_dimension if code_dimension is not None else (latent_channels or 128)
        if num_downsample is None:
            num_downsample = auto_num_layers(img_size, min_size=min_size)
        self.num_classes = num_classes
        self.apply_tanh = apply_tanh
        self.code_dimension = code_dimension
        self.encoder = VanillaEncoder(
            img_size=img_size, in_channels=in_channels, latent_channels=code_dimension, num_downsample=num_downsample
        )
        self.codebook = VQCodebook(num_codes, code_dimension)
        self.latent_resolution = img_size // (2**num_downsample)
        self.decoder = VanillaDecoder(
            img_size=img_size, out_channels=out_channels or in_channels, latent_channels=code_dimension,
            num_upsample=num_downsample, num_classes=num_classes, latent_resolution=self.latent_resolution,
            cond_channels=cond_channels, apply_tanh=apply_tanh,
        )
        self.latent_padding = None
        if latent_padding_channels is not None:
            self.latent_padding = ChannelPadding(code_dimension, latent_padding_channels, self.latent_resolution)
        self.num_codes = num_codes

    @property
    def num_code(self) -> int:
        return self.num_codes

    @property
    def latent_channels(self) -> int:
        return self.code_dimension

    def encode(self, x: torch.Tensor) -> VQCodebookOutput:
        return self.codebook(self.encoder(x))

    def get_code_indices(self, net: torch.Tensor) -> torch.Tensor:
        return self.encode(net).indices

    def get_code(self, code_indices: torch.Tensor) -> torch.Tensor:
        """Indices (B, H, W), (B, H, W, 1) or (B, 1, H, W) -> z_q (B, H, W, C)."""
        if code_indices.ndim == 4:
            if code_indices.shape[-1] == 1:
                code_indices = code_indices[..., 0]
            elif code_indices.shape[1] == 1:
                code_indices = code_indices[:, 0]
            else:
                raise ValueError(f"4-D code indices need a singleton channel axis, got {tuple(code_indices.shape)}")
        return self.codebook.lookup(code_indices.long())

    def decode(
        self, z_q: torch.Tensor, *, labels: Optional[torch.Tensor] = None, apply_tanh: Optional[bool] = None
    ) -> torch.Tensor:
        if labels is None and self.num_classes is not None:
            labels = self._randint(self.num_classes, (z_q.shape[0],))
        if self.latent_padding is not None:
            z_q = self.latent_padding(z_q)
        return self.decoder(DecoderInputs(z=z_q, labels=labels, apply_tanh=apply_tanh))

    def decode_indices(self, indices: torch.Tensor, **kwargs: Any) -> torch.Tensor:
        return self.decode(self.get_code(indices), **kwargs)

    def reconstruct_from(
        self,
        code_indices: torch.Tensor,
        *,
        labels: Optional[torch.Tensor] = None,
        class_idx: Optional[int] = None,
        use_one_hot: bool = False,
        **kwargs: Any,
    ) -> torch.Tensor:
        """Decode code indices; `use_one_hot` keeps only the central code."""
        z_q = self.get_code(code_indices)
        if use_one_hot:
            i, j = int(round(0.5 * z_q.shape[1])), int(round(0.5 * z_q.shape[2]))
            one_hot = torch.zeros_like(z_q)
            one_hot[:, i, j] = z_q[:, i, j]
            z_q = one_hot
        if labels is None:
            labels = self.get_sample_labels(len(z_q), class_idx)
        return self.decode(z_q, labels=labels, **kwargs)

    def sample_codebook(
        self,
        *,
        code_indices: Optional[torch.Tensor] = None,
        num_samples: Optional[int] = None,
        class_idx: Optional[int] = None,
        **kwargs: Any,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each code (drawn when not given) tiled over the latent map and
        decoded, the central one only by default; returns (images, codes)."""
        if code_indices is None:
            if num_samples is None:
                raise ValueError("either `code_indices` or `num_samples` should be provided")
            code_indices = self._randint(self.num_codes, (num_samples,))
        code_indices = torch.as_tensor(code_indices, device=self._device()).reshape(-1)
        r = self.latent_resolution
        tiled = code_indices[:, None, None].expand(-1, r, r)
        if class_idx is not None:
            kwargs["labels"] = self.get_sample_labels(len(code_indices), class_idx)
        kwargs.setdefault("use_one_hot", True)
        return self.reconstruct_from(tiled, **kwargs), code_indices

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        out = self.encode(x)
        if self.num_classes is None:
            labels = None
        return {
            PREDICTIONS_KEY: self.decode(out.z_q, labels=labels),
            "codebook_loss": out.codebook_loss,
            "commitment_loss": out.commitment_loss,
            "indices": out.indices,
        }


def reparameterize(
    mu: torch.Tensor, log_var: torch.Tensor, generator: Optional[torch.Generator] = None,
    *, noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """mu + exp(0.5 log_var) eps, eps ~ N(0, 1) from `generator` or given as `noise`."""
    if noise is None:
        noise = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    return mu + torch.exp(0.5 * log_var) * noise


VAE = VanillaVAE
