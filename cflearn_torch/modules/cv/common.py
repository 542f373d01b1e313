"""Shared generative machinery (counterpart of
`cflearn_tpu/modules/cv/common.py`): the `discriminators` registry and
`GaussianDistribution`, the diagonal Gaussian over the KL autoencoder's
latents. `VQCodebook`, the other registries and the interface bases are not
ported yet."""

from typing import Optional

import torch

from ..common import PrefixModules

discriminators = PrefixModules("discriminators")

_LOG_2PI = 1.8378770664093453


class GaussianDistribution:
    """Diagonal Gaussian from `params` = (mean, log-variance) stacked on the
    last axis; the log-variance is clipped to [-30, 20]."""

    def __init__(self, params: torch.Tensor, *, deterministic: bool = False) -> None:
        mean, logvar = params.chunk(2, dim=-1)
        self.mean = mean
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.deterministic = deterministic
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(
        self, generator: Optional[torch.Generator] = None, *, noise: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """mean + std * noise. The JAX package draws the noise from a key;
        here it comes from an explicit `generator` (in the mean's dtype, on
        its device), or the caller hands over `noise` itself."""
        if self.deterministic:
            return self.mean
        if noise is None:
            noise = torch.randn(
                self.mean.shape, generator=generator, device=self.mean.device, dtype=self.mean.dtype
            )
        return self.mean + self.std * noise.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: Optional["GaussianDistribution"] = None) -> torch.Tensor:
        """KL to `other` (default: the standard normal), summed per sample."""
        if self.deterministic:
            return torch.zeros((), device=self.mean.device)
        axes = tuple(range(1, self.mean.ndim))
        if other is None:
            return 0.5 * (self.mean.square() + self.var - 1.0 - self.logvar).sum(dim=axes)
        return 0.5 * (
            (self.mean - other.mean).square() / other.var
            + self.var / other.var
            - 1.0
            - self.logvar
            + other.logvar
        ).sum(dim=axes)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(1, self.mean.ndim))
        return 0.5 * (_LOG_2PI + self.logvar + (sample - self.mean).square() / self.var).sum(dim=axes)
