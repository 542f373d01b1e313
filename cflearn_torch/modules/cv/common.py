"""Shared generative machinery (counterpart of
`cflearn_tpu/modules/cv/common.py`): the `generators` and `discriminators`
registries, `GaussianDistribution`, the diagonal Gaussian over the KL
autoencoder's latents, and `VQCodebook`, the VQ autoencoder's codebook. The
other registries and the interface bases are not ported yet."""

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from ..common import PrefixModules

generators = PrefixModules("generators")
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


@dataclasses.dataclass
class VQCodebookOutput:
    z_q: torch.Tensor
    indices: torch.Tensor
    codebook_loss: torch.Tensor
    commitment_loss: torch.Tensor


VQCodebookOut = VQCodebookOutput


class VQCodebook(nn.Module):
    """Nearest-code lookup with the straight-through estimator. `embedding`
    (num_codes, code_dim) is drawn from U(-1 / num_codes, 1 / num_codes).

    Each vector of z's last axis takes the code of least squared distance
    |z|^2 - 2 z.c + |c|^2 (the first of equal ones); `codebook_loss` =
    mean((sg(z) - z_q)^2) moves the codes, `commitment_loss` = mean((z -
    sg(z_q))^2) the encoder; the z_q returned is z + sg(z_q - z), whose
    gradient passes to z unchanged."""

    def __init__(self, num_codes: int, code_dim: int, *, beta: float = 0.25) -> None:
        super().__init__()
        self.num_codes = num_codes
        self.code_dim = code_dim
        self.beta = beta
        scale = 1.0 / num_codes
        self.embedding = nn.Parameter(torch.empty(num_codes, code_dim).uniform_(-scale, scale))

    def forward(self, z: torch.Tensor) -> VQCodebookOutput:
        codes = self.embedding
        flat = z.reshape(-1, self.code_dim)
        d = flat.square().sum(dim=1, keepdim=True) - 2.0 * (flat @ codes.t()) + codes.square().sum(dim=1)[None]
        indices = d.argmin(dim=1)
        z_q = codes[indices].reshape(z.shape)
        codebook_loss = (z.detach() - z_q).square().mean()
        commitment_loss = (z - z_q.detach()).square().mean()
        z_q = z + (z_q - z).detach()
        return VQCodebookOutput(z_q, indices.reshape(z.shape[:-1]), codebook_loss, commitment_loss)

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        return self.embedding[indices]
