"""CV interfaces and shared generative machinery (counterpart of
`cflearn_tpu/modules/cv/common.py`): the `encoders`, `decoders`,
`generators`, `discriminators` and `auto_regressors` registries with their
`build_*` / `register_*` functions, `DecoderInputs`, `GaussianDistribution`
(the diagonal Gaussian over a latent), `VQCodebook`, the interface bases
(`IEncoder`, `IConditional`, `IDecoder`, `IGenerator`, `IGaussianGenerator`,
`IDiscriminator`, `IAutoRegressor`), `EncoderDecoder` and
`get_latent_resolution`.

The random draws of the generative modules (a VAE's posterior sample, a
GAN's z, a conditional decoder's labels, PixelCNN's categorical samples)
(and a GAN's gradient-penalty mix) go through the `_randn` / `_randint` /
`_uniform` / `_gumbel` methods of `IConditional`,
from the module's `generator` (the `IDLModel`'s "default" generator, which
`from_config` seeds), or PyTorch's global one when it has none. The parity
tests replace these methods on an instance to feed the JAX side's draws."""

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..common import PrefixModules

encoders = PrefixModules("encoders")
decoders = PrefixModules("decoders")
generators = PrefixModules("generators")
discriminators = PrefixModules("discriminators")
auto_regressors = PrefixModules("auto_regressors")


def _make_build(registry: PrefixModules) -> Any:
    def build(name: str, *, config: Optional[Dict[str, Any]] = None, **kwargs: Any) -> nn.Module:
        return registry.build(name, **{**(config or {}), **kwargs})

    return build


build_encoder = _make_build(encoders)
build_decoder = _make_build(decoders)
build_generator = _make_build(generators)
build_discriminator = _make_build(discriminators)
build_auto_regressor = _make_build(auto_regressors)
register_encoder = encoders.register
register_decoder = decoders.register
register_generator = generators.register
register_discriminator = discriminators.register
register_auto_regressor = auto_regressors.register


@dataclasses.dataclass
class DecoderInputs:
    z: torch.Tensor
    labels: Optional[torch.Tensor] = None
    deterministic: bool = False
    apply_tanh: Optional[bool] = None
    kwargs: Optional[Dict[str, Any]] = None

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


class IEncoder(nn.Module):
    """Image -> latent."""

    in_channels: int = 3

    def encode(self, net: torch.Tensor) -> torch.Tensor:
        return self(net)


class IConditional(nn.Module):
    """Optional class conditioning, and the random draws of a generative
    module (see the module docstring)."""

    num_classes: Optional[int] = None
    generator: Optional[torch.Generator] = None

    @property
    def is_conditional(self) -> bool:
        return self.num_classes is not None

    def _device(self) -> torch.device:
        p = next(self.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def _randn(self, shape: Sequence[int]) -> torch.Tensor:
        """N(0, 1) of `shape`, f32, on the module's device."""
        return torch.randn(tuple(shape), generator=self.generator, device=self._device())

    def _randint(self, high: int, shape: Sequence[int]) -> torch.Tensor:
        """Integers in [0, high) of `shape`, on the module's device."""
        return torch.randint(0, high, tuple(shape), generator=self.generator, device=self._device())

    def _uniform(self, shape: Sequence[int]) -> torch.Tensor:
        """U[0, 1) of `shape`, f32, on the module's device."""
        return torch.rand(tuple(shape), generator=self.generator, device=self._device())

    def _gumbel(self, shape: Sequence[int]) -> torch.Tensor:
        """Standard Gumbel noise of `shape`, f32: a categorical sample is the
        argmax of the logits plus it, as `jax.random.categorical` draws."""
        u = torch.rand(tuple(shape), generator=self.generator, device=self._device())
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(u.clamp(tiny, 1.0)))

    def get_sample_labels(self, num_samples: int, class_idx: Optional[int] = None) -> Optional[torch.Tensor]:
        """None for an unconditional module; else `class_idx` for every
        sample, or labels drawn at random (`_randint`; the JAX base class
        draws these from a fixed key, PixelCNN's from its stream)."""
        if self.num_classes is None:
            return None
        if class_idx is not None:
            return torch.full((num_samples,), class_idx, dtype=torch.int32, device=self._device())
        return self._randint(self.num_classes, (num_samples,))


class IDecoder(IConditional):
    """Latent -> image."""

    img_size: Optional[int] = None
    latent_channels: Optional[int] = None
    latent_resolution: Optional[int] = None

    def decode(self, inputs: DecoderInputs) -> torch.Tensor:
        return self(inputs)


class IGenerator(IConditional):
    """A sampling module: `sample(num_samples, labels=...)`."""


class IGaussianGenerator(IGenerator):
    """A generator sampling from a Gaussian latent (the VAE family)."""


class IDiscriminator(nn.Module):
    """Image -> realness logits."""


class IAutoRegressor(IConditional):
    """An autoregressive model over discrete codes."""


class EncoderDecoder(nn.Module):
    """An encoder and a decoder built by name from their registries."""

    def __init__(
        self,
        *,
        encoder: str = "vanilla",
        decoder: str = "vanilla",
        encoder_config: Optional[Dict[str, Any]] = None,
        decoder_config: Optional[Dict[str, Any]] = None,
    ) -> None:
        super().__init__()
        self.encoder = build_encoder(encoder, config=encoder_config)
        self.decoder = build_decoder(decoder, config=decoder_config)


@torch.no_grad()
def get_latent_resolution(encoder: nn.Module, img_size: int) -> int:
    """The spatial size of `encoder.encode`'s latent on an `img_size` image:
    one zero image through it in eval mode (no BatchNorm statistic moves),
    on its device; the JAX package traces it abstractly."""
    in_channels = getattr(encoder, "in_channels", 3)
    p = next(encoder.parameters(), None)
    device = p.device if p is not None else torch.device("cpu")
    training = encoder.training
    encoder.eval()
    try:
        net = encoder.encode(torch.zeros((1, img_size, img_size, in_channels), device=device))
    finally:
        encoder.train(training)
    return net.shape[1]
