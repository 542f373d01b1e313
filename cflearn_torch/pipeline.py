"""The port's entry points.

`txt2img`: the serving path, as `bench.py`'s jitted closure runs it — the
prompts through the CLIP tokenizer, one batched text encode for cond and
uncond, DDIM with batched CFG, the first-stage decode, clip, and uint8. Its
`config` selects one of `bench.py`'s three serving configurations through
`configure`: "lossless"; "faithful" (ToMe 0.5 and DeepCache N=3 at cut 1);
"accelerated" (ToMe 0.5 and DeepCache N=5 at cut 1). The guidance interval
(0.25, 0.70) is opt-in.

`finetune_unet`: the training path — eps-loss steps of the UNet on given
latents and a precomputed text condition, f32 masters with a (bf16) compute
dtype, AdamW.

`train_autoencoder`: the adversarial training of the KL autoencoder — two
scopes per step (the autoencoder, then its PatchGAN discriminator), f32
masters with a (bf16) compute dtype, Adam.
"""

from functools import lru_cache
from typing import Any, Dict, Optional, Tuple

import torch

from .device import resolve_device
from .models.cv.ae import AEModel
from .models.cv.diffusion import INPUT_KEY, LOSS_KEY, DDPMModel
from .modules.core.mixed_stacks import SpatialTransformer
from .modules.multimodal.diffusion.samplers import ISampler
from .modules.nlp.tokenizers import CLIPTokenizer
from .optimizers import build_optimizer
from .trainer import MultiScopeStep, make_train_step

# `bench.py`'s serving configurations: ToMe-SD's standard ratio, merging at
# the 64x64 self-attention only; DeepCache (interval, cut): the paper's N=3
# for faithful, N=5 for accelerated, both at the shallowest branch, uniform
# refreshes; the guidance interval, opt-in (`txt2img(guidance_interval=...)`)
CONFIGS = ("lossless", "faithful", "accelerated")
TOME_RATIO = 0.5
FAITHFUL_DC = (3, 1)
ACCEL_DC = (5, 1)
GUIDANCE_INTERVAL = (0.25, 0.70)


def configure(model: Any, config: str) -> None:
    """Set the levers of `model` for `config` in `CONFIGS`: ToMe on every
    `SpatialTransformer`, the DeepCache interval and cut (uniform refreshes:
    no center). The guidance interval is the sampler's,
    `txt2img(guidance_interval=...)`."""
    if config not in CONFIGS:
        raise ValueError(f"config '{config}' is not one of {CONFIGS}")
    lossless = config == "lossless"
    for module in model.modules():
        if isinstance(module, SpatialTransformer):
            module.set_tome_ratio(0.0 if lossless else TOME_RATIO)
    model.deepcache_center = None
    if lossless:
        model.deepcache_interval = None
    else:
        model.deepcache_interval, model.deepcache_cut = ACCEL_DC if config == "accelerated" else FAITHFUL_DC


@lru_cache()
def default_tokenizer() -> CLIPTokenizer:
    return CLIPTokenizer()


def _token_ids(texts_or_ids: Any, batch: Optional[int], tokenizer: CLIPTokenizer) -> Any:
    """A prompt (broadcast over `batch`), a list of prompts, or (B, 77) ids."""
    if isinstance(texts_or_ids, str):
        return tokenizer.tokenize([texts_or_ids] * (batch or 1))
    if isinstance(texts_or_ids, (list, tuple)) and texts_or_ids and isinstance(texts_or_ids[0], str):
        return tokenizer.tokenize(list(texts_or_ids))
    return texts_or_ids


@torch.no_grad()
def txt2img(
    model: Any,
    tokens: Any,
    uncond_tokens: Any = "",
    *,
    config: Optional[str] = None,
    guidance_interval: Optional[Tuple[float, float]] = None,
    num_steps: int = 20,
    guidance_scale: float = 7.5,
    z: Optional[Any] = None,
    seed: int = 0,
    return_latents: bool = False,
) -> Any:
    """tokens: prompts (a string or a list of them, through the CLIP
    tokenizer) or (B, 77) token ids; uncond_tokens: the negative prompt for
    the unconditional rows (default "", broadcast over the batch) or (B, 77)
    ids. `config`: one of `CONFIGS`, set on the model by `configure` (None
    leaves its levers as they are); `guidance_interval`: (lo, hi) fractions
    of the step loop that get CFG. `z`: (B, h, w, 4) f32 latents, drawn from
    `seed` by a `torch.Generator` on the model's device when not given at the
    model's latent size (SD: 64x64 = 512px). Returns (B, 8h, 8w, 3) uint8
    images on the model's device (and the final latents with
    `return_latents`)."""
    device = next(model.parameters()).device
    tokenizer = default_tokenizer()
    tokens = torch.as_tensor(_token_ids(tokens, None, tokenizer), dtype=torch.long, device=device)
    uncond_ids = _token_ids(uncond_tokens, tokens.shape[0], tokenizer)
    uncond_tokens = torch.as_tensor(uncond_ids, dtype=torch.long, device=device)
    both = model.get_cond(torch.cat([tokens, uncond_tokens], dim=0))
    cond, uncond = both.chunk(2, dim=0)
    if z is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        shape = (tokens.shape[0], model.img_size, model.img_size, model.in_channels)
        z = torch.randn(shape, generator=gen, device=device)
    else:
        z = torch.as_tensor(z, dtype=torch.float32, device=device)
    if config is not None:
        configure(model, config)
    sampler_config: Dict[str, Any] = {"model": model}
    if guidance_interval is not None:
        sampler_config["guidance_interval"] = tuple(guidance_interval)
    sampler = ISampler.make("ddim", sampler_config)
    latents = sampler.sample(z, cond=cond, uncond=uncond, guidance_scale=guidance_scale, num_steps=num_steps)
    images = model.decode(latents)
    images = ((images.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)
    return (images, latents) if return_latents else images


def finetune_unet(
    model: Any,
    latents: Any,
    cond: Any,
    *,
    num_steps: int = 1,
    lr: float = 1e-5,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
    use_checkpoint: bool = False,
    generator: Optional[torch.Generator] = None,
    device: Any = None,
) -> Dict[str, Any]:
    """`num_steps` optimisation steps of `model.unet` on one batch.

    `model` is a DDPM-family model with f32 (master) parameters; `latents`
    (B, h, w, c) are the x0 of the diffusion space and `cond` (B, 77, ctx)
    the condition as `get_cond` takes it (with no condition model: the
    precomputed text embedding). Each step draws t and the noise from
    `generator` (seed 0 when not given), computes in `compute_dtype` with
    gradients back to the f32 masters, and updates them with AdamW (the
    registry's defaults: weight decay 1e-2).

    Runs on the CUDA card and raises without one, unless `device` says
    otherwise ("cpu" runs the plain PyTorch path); the model is moved there.
    Returns {"losses": (num_steps,) f32 tensor, "step": the `TrainStepFn`
    (its `grads` hold the last step's gradients), "model": the `DDPMModel`}.
    """
    device = resolve_device(device)
    wrapped = model if isinstance(model, DDPMModel) else DDPMModel(model)
    wrapped.to(device)
    wrapped.m.unet.use_checkpoint = bool(use_checkpoint)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    batch = {
        INPUT_KEY: torch.as_tensor(latents, dtype=torch.float32, device=device),
        "cond": torch.as_tensor(cond, dtype=torch.float32, device=device),
    }
    step = make_train_step(wrapped, optimizer="adamw", lr=lr, compute_dtype=compute_dtype)
    losses = [step.step(batch, generator=generator)[LOSS_KEY] for _ in range(num_steps)]
    return {"losses": torch.stack(losses), "step": step, "model": wrapped}


# the JAX trainer's defaults for a config that names no optimizer: Adam at
# lr 1e-3 behind a warm-up that starts at a third of it. Schedulers are not
# ported; the first steps of that schedule are (nearly) its starting value.
AE_DEFAULT_LR = 1.0e-3 / 3.0


def train_autoencoder(
    model: AEModel,
    images: Any,
    *,
    num_steps: int = 1,
    lr: float = AE_DEFAULT_LR,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
    generator: Optional[torch.Generator] = None,
    device: Any = None,
) -> Dict[str, Any]:
    """`num_steps` adversarial training steps of an `AEModel` on one batch.

    `model` has f32 (master) parameters; `images` are (B, H, W, 3) in [-1,
    1]. Each step runs the `core` scope (the autoencoder against L1, KL and
    the generator term) and then the `discriminator` scope (hinge on the
    inputs and on the detached reconstruction of a new forward), each with
    its own forward, loss, gradient and Adam update (no weight decay), in
    `compute_dtype` with gradients back to the f32 masters. The posterior
    noise of each scope's forward is drawn from `generator` (seed 0 when not
    given).

    Runs on the CUDA card and raises without one, unless `device` says
    otherwise ("cpu" runs the plain PyTorch path); the model is moved there.
    Returns {"losses": one dict per step with the JAX trainer's names
    (`core_loss`, `core_l1`, `core_kl`, `core_g`, `discriminator_loss`,
    `discriminator_d`), "steps": {scope: its `TrainStepFn`, whose `grads` hold
    the last step's gradients}, "step": the `MultiScopeStep`, "model"}.
    """
    device = resolve_device(device)
    model.to(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    batch = {INPUT_KEY: torch.as_tensor(images, dtype=torch.float32, device=device)}
    optimizers = {ts.scope: build_optimizer("adam", lr) for ts in model.train_steps}
    step = MultiScopeStep(model, optimizers, compute_dtype=compute_dtype)
    kwargs = {scope: {"generator": generator} for scope in step.steps}
    losses = [step.step(batch, forward_kwargs=kwargs) for _ in range(num_steps)]
    return {"losses": losses, "steps": step.steps, "step": step, "model": model}
