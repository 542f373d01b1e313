"""The SD family's entry points (`cflearn_torch.pipeline` re-exports them).

`txt2img`: the serving path, as `bench.py`'s jitted closure runs it — the
prompts through the CLIP tokenizer, one batched text encode for cond and
uncond, DDIM with batched CFG, the first-stage decode, clip, and uint8. Its
`config` selects one of `bench.py`'s three serving configurations through
`configure`: "lossless"; "faithful" (ToMe 0.5 and DeepCache N=3 at cut 1);
"accelerated" (ToMe 0.5 and DeepCache N=5 at cut 1). The guidance interval
(0.25, 0.70) is opt-in.

`finetune_unet`: the training path — eps-loss steps of the UNet on one
batch (images for an LDM with a first stage, which encodes them without a
gradient; x0 otherwise) and a condition, f32 masters with a (bf16) compute
dtype, AdamW at a constant 1e-5 unless `optimizer_settings` say otherwise.

`train_autoencoder`: the adversarial training of an autoencoder (`ae_kl` or
`ae_vq`) — two scopes per step (the autoencoder, then its PatchGAN
discriminator), f32 masters with a (bf16) compute dtype, and the JAX
`Trainer`'s default optimizer settings: Adam behind a `warmup` x3 that hands
off to `plateau`.
"""

from functools import lru_cache
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..device import resolve_device
from ..models.cv.ae import AEModel
from ..models.cv.diffusion import INPUT_KEY, LOSS_KEY, DDPMModel
from ..modules.core.mixed_stacks import SpatialTransformer
from ..modules.cv.ae import AutoEncoderKL
from ..modules.multimodal.diffusion.samplers import ISampler
from ..modules.nlp.tokenizers import CLIPTokenizer
from ..trainer import DEFAULT_LR, MultiScopeStep, TrainStepFn, build_optimizers, default_optimizer_settings

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


def _batch_value(value: Any, device: torch.device) -> Any:
    """A batch entry on `device`: floating arrays as f32, integer ones (class
    labels) as they are, dicts (the hybrid condition) entry by entry."""
    if value is None:
        return None
    if isinstance(value, dict):
        return {k: _batch_value(v, device) for k, v in value.items()}
    t = torch.as_tensor(value, device=device)
    return t.float() if t.is_floating_point() else t


def finetune_unet(
    model: Any,
    inputs: Any,
    cond: Any,
    *,
    num_steps: int = 1,
    lr: float = 1e-5,
    optimizer_settings: Optional[Dict[str, Any]] = None,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
    use_checkpoint: Union[bool, str] = False,
    generator: Optional[torch.Generator] = None,
    device: Any = None,
) -> Dict[str, Any]:
    """`num_steps` optimisation steps of `model.unet` on one batch.

    `model` is a DDPM-family model with f32 (master) parameters. `inputs` is
    what the JAX batch holds under its input key: (B, H, W, 3) images for an
    LDM with a first stage (encoded, without a gradient, to its scaled
    latents: 8x smaller for SD), else (B, h, w, c) x0 of the diffusion
    space. `cond` is the condition as `get_cond` takes it (with no condition
    model: the precomputed text embedding (B, 77, ctx); class ids for `adm`;
    images for `use_first_stage_as_condition`), or None. Each step draws t
    and the noise from `generator` (seed 0 when not given) and computes in
    `compute_dtype` with gradients back to the f32 masters. `use_checkpoint`
    goes to the UNet as it is: True recomputes each input and output block
    in the backward, a `jax.checkpoint_policies` name keeps what that policy
    keeps (an unknown name raises `ValueError`). The optimizer is
    AdamW at a constant `lr` (weight decay 1e-2), unless
    `optimizer_settings` ({"all": dict or `OptimizerPack`}, as the JAX
    `TrainerConfig.optimizer_settings`) names another optimizer, its config
    or a scheduler.

    Runs on the CUDA card and raises without one, unless `device` says
    otherwise ("cpu" runs the plain PyTorch path); the model is moved there.
    Returns {"losses": (num_steps,) f32 tensor, "step": the `TrainStepFn`
    (its `grads` hold the last step's gradients), "model": the `DDPMModel`}.
    """
    device = resolve_device(device)
    wrapped = model if isinstance(model, DDPMModel) else DDPMModel(model)
    wrapped.to(device)
    wrapped.m.unet.use_checkpoint = use_checkpoint
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    batch = {INPUT_KEY: _batch_value(inputs, device), "cond": _batch_value(cond, device)}
    settings = default_optimizer_settings(
        lr=lr, optimizer_name="adamw", scheduler_name="none", optimizer_settings=optimizer_settings
    )
    optimizers, _ = build_optimizers(["all"], settings)
    step = TrainStepFn(wrapped, optimizers["all"], compute_dtype=compute_dtype)
    losses = [step.step(batch, generator=generator)[LOSS_KEY] for _ in range(num_steps)]
    return {"losses": torch.stack(losses), "step": step, "model": wrapped}


# the starting lr of the JAX trainer's default schedule: lr 1e-3 divided by
# the warm-up's multiplier 3, which it climbs back to over the warm-up
AE_DEFAULT_LR = DEFAULT_LR / 3.0


def train_autoencoder(
    model: AEModel,
    images: Any,
    *,
    num_steps: int = 1,
    lr: Optional[float] = None,
    optimizer_settings: Optional[Dict[str, Any]] = None,
    num_step_per_epoch: int = 1,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
    generator: Optional[torch.Generator] = None,
    device: Any = None,
) -> Dict[str, Any]:
    """`num_steps` adversarial training steps of an `AEModel` (or
    `AEVQModel`) on one batch.

    `model` has f32 (master) parameters; `images` are (B, H, W, 3) in [-1,
    1]. Each step runs the `core` scope (the autoencoder against L1, LPIPS,
    KL or the VQ terms, and the generator term) and then the `discriminator`
    scope (hinge on the inputs and on the detached reconstruction of a new
    forward), each with its own forward, loss, gradient and optimizer, in
    `compute_dtype` with gradients back to the f32 masters. The KL
    posterior's noise of each scope's forward is drawn from `generator` (seed
    0 when not given).

    The optimizers are the JAX `Trainer`'s defaults for a config that names
    none: Adam, its lr (`lr`, default 1e-3) behind a `warmup` that starts at
    a third of it (`AE_DEFAULT_LR`) and climbs to it over min(round(3e5 / B),
    10 * `num_step_per_epoch`) steps, then `plateau`; `optimizer_settings`
    ({scope: dict or `OptimizerPack`}) override them per scope, as the JAX
    `TrainerConfig.optimizer_settings` do.

    Runs on the CUDA card and raises without one, unless `device` says
    otherwise ("cpu" runs the plain PyTorch path); the model is moved there.
    Returns {"losses": one dict per step with the JAX trainer's names
    (`core_loss`, `core_l1`, `core_perceptual`, `core_kl` or `core_vq`,
    `core_g`, `discriminator_loss`, `discriminator_d`), "lrs": one {scope:
    learning rate} per step (the scopes that stepped), "steps": {scope: its `TrainStepFn`, whose
    `grads` hold the last step's gradients}, "step": the `MultiScopeStep`,
    "optimizers", "lr_scales" (the plateau states), "model"}.
    """
    device = resolve_device(device)
    model.to(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    batch = {INPUT_KEY: torch.as_tensor(images, dtype=torch.float32, device=device)}
    settings = default_optimizer_settings(
        lr=lr, optimizer_settings=optimizer_settings, batch_size=batch[INPUT_KEY].shape[0],
        num_step_per_epoch=num_step_per_epoch,
    )
    optimizers, lr_scales = build_optimizers([ts.scope for ts in model.train_steps], settings)
    step = MultiScopeStep(model, optimizers, compute_dtype=compute_dtype)
    # the KL autoencoder samples its posterior in the forward; the VQ one draws nothing
    kwargs = {scope: {"generator": generator} for scope in step.steps} if isinstance(model.m, AutoEncoderKL) else None
    losses, lrs = [], []
    for _ in range(num_steps):
        counts = {scope: opt.count for scope, opt in optimizers.items()}
        losses.append(step.step(batch, forward_kwargs=kwargs))
        lrs.append({scope: opt.last_lr for scope, opt in optimizers.items() if opt.count > counts[scope]})
    return {"losses": losses, "lrs": lrs, "steps": step.steps, "step": step, "optimizers": optimizers,
            "lr_scales": lr_scales, "model": model}
