"""The port's entry points.

`txt2img`: the serving path, as `bench.py`'s jitted closure runs it — one
batched text encode for cond and uncond, DDIM with batched CFG, the
first-stage decode, clip, and uint8.

`finetune_unet`: the training path — eps-loss steps of the UNet on given
latents and a precomputed text condition, f32 masters with a (bf16) compute
dtype, AdamW.
"""

from typing import Any, Dict, Optional

import torch

from .device import resolve_device
from .models.cv.diffusion import INPUT_KEY, LOSS_KEY, DDPMModel
from .modules.multimodal.diffusion.samplers import ISampler
from .trainer import make_train_step


@torch.no_grad()
def txt2img(
    model: Any,
    tokens: Any,
    uncond_tokens: Any,
    *,
    num_steps: int = 20,
    guidance_scale: float = 7.5,
    z: Optional[Any] = None,
    seed: int = 0,
    return_latents: bool = False,
) -> Any:
    """tokens / uncond_tokens: (B, 77) token ids. `z`: (B, h, w, 4) f32
    latents, drawn from `seed` by a `torch.Generator` on the model's device
    when not given at the model's latent size (SD: 64x64 = 512px). Returns (B, 8h, 8w, 3) uint8
    images on the model's device (and the final latents with
    `return_latents`)."""
    device = next(model.parameters()).device
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=device)
    uncond_tokens = torch.as_tensor(uncond_tokens, dtype=torch.long, device=device)
    both = model.get_cond(torch.cat([tokens, uncond_tokens], dim=0))
    cond, uncond = both.chunk(2, dim=0)
    if z is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        shape = (tokens.shape[0], model.img_size, model.img_size, model.in_channels)
        z = torch.randn(shape, generator=gen, device=device)
    else:
        z = torch.as_tensor(z, dtype=torch.float32, device=device)
    sampler = ISampler.make("ddim", {"model": model})
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
