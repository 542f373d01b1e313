"""txt2img: the port's main path, as `bench.py`'s jitted closure runs it —
one batched text encode for cond and uncond, DDIM with batched CFG, the
first-stage decode, clip, and uint8."""

from typing import Any, Optional

import torch

from .modules.multimodal.diffusion.samplers import ISampler


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
