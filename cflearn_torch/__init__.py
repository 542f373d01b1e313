"""cflearn_torch: the PyTorch / CUDA port of cflearn_tpu for NVIDIA Hopper.

The port mirrors the JAX package's module layout. Hand-written CUDA kernels
(`csrc/`) replace the TPU's Pallas kernels; each has a plain PyTorch version
beside it, which CPU tensors take. Entry points run on the CUDA card unless
the caller passes `device="cpu"` (or another device).

TF32 is off for both matmuls and cuDNN convolutions, so f32 work on the card
runs in full f32, as the JAX reference does on the CPU.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .device import resolve_device  # noqa: E402
from .modules.multimodal.diffusion.ddpm import DDPM  # noqa: E402
from .modules.multimodal.diffusion.ldm import LDM, StableDiffusion, build, build_sd, sd_unet_config  # noqa: E402
from .pipeline import finetune_unet, txt2img  # noqa: E402

__all__ = [
    "DDPM", "LDM", "StableDiffusion", "build", "build_sd", "finetune_unet", "resolve_device",
    "sd_unet_config", "txt2img",
]
