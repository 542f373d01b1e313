"""Losses (counterpart of `cflearn_tpu/losses/`): the LPIPS perceptual distance."""

from .lpips import LPIPS, LPIPSLoss, VGG16Features, load_lpips

__all__ = ["LPIPS", "LPIPSLoss", "VGG16Features", "load_lpips"]
