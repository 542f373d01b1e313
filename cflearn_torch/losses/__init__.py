"""Losses (counterpart of `cflearn_tpu/losses/`): the LPIPS perceptual
distance and "cross_entropy"."""

from .basic import CrossEntropyLoss
from .lpips import LPIPS, LPIPSLoss, VGG16Features, load_lpips

__all__ = ["CrossEntropyLoss", "LPIPS", "LPIPSLoss", "VGG16Features", "load_lpips"]
