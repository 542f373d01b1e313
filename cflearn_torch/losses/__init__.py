"""Losses (counterpart of `cflearn_tpu/losses/`): the registry of
`losses/basic.py` and the LPIPS perceptual distance."""

from .basic import (
    BCELoss, CorrelationLoss, CrossEntropyLoss, FocalLoss, IOULoss, LabelSmoothCrossEntropyLoss, MAELoss, MSELoss,
    QuantileLoss, ReconstructionLoss, SigmoidMAELoss,
)
from .lpips import LPIPS, LPIPSLoss, VGG16Features, load_lpips

__all__ = [
    "BCELoss", "CorrelationLoss", "CrossEntropyLoss", "FocalLoss", "IOULoss", "LPIPS", "LPIPSLoss",
    "LabelSmoothCrossEntropyLoss", "MAELoss", "MSELoss", "QuantileLoss", "ReconstructionLoss", "SigmoidMAELoss",
    "VGG16Features", "load_lpips",
]
