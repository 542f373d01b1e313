from .common import APIPool, IAPI, Weights
from .cv.translator import TranslatorAPI
from .multimodal.clip import CLIPExtractor
from .multimodal.diffusion import ControlledDiffusionAPI, DiffusionAPI

__all__ = ["APIPool", "CLIPExtractor", "ControlledDiffusionAPI", "DiffusionAPI", "IAPI", "TranslatorAPI", "Weights"]
