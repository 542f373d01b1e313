from .api import (
    Evaluator, evaluate, fit_array, load_evaluation, load_inference, load_training, make_metric, make_model, pack, save,
    supported_losses, supported_metrics, supported_modules, supported_optimizers, supported_samplers,
    supported_schedulers,
)
from .common import APIPool, IAPI, Weights
from .cv.translator import TranslatorAPI
from .multimodal.clip import CLIPExtractor
from .multimodal.diffusion import ControlledDiffusionAPI, DiffusionAPI

__all__ = [
    "APIPool", "CLIPExtractor", "ControlledDiffusionAPI", "DiffusionAPI", "Evaluator", "IAPI", "TranslatorAPI",
    "Weights", "evaluate", "fit_array", "load_evaluation", "load_inference", "load_training", "make_metric",
    "make_model", "pack", "save", "supported_losses", "supported_metrics", "supported_modules", "supported_optimizers",
    "supported_samplers", "supported_schedulers",
]
