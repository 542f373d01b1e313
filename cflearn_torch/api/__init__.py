from .api import (
    Evaluator, evaluate, fit_array, fit_ml, fuse_evaluation, fuse_inference, load_evaluation, load_inference,
    load_training, make_metric, make_model, make_toy_ml_model, pack, repeat_ml, run_multiple, save, supported_losses,
    supported_metrics,
    supported_modules, supported_optimizers, supported_samplers, supported_schedulers,
)
from . import ml
from .common import APIPool, IAPI, Weights
from .cv.translator import TranslatorAPI
from .multimodal.clip import CLIPExtractor
from .multimodal.diffusion import ControlledDiffusionAPI, DiffusionAPI

__all__ = [
    "APIPool", "CLIPExtractor", "ControlledDiffusionAPI", "DiffusionAPI", "Evaluator", "IAPI", "TranslatorAPI",
    "Weights", "evaluate", "fit_array", "fit_ml", "fuse_evaluation", "fuse_inference", "load_evaluation",
    "load_inference", "load_training", "make_metric", "make_model", "make_toy_ml_model", "ml", "pack", "repeat_ml",
    "run_multiple", "save",
    "supported_losses", "supported_metrics", "supported_modules", "supported_optimizers", "supported_samplers",
    "supported_schedulers",
]
