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

from .api import (  # noqa: E402
    APIPool, CLIPExtractor, ControlledDiffusionAPI, DiffusionAPI, Evaluator, IAPI, TranslatorAPI, Weights, evaluate,
    fit_array, fit_ml, fuse_evaluation, fuse_inference, load_evaluation, load_inference, load_training, make_metric,
    make_model, make_toy_ml_model, pack, save, supported_losses, supported_metrics, supported_modules, supported_optimizers, supported_samplers,
    supported_schedulers,
)
from .api import ml  # noqa: E402
from .api.ml import DDRPredictor, DDRVisualizer, IntegratedGradients, Interpreter, integrated_gradients  # noqa: E402
from .api.cv import VQVAEInference  # noqa: E402
from .callbacks import (  # noqa: E402
    GeneratorCallback, ImageCallback, ImageClassificationCallback, SigmoidCallback, VQVAECallback, save_image_grid,
)
from .data import (  # noqa: E402
    ArrayData, ArrayDictData, DefaultPreparation, ExternalData, ExternalDataset, ImageFolderData, IPreparation, MLData,
    ResizedPreparation, prepare_image_folder,
)
from .data.cv import ImageFolderBlock, collect_images  # noqa: E402
from .data.blocks.ml import (  # noqa: E402
    DataSplitter, FileParserBlock, GatherBlock, NanHandlerBlock, PreProcessorBlock, RecognizerBlock, SplitterBlock,
)
from .data.ml.api import MLBundledProcessorConfig, MLDataProcessor  # noqa: E402
from .device import resolve_device  # noqa: E402
from .models import (  # noqa: E402
    AutoRegressorModel, CommonDLModel, CommonMLModel, DDPMModel, DDRModel, DLEnsembleModel, GANModel, TemporalMLModel,
    VAEModel, VQVAEModel, WideAndDeepModel,
)
from .modules.core.customs import DNDF, DropPath, Pruner  # noqa: E402
from .modules.core.ml_encoder import Encoder, MLEncodePack  # noqa: E402
from .modules.ml.ddr import DDR, DDRLoss  # noqa: E402
from .modules.ml.fcnn import FCNN  # noqa: E402
from .modules.ml.linear import LinearModule  # noqa: E402
from .modules.ml.nets import (  # noqa: E402
    NBM, NDT, RNN, FNet, MixedStackedModule, Mixer, PoolFormer, TabTransformer, Transformer, WideAndDeep,
)
from .models.cv.ae import AEModel, AEVQModel, build_ae  # noqa: E402
from .modules.cv.classifier import ImageClassifier, ImgSiren, PixelCNN, RRDBNet, Siren  # noqa: E402
from .modules.cv.encoder import (  # noqa: E402
    Backbone, BackboneEncoder, BackboneEncoder1D, MixViT, RepVGG, ViTEncoder, mix_vit, mix_vit_large, mix_vit_lite,
    rep_vgg, rep_vgg_large, rep_vgg_lite,
)
from .modules.cv.gan import VanillaGenerator  # noqa: E402
from .modules.cv.vae import VQVAE, VanillaVAE  # noqa: E402
from .modules.multimodal.clip import CLIP, IPerceptor  # noqa: E402
from .modules.multimodal.diffusion.ddpm import DDPM  # noqa: E402
from .modules.multimodal.diffusion.ldm import (  # noqa: E402
    LDM, StableDiffusion, StableDiffusionInpainting, build, build_sd, sd_unet_config,
)
from .modules.multimodal.diffusion.unet import ControlNet  # noqa: E402
from .modules.nlp.tokenizers import CLIPTokenizer  # noqa: E402
from .schema import DLConfig, IDLModel, ILoss, MLConfig, TrainStep  # noqa: E402
from .schema.data import DataConfig  # noqa: E402
from .pipeline import (  # noqa: E402
    CONFIGS, DLEvaluationPipeline, DLInferencePipeline, DLPipelineSerializer, DLTrainingPipeline,
    FusedEvaluationPipeline, FusedInferencePipeline, GeneralEvaluationPipeline, IPredictor, MLEvaluationPipeline,
    MLInferencePipeline, MLTrainingPipeline, SKLearnClassifier, aot_compile, configure, export_model, finetune_unet,
    load_exported, pack_exported, pack_stablehlo, train_autoencoder, txt2img,
)
from .trainer import Trainer  # noqa: E402
from .toolkit.quality import QualityReport, clip_score, clip_score_from_embeddings, compare_outputs  # noqa: E402
from . import zoo  # noqa: E402
from .parameters import OPT  # noqa: E402
from .zoo import (  # noqa: E402
    ae_kl_f4, ae_kl_f8, ae_kl_f16, ae_vq_f4, ae_vq_f4_no_attn, ae_vq_f8, build_predefined_module, clip, clip_large,
    esr, esr_anime, ldm_inpainting, ldm_semantic, ldm_vq, load_predefined_config, load_pretrained_module,
    load_pretrained_weights, open_clip_ViT_H_14,
)

__all__ = [
    "DefaultPreparation", "ExternalData", "ExternalDataset", "FusedEvaluationPipeline", "FusedInferencePipeline",
    "GeneralEvaluationPipeline", "GeneratorCallback", "IPredictor", "ImageCallback", "ImageClassificationCallback",
    "ImageFolderBlock", "ImageFolderData", "IPreparation", "ResizedPreparation", "SKLearnClassifier",
    "SigmoidCallback", "VQVAECallback", "VQVAEInference", "aot_compile", "collect_images", "export_model",
    "fuse_evaluation", "fuse_inference", "load_exported", "pack_exported", "pack_stablehlo", "prepare_image_folder",
    "save_image_grid",
    "CommonMLModel", "DDR", "DDRLoss", "DDRModel", "DDRPredictor", "DDRVisualizer", "DNDF", "DataSplitter", "DropPath",
    "Encoder", "FCNN", "FNet", "FileParserBlock", "GatherBlock", "IntegratedGradients", "Interpreter", "LinearModule",
    "MLBundledProcessorConfig", "MLConfig", "MLData", "MLDataProcessor", "MLEncodePack", "MLEvaluationPipeline",
    "MLInferencePipeline", "MLTrainingPipeline", "MixedStackedModule", "Mixer", "NBM", "NDT", "NanHandlerBlock",
    "PoolFormer", "PreProcessorBlock", "Pruner", "RNN", "RecognizerBlock", "SplitterBlock", "TabTransformer",
    "TemporalMLModel", "Transformer", "WideAndDeep", "WideAndDeepModel", "fit_ml", "integrated_gradients",
    "make_toy_ml_model", "ml",
    "ArrayData", "ArrayDictData", "DLEvaluationPipeline", "DLInferencePipeline", "DLPipelineSerializer",
    "DLTrainingPipeline", "DataConfig", "Evaluator", "Trainer", "evaluate", "fit_array", "load_evaluation",
    "load_inference", "load_training", "make_metric", "make_model", "pack", "save", "supported_losses",
    "supported_metrics", "supported_modules", "supported_optimizers", "supported_samplers", "supported_schedulers",
    "AEModel", "AEVQModel", "APIPool", "AutoRegressorModel", "Backbone", "BackboneEncoder", "BackboneEncoder1D",
    "GANModel", "ImageClassifier", "ImgSiren", "MixViT", "PixelCNN", "RepVGG", "Siren", "VAEModel", "VQVAE",
    "VQVAEModel", "VanillaGenerator", "VanillaVAE", "ViTEncoder", "mix_vit", "mix_vit_large", "mix_vit_lite",
    "rep_vgg", "rep_vgg_large", "rep_vgg_lite",
    "CommonDLModel", "DDPMModel", "DLConfig", "DLEnsembleModel", "IDLModel",
    "ILoss", "TrainStep", "CLIP", "CLIPExtractor", "CLIPTokenizer", "CONFIGS", "ControlNet", "ControlledDiffusionAPI",
    "DDPM", "DiffusionAPI", "IAPI", "IPerceptor", "LDM", "OPT", "QualityReport", "RRDBNet", "StableDiffusion",
    "StableDiffusionInpainting", "TranslatorAPI", "Weights", "ae_kl_f4", "ae_kl_f8", "ae_kl_f16", "ae_vq_f4",
    "ae_vq_f4_no_attn", "ae_vq_f8", "build", "build_ae", "build_predefined_module", "build_sd", "clip", "clip_large", "clip_score",
    "clip_score_from_embeddings", "compare_outputs", "configure", "esr", "esr_anime", "finetune_unet",
    "ldm_inpainting", "ldm_semantic", "ldm_vq", "load_predefined_config", "load_pretrained_module",
    "load_pretrained_weights", "open_clip_ViT_H_14", "resolve_device", "sd_unet_config",
    "train_autoencoder", "txt2img", "zoo",
]
