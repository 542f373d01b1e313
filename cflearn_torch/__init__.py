"""cflearn_torch: the PyTorch / CUDA port of cflearn_tpu for NVIDIA Hopper.

The port mirrors the JAX package's module layout and its public surface:
`import cflearn_torch as cf` gives every name of `cflearn_tpu/__init__.py`
(the reference aliases `TensorBatcher`, `TorchData*`, `*_dataset`,
`BasicSampler`, `DPMSolver`, `GANLoss`, `GradientNormLoss` among them), plus
the port's own entry points (`build_sd`, `txt2img`, `finetune_unet`, the zoo's
builders, ...). Hand-written CUDA kernels (`csrc/`) replace the TPU's
Pallas kernels; each has a plain PyTorch version beside it, which CPU
tensors take. Entry points run on the CUDA card unless the caller passes
`device="cpu"` (or another device). Importing builds no kernel.

TF32 is off for both matmuls and cuDNN convolutions, so f32 work on the card
runs in full f32, as the JAX reference does on the CPU.
"""

__version__ = "0.2.0"

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# flake8: noqa: E402

from . import constants, losses, metrics, models, modules, monitors, optimizers, schedulers
from .schema import Config, DLConfig, MLConfig, TrainerConfig

from . import callbacks, data
from .api import (
    evaluate,
    fit_array,
    fit_ml,
    fuse_evaluation,
    fuse_inference,
    load_evaluation,
    load_inference,
    load_training,
    make_metric,
    make_model,
    make_toy_ml_model,
    pack,
    save,
    supported_losses,
    supported_metrics,
    supported_modules,
    supported_optimizers,
    supported_samplers,
    supported_schedulers,
)
from .pipeline import DLPipelineSerializer, MLTrainingPipeline
from .schema.model import IDLModel
from .trainer import Trainer

from . import dist, ops, zoo
from .api.common import APIPool, IAPI, Weights
from .api.cv import TranslatorAPI
from .api.multimodal import (
    CLIPExtractor,
    ControlledDiffusionAPI,
    DiffusionAPI,
    InpaintingMode,
    InpaintingSettings,
)
from .zoo.common import SDVersions, get_sd_tag

# ---------------------------------------------------------------------------
# every layer's names at the top level, as the JAX package has them
# ---------------------------------------------------------------------------

from .constants import (
    BATCH_INDICES_KEY,
    INPUT_KEY,
    LABEL_KEY,
    LATENT_KEY,
    LOG_VAR_KEY,
    LOSS_KEY,
    MU_KEY,
    ORIGINAL_LABEL_KEY,
    PREDICTIONS_KEY,
)
from .parameters import OPT

# schema
from .schema.data import (
    DataBundle,
    DataConfig,
    DataProcessor,
    DataProcessorConfig,
    IData,
    IDataBlock,
    IDataLoader,
    IDataset,
    INoInitDataBlock,
    data_type,
    norm_sw,
    sample_weights_type,
    split_sw,
)
from .schema.losses_schema import ILoss, build_loss, register_loss
from .schema.metrics_schema import IMetric, MetricsOutputs, MultipleMetrics, weighted_loss_score
from .schema.model import StepOutputs, TrainStep, forward_results_type
from .schema.train_schema import (
    ITrainer,
    MonitorResults,
    TrainerCallback,
    TrainerMonitor,
    TrainerState,
)

# data
from .data.array import ArrayData, ArrayDictData
from .data.blocks.cv import (
    AffineNormalizeBlock,
    AnchoredResizeBlock,
    CenterCropBlock,
    FlattenBlock,
    HWCToCHWBlock,
    IRuntimeDataBlock,
    ImagenetNormalizeBlock,
    RandomCropBlock,
    ResizeBlock,
    StaticNormalizeBlock,
    ToNumpyBlock,
    ToRGBBlock,
    TupleToBatchBlock,
)
from .data.blocks.ml import (
    DataSplitter,
    FileParserBlock,
    GatherBlock,
    NanHandlerBlock,
    PreProcessorBlock,
    RecognizerBlock,
    SplitterBlock,
)
from .data.cv.image_folder import DefaultPreparation, IPreparation, ResizedPreparation
from .data.external import ExternalData, ExternalDataset
from .data.ml.api import (
    MLAdvancedProcessorConfig,
    MLBundledProcessorConfig,
    MLData,
    MLDataProcessor,
)
from .data.ml.datasets import breast_data, california_data, digits_data, iris_data, mnist_data
from .data.utils import (
    ArrayDataset,
    ArrayLoader,
    DeviceBatcher,
    IArrayDataMixin,
    get_weighted_indices,
)
from .inference import DLInference, InferenceOutputs

# modules
from .modules.common import (
    EMA,
    Lambda,
    PrefixModules,
    Residual,
    avg_pool_nd,
    build_module,
    register_module,
    zero_module,
)
from .modules.core.activations import build_activation, register_activation
from .modules.core.attentions import (
    Attention,
    CrossAttention,
    DecayedAttention,
    LinearDepthWiseAttention,
    MultiHeadSpatialAttention,
    SpatialAttention,
    make_attention,
)
from .modules.core.convs import (
    CABlock,
    Conv2d,
    DepthWiseConv2d,
    ECABlock,
    Interpolate,
    ResidualBlock,
    ResidualBlockWithTimeEmbedding,
    SEBlock,
    UpsampleConv2d,
)
from .modules.core.customs import DNDF, DropPath, Linear, Pruner
from .modules.core.high_level import ChannelPadding, PreNorm, VanillaPatchEmbed
from .modules.core.mappings import build_mapping, register_mapping
from .modules.core.mixed_stacks import (
    AttentionTokenMixer,
    FeedForward,
    FourierTokenMixer,
    MLPTokenMixer,
    MixFeedForward,
    MixedStackedEncoder,
    MoEChannelMixer,
    PoolTokenMixer,
    RWKVChannelMixer,
    RWKVTokenMixer,
    SpatialTransformer,
    SpatialTransformerHooks,
    build_channel_mixer,
    build_token_mixer,
    register_channel_mixer,
    register_token_mixer,
)
from .modules.core.ml_encoder import Encoder, MLEncodePack
from .modules.core.norms import AdaptiveInstanceNorm2d, NormFactory, PixelNorm
from .modules.cv.classifier import ImgSiren, PixelCNN, RRDBNet
from .modules.cv.common import (
    DecoderInputs,
    VQCodebook,
    VQCodebookOut,
    build_auto_regressor,
    build_decoder,
    build_discriminator,
    build_encoder,
    build_generator,
    register_auto_regressor,
    register_decoder,
    register_discriminator,
    register_encoder,
    register_generator,
    decoders,
    discriminators,
    encoders,
    generators,
)
from .modules.cv.decoder import VanillaDecoder, VanillaDecoder1D
from .modules.cv.encoder import BackboneEncoder, VanillaEncoder, VanillaEncoder1D, ViTEncoder
from .modules.cv.gan import MultiScaleDiscriminator, NLayerDiscriminator
from .modules.cv.vae import VQVAE
from .modules.ml.ddr import DDR, DDRLoss
from .modules.ml.fcnn import FCNN
from .modules.ml.linear import LinearModule
from .modules.ml.nets import FNet, MixedStackedModule, Mixer, NBM, NDT, PoolFormer, RNN, WideAndDeep
from .modules.multimodal.clip import CLIP, IPerceptor
from .modules.multimodal.diffusion.ddpm import DDPM
from .modules.multimodal.diffusion.ldm import LDM, StableDiffusion
from .modules.multimodal.diffusion.samplers import (
    DDIMSampler,
    DDPMSampler,
    DPMSolverSampler,
    IKSampler,
    ISampler,
    KDPMpp2MSampler,
    KEulerAncestralSampler,
    KEulerSampler,
    KHeunSampler,
    KLMSSampler,
    LCMSampler,
    PLMSSampler,
)
from .modules.multimodal.diffusion.unet import ControlNet, UNetDiffuser
from .modules.nlp.tokenizers import CLIPTokenizer, ChineseCLIPTokenizer, ITokenizer

# losses / metrics
from .losses.basic import (
    BCELoss,
    CorrelationLoss,
    CrossEntropyLoss,
    FocalLoss,
    IOULoss,
    LabelSmoothCrossEntropyLoss,
    MAELoss,
    MSELoss,
    QuantileLoss,
    ReconstructionLoss,
    SigmoidMAELoss,
)
from .losses.common import MultiStageLoss, MultiTaskLoss
from .losses.lpips import LPIPS
from .metrics import AUC, Accuracy, BER, Correlation, F1Score, IOU, MAE, MSE, Quantile, R2Score

# models
from .models.common import CommonDLModel, CommonTrainStep, DLEnsembleModel
from .models.cv.ae import AEModel, AEVQModel
from .models.cv.diffusion import DDPMModel
from .models.cv.gan import GANModel, gan_loss, gradient_norm_penalty
from .models.cv.vae import AutoRegressorModel, VAELoss, VAEModel, VQVAELoss, VQVAEModel
from .models.ml.common import CommonMLModel, TemporalMLModel
from .models.ml.ddr import DDRModel

# training aux
from .callbacks.general import ArtifactCallback, LogMetricsMsgCallback, MLFlowCallback
from .callbacks.generator import GeneratorCallback, ImageClassificationCallback, VQVAECallback
from .monitors import BasicMonitor, ConservativeMonitor, LazyMonitor, MeanStdMonitor, PlateauMonitor
from .optimizers import register_optimizer
from .schedulers import register_scheduler
from .trainer import get_scores, get_sorted_checkpoints

# pipeline
from .pipeline.api import (
    DLEvaluationPipeline,
    DLInferencePipeline,
    DLTrainingPipeline,
    TrainingPipeline,
)
from .pipeline.blocks import (
    BuildCallbacksBlock,
    BuildInferenceBlock,
    BuildMetricsBlock,
    BuildModelBlock,
    BuildMonitorsBlock,
    BuildOptimizersBlock,
    BuildTrainerBlock,
    ExtractStateInfoBlock,
    PrepareWorkplaceBlock,
    RecordNumSamplesBlock,
    ReportBlock,
    SerializeDataBlock,
    SerializeModelBlock,
    SerializeOptimizerBlock,
    SetDefaultsBlock,
    SetMLDefaultsBlock,
    TrainingBlock,
)
from .pipeline.common import Block, Pipeline
from .pipeline.third_party import GeneralEvaluationPipeline, IPredictor, SKLearnClassifier
from .zoo.common import load_module, parse_config

# the API's sub-namespaces
from . import inference, parallel, toolkit
from .api import cv, ml, multimodal, nlp
from . import scripts

# second flattening wave: interface bases, enums, helpers
from .schema.data import (
    DataArgs,
    configs_type,
    general_config_type,
    sample_weights_type,
    split_sw,
    states_callback_type,
    texts_type,
)
from .schema.config import MLEncoderSettings, MLGlobalEncoderSettings, TqdmSettings
from .schema.losses_schema import register_loss
from .data.blocks.ml import (
    ColumnTypes,
    DataOrder,
    DataTypes,
    MLNanHandlerConfig,
    MLPreProcessConfig,
    MLRecognizerConfig,
    MLSplitterConfig,
    NanDropStrategy,
    NanReplaceMethod,
    PreProcessMethods,
)
from .data.array import ArrayDictDataset
from .data.cv.image_folder import collect_images, default_image_extensions
from .data.ml.api import (
    MLBatch,
    MLDataConfig,
    MLDataset,
    MLDatasetTag,
    MLFileProcessorConfig,
    MLLoader,
)
from .data.utils import IArrayDataset, predict_array_data
from .modules.common import module_dict
from .modules.core.convs import (
    GaussianBlur3,
    MaxUnpool2d,
    ResDownsample,
    ResUpsample,
    ResidualBlockV2,
    conv_nd,
    get_conv_blocks,
)
from .modules.core.mappings import register_mapping
from .modules.core.mixed_stacks import (
    BertPooler,
    IChannelMixer,
    ITokenMixer,
    SequencePooler,
    SpatialTransformerBlock,
    walk_spatial_transformer_blocks,
    walk_spatial_transformer_hooks,
)
from .modules.core.ml_encoder import EncodingResult, ml_encode
from .modules.core.norms import BN, LN
from .modules.core.high_level import ImgToPatches
from .modules.cv.ae import (
    AttentionAutoEncoderKL,
    AttentionAutoEncoderVQ,
    AttentionDecoder,
    AttentionEncoder,
    AutoEncoderKL,
    AutoEncoderVQ,
    IAttentionAutoEncoder,
)
from .modules.cv.classifier import Siren, VanillaClassifier, img_siren_head, make_grid
from .modules.cv.common import (
    EncoderDecoder,
    GaussianDistribution,
    IAutoRegressor,
    IConditional,
    IDecoder,
    IDiscriminator,
    IEncoder,
    IGaussianGenerator,
    IGenerator,
    get_latent_resolution,
)
from .modules.cv.gan import GAN
from .modules.cv.vae import VAE, VanillaVAE, reparameterize
from .modules.ml.nets import TabTransformer, Transformer
from .modules.multimodal.diffusion.ldm import SDLoRAMode, convert_lora
from .modules.multimodal.diffusion.samplers import (
    DDIMMixin,
    DDPMQSampler,
    IQSampler,
    is_misc_key,
)
from .modules.nlp.tokenizers import ICLIPTokenizer
from .models.cv.gan import DiscriminatorOutput, GANTarget
from .models.ml.common import WideAndDeepModel, register_ml_model, to_ml_model
from .optimizers import optimizer_dict
from .schedulers import scheduler_dict
from .pipeline.api import IEvaluationPipeline, PackType, PipelineTypes
from .pipeline.blocks import SetMLTrainerDefaultsBlock, SetTrainerDefaultsBlock, TryLoadBlock
from .pipeline.common import InjectDefaultsMixin
from .toolkit.misc import losses_type, param_type
from .trainer import get_input_sample
from .zoo.common import (
    build_predefined_module,
    load_predefined_config,
    load_pretrained_module,
    load_pretrained_weights,
    parse_config_info,
    parse_json,
)

# third wave: backbones, optimizer/scheduler parity, remaining interfaces
from .callbacks.generator import ImageCallback
from .data.array import IArrayDictDataset
from .data.external import TorchDataConfig
from .inference import IInference
from .modules.cv.encoder import (
    Backbone,
    BackboneEncoder1D,
    MixViT,
    RepVGG,
    backbone_info_dict,
    mix_vit,
    mix_vit_large,
    mix_vit_lite,
    register_backbone,
    rep_vgg,
    rep_vgg_large,
    rep_vgg_lite,
)
from .optimizers import OptimizerPack
from .schedulers import (
    CosineWarmupOp,
    ExponentialLRWithFloor,
    LinearInverseScheduler,
    LinearWarmupOp,
    ReduceLROnPlateauWithGet,
    StepLRWithFloor,
    WarmupScheduler,
    register_op,
    scheduler_ops,
)
from .schema.model import TrainStepLoss
from .trainer import get_update_fn
from .data.cv.image_folder import ImageFolderBlock
from .modules.core.customs import LeafAggregation, Route, leaf_aggregation, route

# ---------------------------------------------------------------------------
# the reference's names of renamed equivalents, as the JAX package aliases them
# ---------------------------------------------------------------------------

# the reference's TensorBatcher moves host batches to the device: DeviceBatcher here
TensorBatcher = DeviceBatcher
# the reference's TorchData / TorchDataset wrap external datasets: ExternalData / ExternalDataset here
TorchData = ExternalData
TorchDataset = ExternalDataset
TorchDataLoader = ExternalData
# the reference's dataset helpers are named *_dataset
iris_dataset = iris_data
digits_dataset = digits_data
breast_dataset = breast_data
california_dataset = california_data
# the reference's BasicSampler is DDPM's ancestral sampling
BasicSampler = DDPMSampler
DPMSolver = DPMSolverSampler
# the reference exports the message callback privately
_LogMetricsMsgCallback = LogMetricsMsgCallback
# the reference's GANLoss / GradientNormLoss are modules: their functions here
GANLoss = gan_loss
GradientNormLoss = gradient_norm_penalty


# ---------------------------------------------------------------------------
# the port's own entry points
# ---------------------------------------------------------------------------

from .api import Evaluator
from .api.cv import VQVAEInference
from .api.ml import DDRPredictor, DDRVisualizer, IntegratedGradients, Interpreter, integrated_gradients
from .callbacks import SigmoidCallback, save_image_grid
from .data import ImageFolderData, prepare_image_folder
from .device import resolve_device
from .models.cv.ae import build_ae
from .modules.cv.classifier import ImageClassifier
from .modules.cv.gan import VanillaGenerator
from .modules.multimodal.diffusion.ldm import StableDiffusionInpainting, build, build_sd, sd_unet_config
from .pipeline import (
    CONFIGS, FusedEvaluationPipeline, FusedInferencePipeline, MLEvaluationPipeline, MLInferencePipeline, aot_compile,
    configure, export_model, finetune_unet, load_exported, pack_exported, pack_stablehlo, train_autoencoder, txt2img,
)
from .schema import MeshConfig
from .toolkit.quality import QualityReport, clip_score, clip_score_from_embeddings, compare_outputs
from .zoo import (
    ae_kl_f4, ae_kl_f8, ae_kl_f16, ae_vq_f4, ae_vq_f4_no_attn, ae_vq_f8, chinese_clip, clip, clip_large, esr,
    esr_anime, ldm_inpainting, ldm_semantic, ldm_vq, open_clip_ViT_H_14,
)

__all__ = sorted(name for name in globals() if not name.startswith("_") and name != "torch")
