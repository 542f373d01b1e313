from . import datasets
from .api import MLBundledProcessorConfig, MLData, MLDataProcessor, MLProcessorConfig
