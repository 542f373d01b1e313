from . import cond_models, ddpm, ldm, samplers, unet, utils
from .ddpm import DDPM
from .ldm import LDM, StableDiffusion
from .samplers import ISampler
from .unet import ControlNet, UNetDiffuser
