from .clip import CLIPExtractor
from .diffusion import ControlledDiffusionAPI
from .diffusion import DiffusionAPI
from .diffusion import InpaintingMode
from .diffusion import InpaintingSettings
from .utils import ReadImageResponse, get_suitable_size, read_image, restrict_wh, to_alpha_channel
