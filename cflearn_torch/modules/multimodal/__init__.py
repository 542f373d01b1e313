from . import clip, diffusion
from .clip import CLIP, TeTEncoder
