from . import tokenizers
from .tokenizers import CLIPTokenizer, ITokenizer
