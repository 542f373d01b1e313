from . import tokenizers
from .tokenizers import ChineseCLIPTokenizer, CLIPTokenizer, ITokenizer
