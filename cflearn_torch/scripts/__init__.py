from . import sd
