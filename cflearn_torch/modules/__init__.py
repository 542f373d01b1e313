"""The modules (counterpart of `cflearn_tpu/modules/__init__.py`). The
sub-packages `core`, `cv`, `ml`, `multimodal` and `nlp` import on first
access: their modules import the schema, which imports this package."""

import importlib

from .common import PrefixModules, build_module, module_registry, register_module

_SUBPACKAGES = ("core", "cv", "ml", "multimodal", "nlp")


def __getattr__(name: str):
    if name in _SUBPACKAGES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
