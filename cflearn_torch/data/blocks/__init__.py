"""Data blocks (counterpart of `cflearn_tpu/data/blocks/`): the tabular
blocks. The CV blocks are still to be ported."""

from . import ml
