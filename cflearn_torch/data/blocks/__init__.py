"""Data blocks (counterpart of `cflearn_tpu/data/blocks/`): the tabular
blocks (`ml.py`) and the CV blocks (`cv.py`)."""

from . import cv, ml
