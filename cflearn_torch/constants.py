"""Batch-dict keys (the port's copy of those of `cflearn_tpu/constants.py`
that it uses)."""

INPUT_KEY = "input"
LOSS_KEY = "loss"
PREDICTIONS_KEY = "predictions"
