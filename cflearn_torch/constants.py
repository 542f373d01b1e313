"""Batch-dict keys (the port's copy of those of `cflearn_tpu/constants.py`
that it uses)."""

INPUT_KEY = "input"
LABEL_KEY = "labels"
PREDICTIONS_KEY = "predictions"
LOSS_KEY = "loss"
LATENT_KEY = "latent"
AUX_LOSS_KEY = "aux_loss"
