"""Training-side models (counterpart of `cflearn_tpu/models/`)."""
