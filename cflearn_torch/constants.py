"""Batch-dict keys (the port's copy of those of `cflearn_tpu/constants.py`)."""

INPUT_KEY = "input"
LABEL_KEY = "labels"
PREDICTIONS_KEY = "predictions"
LOSS_KEY = "loss"
LATENT_KEY = "latent"
AUX_LOSS_KEY = "aux_loss"
MU_KEY = "mu"
LOG_VAR_KEY = "log_var"
BATCH_INDICES_KEY = "batch_indices"
ORIGINAL_LABEL_KEY = "original_labels"

# checkpoints: `<CKPT_PREFIX><step>.npz` under `<workspace>/<CHECKPOINTS_FOLDER>`, scored in `SCORES_FILE`
CKPT_PREFIX = "model_"
SCORES_FILE = "scores.json"
CHECKPOINTS_FOLDER = "checkpoints"
