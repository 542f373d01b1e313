"""The image callbacks (counterpart of `cflearn_tpu/callbacks/generator.py`):
at each artifact step (every monitor) they write grids of images under
`<workspace>/images/<step>/`.

* `save_image_grid` — an NHWC batch as one grid image: PIL where it imports,
  else the grid as `<path>.npy`; "tanh" values are mapped from [-1, 1],
  other float images scaled by their range, as the JAX package does;
* `GeneratorCallback` ("generator", "ldm", "ddpm", "ae_kl", "ae_vq", "vae",
  "gan"; also `ImageCallback`) — the batch, a sample of the model's `m`
  where it samples, and the reconstruction where the model returns one;
* `VQVAECallback` ("vq_vae") — originals, reconstructions, the code
  indices, and the codebook's images (per class where `num_classes`);
* `ImageClassificationCallback` ("image_classification") — the batch;
* `SigmoidCallback` ("sigmoid") — the predictions' sigmoid.

The model runs on its own device in eval mode without a gradient; its
outputs come back to the host as numpy before they are drawn.
"""

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..constants import INPUT_KEY, LABEL_KEY, PREDICTIONS_KEY
from ..data.utils import convert, to_numpy
from ..schema.train_schema import TrainerCallback
from .general import ArtifactCallback


def save_image_grid(images: Any, path: str, *, value_range: str = "tanh") -> np.ndarray:
    """Save an NHWC batch as a grid (PIL where available, else `.npy`) and
    return the uint8 grid."""
    images = to_numpy(images) if torch.is_tensor(images) else np.asarray(images)
    if value_range == "tanh":
        images = (np.clip(images, -1, 1) + 1) * 127.5
    elif images.dtype != np.uint8:
        # float images scaled by their range: [0, 1] and standardised inputs would otherwise clip to black
        lo, hi = float(images.min()), float(images.max())
        if hi <= 1.0 + 1e-6 and lo >= -1e-6:
            images = images * 255.0
        elif lo < 0.0 or hi <= 16.0:
            images = (images - lo) / max(hi - lo, 1e-6) * 255.0
        else:
            images = np.clip(images, 0, 255)
    images = images.astype(np.uint8)
    n = images.shape[0]
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    h, w, c = images.shape[1:]
    grid = np.zeros((rows * h, cols * w, c), dtype=np.uint8)
    for i, img in enumerate(images):
        r, cc = divmod(i, cols)
        grid[r * h : (r + 1) * h, cc * w : (cc + 1) * w] = img
    try:
        from PIL import Image

        Image.fromarray(grid[..., 0] if c == 1 else grid).save(path)
    except ImportError:
        np.save(path + ".npy", grid)
    return grid


def run_model(model: Any, batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """`model.run(batch, training=False)` on the model's device without a
    gradient, the tensor outputs as numpy."""
    device = next(model.parameters()).device
    with torch.no_grad():
        outputs = model.run(convert(batch, device), training=False)
    return {k: to_numpy(v) for k, v in outputs.items() if torch.is_tensor(v)}


@TrainerCallback.register("generator")
@TrainerCallback.register("ldm")
@TrainerCallback.register("ddpm")
@TrainerCallback.register("ae_kl")
@TrainerCallback.register("ae_vq")
@TrainerCallback.register("vae")
@TrainerCallback.register("gan")
class GeneratorCallback(ArtifactCallback):
    """The batch, a sample and a reconstruction, each as a grid."""

    key = "images"
    num_samples = 4

    def log_artifacts(self, trainer: Any) -> None:
        if not self.is_local_rank_0:
            return
        folder = self._prepare_folder(trainer)
        if folder is None:
            return
        model = trainer.model
        batch = trainer.train_loader.get_one_batch()
        original = np.asarray(batch[INPUT_KEY])[: self.num_samples]
        save_image_grid(original, os.path.join(folder, "original.png"))
        m = model.m
        try:
            if hasattr(m, "sample"):
                with torch.no_grad():
                    if "num_steps" in m.sample.__code__.co_varnames:
                        sampled = m.sample(self.num_samples, num_steps=10)
                    else:
                        sampled = m.sample(self.num_samples)
                save_image_grid(to_numpy(sampled), os.path.join(folder, "sampled.png"))
        except Exception:  # noqa: BLE001  (sampling is best-effort, as in the JAX package)
            pass
        try:
            recon = run_model(model, {INPUT_KEY: original}).get(PREDICTIONS_KEY)
            if recon is not None and recon.shape == original.shape:
                save_image_grid(recon, os.path.join(folder, "reconstructed.png"))
        except Exception:  # noqa: BLE001
            pass


@TrainerCallback.register("vq_vae")
class VQVAECallback(ArtifactCallback):
    """Originals, reconstructions and code indices from one batch, then the
    codebook's images (and per class, where `num_classes`)."""

    key = "images"
    num_samples = 4

    def __init__(self, *args: Any, num_classes: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.num_classes = num_classes

    def log_artifacts(self, trainer: Any) -> None:
        if not self.is_local_rank_0:
            return
        folder = self._prepare_folder(trainer)
        if folder is None:
            return
        batch = trainer.train_loader.get_one_batch()
        original = np.asarray(batch[INPUT_KEY])[: self.num_samples]
        run_batch = {INPUT_KEY: original}
        labels = batch.get(LABEL_KEY)
        if labels is not None:
            run_batch[LABEL_KEY] = np.asarray(labels)[: self.num_samples]
        save_image_grid(original, os.path.join(folder, "original.png"))
        outputs = run_model(trainer.model, run_batch)
        recon = outputs.get(PREDICTIONS_KEY)
        if recon is not None and recon.shape == original.shape:
            save_image_grid(recon, os.path.join(folder, "reconstructed.png"))
        indices = outputs.get("indices")
        if indices is not None:
            np.save(os.path.join(folder, "code_indices.npy"), indices)
        m = getattr(trainer.model, "m", None)
        if m is None or not hasattr(m, "sample_codebook"):
            return
        from ..toolkit.misc import make_indices_visualization_map

        code_folder = os.path.join(folder, "codes")
        os.makedirs(code_folder, exist_ok=True)
        with torch.no_grad():
            codes, sampled_indices = m.sample_codebook(num_samples=len(original))
        save_image_grid(to_numpy(codes), os.path.join(code_folder, "codes.png"))
        save_image_grid(make_indices_visualization_map(to_numpy(sampled_indices)),
                        os.path.join(code_folder, "code_indices.png"))
        for i in range(self.num_classes or 0):
            i_folder = os.path.join(code_folder, "conditional", str(i))
            os.makedirs(i_folder, exist_ok=True)
            with torch.no_grad():
                codes, ci = m.sample_codebook(num_samples=len(original), class_idx=i)
            save_image_grid(to_numpy(codes), os.path.join(i_folder, "codes.png"))
            save_image_grid(make_indices_visualization_map(to_numpy(ci)), os.path.join(i_folder, "code_indices.png"))


@TrainerCallback.register("image_classification")
class ImageClassificationCallback(ArtifactCallback):
    """The first 16 images of a training batch, scaled by their range."""

    key = "images"

    def log_artifacts(self, trainer: Any) -> None:
        if not self.is_local_rank_0:
            return
        folder = self._prepare_folder(trainer)
        if folder is None:
            return
        batch = trainer.train_loader.get_one_batch()
        save_image_grid(np.asarray(batch[INPUT_KEY])[:16], os.path.join(folder, "batch.png"), value_range="raw")


@TrainerCallback.register("sigmoid")
class SigmoidCallback(ArtifactCallback):
    """The sigmoid of the predictions on four images, as a grid."""

    key = "images"

    def log_artifacts(self, trainer: Any) -> None:
        if not self.is_local_rank_0:
            return
        folder = self._prepare_folder(trainer)
        if folder is None:
            return
        batch = trainer.train_loader.get_one_batch()
        preds = run_model(trainer.model, {INPUT_KEY: np.asarray(batch[INPUT_KEY])[:4]}).get(PREDICTIONS_KEY)
        if preds is not None:
            probs = 1.0 / (1.0 + np.exp(-preds))
            save_image_grid(probs * 2 - 1, os.path.join(folder, "probabilities.png"))


# the reference's name of the artifact callback that draws image grids
ImageCallback = GeneratorCallback
