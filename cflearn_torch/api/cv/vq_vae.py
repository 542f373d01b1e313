"""`VQVAEInference` (counterpart of `cflearn_tpu/api/cv/vq_vae.py`): an
auto-regressive prior trained over a trained VQ-VAE's code indices, then
images sampled through it.

`VQVAEInference(config, workspace=..., vqvae_log_folder=...)` packs the
VQ-VAE's training workspace and loads its model on `device`; `fit(images)`
exports the code indices of every image of `images` (an `IData`) into
`<workspace>/codes/` and fits the prior (`config`, e.g. "pixel_cnn") on
them; `sample`, `decode_indices` and `reconstruct` draw and decode.
The VQ-VAE keeps the mode it loads in, training, as in the JAX package, so
its BatchNorms normalise by each batch's statistics (the code indices depend
on the batch).
`register_callback` registers, per instance, a callback that writes the
original and sampled grids of the prior's validation codes (and per class
and interpolated ones where `num_classes`); the registration stays, so that
a fitted workspace that names it still loads.
"""

import os
from typing import Any, Optional

import numpy as np
import torch

from ...constants import INPUT_KEY, LABEL_KEY, PREDICTIONS_KEY
from ...data.utils import to_numpy
from ...schema.config import DLConfig
from ...schema.data import DataConfig, IData
from ...schema.train_schema import TrainerCallback
from ...toolkit.misc import random_hash


def register_callback(vqvae: Any, num_classes: Optional[int]) -> str:
    """Register a callback bound to the loaded (frozen) VQ-VAE under a
    fresh name, and return the name."""
    from ...callbacks.general import ArtifactCallback
    from ...callbacks.generator import save_image_grid

    tmp_name = random_hash()

    @TrainerCallback.register(tmp_name)
    class _VQVAEInferenceCallback(ArtifactCallback):
        key = "images"
        num_interpolations = 16

        @torch.no_grad()
        def log_artifacts(self, trainer: Any) -> None:
            if not self.is_local_rank_0:
                return
            folder = self._prepare_folder(trainer)
            if folder is None:
                return
            device = next(vqvae.parameters()).device
            batch = (trainer.valid_loader or trainer.train_loader).get_one_batch()
            original_indices = torch.as_tensor(np.asarray(batch[INPUT_KEY]), device=device)
            labels = batch.get(LABEL_KEY)
            labels = None if labels is None else torch.as_tensor(np.asarray(labels), device=device)
            img_size = original_indices.shape[1 if original_indices.ndim == 3 else 2]
            batch_size = original_indices.shape[0]
            m = trainer.model.m  # the prior
            sampled_indices = m.sample(batch_size, img_size=img_size, labels=labels)
            original = vqvae.reconstruct_from(original_indices, labels=labels)
            sampled = vqvae.reconstruct_from(sampled_indices[..., 0], labels=labels)
            save_image_grid(to_numpy(original), os.path.join(folder, "original.png"))
            save_image_grid(to_numpy(sampled), os.path.join(folder, "sampled.png"))
            if num_classes is None:
                return
            ni = self.num_interpolations
            cond_folder = os.path.join(folder, "conditional")
            os.makedirs(cond_folder, exist_ok=True)
            for i in range(num_classes):
                i_indices = m.sample(batch_size, img_size=img_size, class_idx=i)
                i_sampled = vqvae.reconstruct_from(i_indices[..., 0], class_idx=i)
                save_image_grid(to_numpy(i_sampled), os.path.join(cond_folder, f"sampled_{i}.png"))
                i1 = m.sample(ni, img_size=img_size, class_idx=i)
                i2 = m.sample(ni, img_size=img_size, class_idx=i)
                z1, z2 = vqvae.get_code(i1[..., 0]), vqvae.get_code(i2[..., 0])
                ratio = torch.linspace(0.0, 1.0, ni, device=device).reshape(-1, 1, 1, 1)
                z_q = ratio * z1 + (1.0 - ratio) * z2
                i_labels = torch.full((ni,), i, dtype=torch.int32, device=device)
                interpolations = vqvae.decode(z_q, labels=i_labels)
                save_image_grid(to_numpy(interpolations), os.path.join(cond_folder, f"interpolation_{i}.png"))

    return tmp_name


class VQVAEInference:
    """A prior over a trained VQ-VAE's codes. Each instance registers its
    own callback (the JAX package's reference keeps one name a class, so a
    second instance would drop the first's)."""

    def __init__(
        self,
        config: DLConfig,
        *,
        workspace: str,
        vqvae_log_folder: str,
        num_classes: Optional[int] = None,
        device: Any = None,
    ) -> None:
        from ..api import load_inference, pack

        self.config = config
        self.num_classes = num_classes
        self.device = device
        packed_path = os.path.join(str(vqvae_log_folder), "packed")
        pack(str(vqvae_log_folder), packed_path)
        # the module stays in the mode it loads in (training, as the JAX package's does): its BatchNorms
        # normalise by each batch's statistics
        self.vqvae = load_inference(packed_path, device=device).model.m
        self.code_export_folder = os.path.join(workspace, "codes")
        self.tmp_callback_name = register_callback(self.vqvae, num_classes)
        callback_names = config.callback_names or []
        if not isinstance(callback_names, list):
            callback_names = [callback_names]
        config.callback_names = list(callback_names) + [self.tmp_callback_name]
        self.pipeline: Any = None

    @property
    def _device(self) -> torch.device:
        return next(self.vqvae.parameters()).device

    # code export

    @torch.no_grad()
    def export_code_indices(self, data: IData, export_folder: str) -> None:
        """`<split>.npy` (and `<split>_labels.npy`) of the code indices of every
        image of `data`'s loaders; a finished export (`__finished__`) is kept.
        The module's buffers (BatchNorm's running statistics) are put back
        afterwards, as the JAX package's compiled encode leaves its state as
        it was."""
        os.makedirs(export_folder, exist_ok=True)
        buffers = {k: v.clone() for k, v in self.vqvae.named_buffers()}
        try:
            self._export_code_indices(data, export_folder)
        finally:
            for k, v in self.vqvae.named_buffers():
                v.copy_(buffers[k])

    def _export_code_indices(self, data: IData, export_folder: str) -> None:
        finished_path = os.path.join(export_folder, "__finished__")
        if os.path.isfile(finished_path):
            return
        debug = getattr(self.config, "is_debug", False)
        for name, loader in zip(["train", "valid"], data.get_loaders()):
            if loader is None:
                continue
            labels, code_indices = [], []
            for batch in loader:
                y = batch.get(LABEL_KEY)
                if y is not None:
                    labels.append(np.asarray(y))
                net = torch.as_tensor(np.asarray(batch[INPUT_KEY]), device=self._device)
                code_indices.append(to_numpy(self.vqvae.get_code_indices(net)))
                if debug:
                    break
            np.save(os.path.join(export_folder, f"{name}.npy"), np.concatenate(code_indices, axis=0))
            if labels:
                np.save(os.path.join(export_folder, f"{name}_labels.npy"), np.concatenate(labels, axis=0))
        if not debug:
            with open(finished_path, "w"):
                pass

    # fit

    def fit(self, images: IData, data_config: Optional[DataConfig] = None) -> "VQVAEInference":
        from ...data.array import ArrayData
        from ...pipeline.api import DLTrainingPipeline

        export_folder = self.code_export_folder
        self.export_code_indices(images, export_folder)

        def _load(name: str) -> Optional[np.ndarray]:
            path = os.path.join(export_folder, f"{name}.npy")
            return np.load(path) if os.path.isfile(path) else None

        codes = ArrayData.init(data_config).fit(_load("train"), _load("train_labels"), _load("valid"),
                                                _load("valid_labels"))
        self.pipeline = DLTrainingPipeline.init(self.config, device=self.device).fit(codes)
        return self

    # sampling

    @property
    def prior(self) -> Optional[Any]:
        return None if self.pipeline is None else self.pipeline.model.m

    @torch.no_grad()
    def decode_indices(self, indices: Any, **kwargs: Any) -> np.ndarray:
        return to_numpy(self.vqvae.decode_indices(torch.as_tensor(np.asarray(indices), device=self._device), **kwargs))

    @torch.no_grad()
    def reconstruct(self, images: Any) -> np.ndarray:
        out = self.vqvae(torch.as_tensor(np.asarray(images), device=self._device))
        return to_numpy(out[PREDICTIONS_KEY])

    @torch.no_grad()
    def sample(self, num_samples: int, *, class_idx: Optional[int] = None, seed: Optional[int] = None) -> np.ndarray:
        """Images decoded from codes that the prior draws (its generator's
        stream), or, before `fit`, from codes drawn uniformly by
        `np.random.RandomState(seed or 0)` (the JAX package takes a key
        where this takes `seed`)."""
        res = self.vqvae.latent_resolution
        prior = self.prior
        if prior is not None:
            indices = prior.sample(num_samples, img_size=res, class_idx=class_idx)[..., 0]
            labels = prior.get_sample_labels(num_samples, class_idx) if prior.is_conditional else None
            return to_numpy(self.vqvae.decode_indices(indices, labels=labels))
        rng = np.random.RandomState(0 if seed is None else seed)
        indices = torch.as_tensor(rng.randint(0, self.vqvae.num_codes, (num_samples, res, res)), device=self._device)
        if class_idx is not None:
            labels = torch.full((num_samples,), class_idx, dtype=torch.int32, device=self._device)
            return to_numpy(self.vqvae.decode_indices(indices, labels=labels))
        return to_numpy(self.vqvae.decode_indices(indices))
