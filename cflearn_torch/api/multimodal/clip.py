"""`CLIPExtractor`: image and text embeddings of a `CLIP` (counterpart of
`cflearn_tpu/api/multimodal/clip.py`). Images are normalised on the host
with CLIP's statistics and embedded in chunks of `batch_size` on the API's
device; embeddings come back as float32 numpy arrays."""

import os
from typing import Any, List, Optional, Union

import numpy as np
import torch

from ...modules.multimodal.clip import CLIP
from ...modules.nlp.tokenizers import CLIPTokenizer
from ..common import IAPI

# the per-channel statistics the published CLIP weights were trained with
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


class CLIPExtractor(IAPI):
    def __init__(
        self, m: CLIP, *, use_bf16: bool = False, tokenizer: Optional[Any] = None, device: Any = None
    ) -> None:
        if tokenizer is None:
            if getattr(m, "context_length", 77) == 512:
                raise NotImplementedError(
                    "ChineseCLIP (a 512-token BERT text tower and its tokenizer) is not ported yet "
                    "(ROADMAP.md, Queue 1 item 6)"
                )
            tokenizer = CLIPTokenizer()
        super().__init__(m, use_bf16=use_bf16, device=device)
        self.m: CLIP = self.m
        self.tokenizer = tokenizer

    @classmethod
    def from_zoo(
        cls, *, version: str = "base", pretrained: bool = True, use_bf16: bool = False, device: Any = None,
        seed: int = 0,
    ) -> "CLIPExtractor":
        """The zoo's ViT-B/32 ("base") or ViT-L/14 ("large"): with
        `pretrained`, the preset's checkpoint from the local cache, loaded
        strictly (the index's HF CLIP files fill no parameter through the
        `clip_text` mapping, which names an SD checkpoint's text tower: that
        raises, naming them); else seeded random weights."""
        from ... import zoo

        make = {"base": zoo.clip, "large": zoo.clip_large}.get(version)
        if make is None:
            raise ValueError(f"unknown CLIP zoo version {version!r} (base|large)")
        return cls(make(pretrained=pretrained, device=device, seed=seed), use_bf16=use_bf16, device=device)

    def _encode(self, encode: Any, inputs: np.ndarray, batch_size: int) -> np.ndarray:
        outs: List[np.ndarray] = []
        with torch.no_grad():
            for i in range(0, len(inputs), batch_size):
                chunk = torch.as_tensor(inputs[i: i + batch_size], device=self.device)
                outs.append(encode(chunk).float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    def get_image_latent(self, images: Any, *, batch_size: int = 64, **kwargs: Any) -> np.ndarray:
        """images: uint8 NHWC (or HWC), floats in [0, 1] or [-1, 1] (taken
        as such where the smallest value is below -1e-3), at the model's
        `img_size`; or PIL images, resized to it (PIL's default resample).
        Normalised with CLIP's per-channel mean and std."""
        if not isinstance(images, np.ndarray):
            pils = images if isinstance(images, (list, tuple)) else [images]
            if pils and hasattr(pils[0], "getbands"):
                size = getattr(self.m, "img_size", 224)
                images = np.stack([np.asarray(p.convert("RGB").resize((size, size))) for p in pils])
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        if images.dtype == np.uint8:
            images = images.astype(np.float32) / 255.0
        elif images.min() < -1e-3:
            images = (images.astype(np.float32) + 1.0) / 2.0
        images = ((images - CLIP_MEAN) / CLIP_STD).astype(np.float32)
        return self._encode(self.m.encode_image, images, batch_size)

    def get_text_latent(self, texts: Union[str, List[str]], *, batch_size: int = 64) -> np.ndarray:
        tokens = self.tokenizer.tokenize(texts).astype(np.int64)
        return self._encode(self.m.encode_text, tokens, batch_size)

    def get_texts_latent(self, texts: Union[str, List[str]], *, batch_size: int = 64, **kwargs: Any) -> np.ndarray:
        return self.get_text_latent(texts, batch_size=batch_size)

    def get_paths_latent(self, image_paths: List[str], *, batch_size: int = 64, **kwargs: Any) -> np.ndarray:
        from PIL import Image

        images = [Image.open(p) for p in image_paths]
        return self.get_image_latent(images, batch_size=batch_size)

    def get_folder_latent(self, image_folder: str, *, batch_size: int = 64, **kwargs: Any) -> np.ndarray:
        """The images of `image_folder` (by extension), in sorted order."""
        paths = sorted(
            os.path.join(image_folder, f)
            for f in os.listdir(image_folder)
            if os.path.splitext(f)[1].lower() in IMAGE_EXTENSIONS
        )
        return self.get_paths_latent(paths, batch_size=batch_size)

    def zero_shot_classify(self, images: np.ndarray, class_texts: List[str]) -> np.ndarray:
        """The index of the closest of `class_texts` for each image."""
        img = self.get_image_latent(images)
        txt = self.get_text_latent(class_texts)
        return np.argmax(img @ txt.T, axis=-1)
