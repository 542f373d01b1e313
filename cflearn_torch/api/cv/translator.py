"""`TranslatorAPI`: ESRGAN 4x super-resolution (counterpart of
`cflearn_tpu/api/cv/translator.py`). The network runs on the API's device;
an alpha channel is upscaled apart from it, bilinearly; the uint8 result is
made on the host in numpy."""

from typing import Any, Optional

import numpy as np
import torch

from ...modules.cv.classifier import RRDBNet
from ...modules.layers import resize
from ..common import IAPI


class TranslatorAPI(IAPI):
    def __init__(self, m: RRDBNet, *, use_bf16: bool = False, device: Any = None) -> None:
        super().__init__(m, use_bf16=use_bf16, device=device)
        self.m: RRDBNet = self.m

    @torch.no_grad()
    def sr(self, image: Any, export_path: Optional[str] = None, *, max_wh: int = 2048) -> np.ndarray:
        """4x upscale. uint8 or [0, 1] float NHWC (or HWC) arrays, paths or
        PIL images in (RGB or RGBA); uint8 out. `export_path` saves the
        result."""
        was_single_pil = False
        if isinstance(image, str) or (not isinstance(image, np.ndarray) and hasattr(image, "getbands")):
            from ..multimodal.utils import read_image

            res = read_image(image, None, anchor=None)
            image = res.image
            if res.alpha is not None:
                image = np.concatenate([image, res.alpha], axis=-1)
            was_single_pil = True
        image = np.asarray(image)
        squeeze = image.ndim == 3 or was_single_pil
        if image.ndim == 3:
            image = image[None]
        image = image.astype(np.float32) / 255.0 if image.dtype == np.uint8 else image.astype(np.float32)
        alpha = None
        if image.shape[-1] == 4:
            alpha = image[..., 3:]
            image = image[..., :3]
        _, h, w, _ = image.shape
        if max(h, w) > max_wh:
            raise ValueError(f"image too large ({h}x{w} > {max_wh})")
        net = self.m(torch.as_tensor(image, device=self.device))
        out = net.float().cpu().numpy()
        if alpha is not None:
            up = resize(torch.as_tensor(alpha, device=self.device), out.shape[1:3], "bilinear")
            out = np.concatenate([out, up.cpu().numpy()], axis=-1)
        out = (np.clip(out, 0.0, 1.0) * 255.0).round().astype(np.uint8)
        out = out[0] if squeeze else out
        if export_path is not None:
            from PIL import Image

            Image.fromarray(out if out.ndim == 3 else out[0]).save(export_path)
        return out

    @classmethod
    def from_esr(cls, *, pretrained: bool = False, device: Any = None, seed: int = 0, **kwargs: Any) -> "TranslatorAPI":
        """ESRGAN (23 blocks) with seeded random weights; `pretrained=True`
        raises: the weights are not in the repository."""
        from ...zoo import esr

        return cls(esr(pretrained=pretrained, device=device, seed=seed), device=device, **kwargs)

    @classmethod
    def from_esr_anime(
        cls, *, pretrained: bool = False, device: Any = None, seed: int = 0, **kwargs: Any
    ) -> "TranslatorAPI":
        """ESRGAN for anime images (6 blocks), as `from_esr`."""
        from ...zoo import esr_anime

        return cls(esr_anime(pretrained=pretrained, device=device, seed=seed), device=device, **kwargs)
