"""Image loading for the APIs (counterpart of
`cflearn_tpu/api/multimodal/utils.py`): `read_image` takes a path, a PIL
image or an array to an NHWC float32 batch in [0, 1], restricted to a
largest side, snapped to a multiple of `anchor`, or as a mask or grayscale;
`restrict_wh`, `get_suitable_size`, `to_alpha_channel`. PIL is imported
inside the functions, so the port imports without it."""

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np


def restrict_wh(w: int, h: int, max_wh: int) -> Tuple[int, int]:
    """Scale (w, h) down so max(w, h) <= max_wh, keeping the aspect ratio."""
    max_original_wh = max(w, h)
    if max_original_wh <= max_wh:
        return w, h
    wh_ratio = w / h
    if wh_ratio >= 1:
        return max_wh, round(max_wh / wh_ratio)
    return round(max_wh * wh_ratio), max_wh


def get_suitable_size(n: int, anchor: int) -> int:
    """Round to the nearest positive multiple of `anchor`."""
    if n <= anchor:
        return anchor
    mod = n % anchor
    return n - mod + int(mod > 0.5 * anchor) * anchor


def to_alpha_channel(image: Any) -> Any:
    """PIL image → its alpha channel as an L-mode image (white = opaque)."""
    from PIL import Image

    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    if "A" in image.getbands():
        return image.getchannel("A")
    return Image.new("L", image.size, 255)


class ReadImageResponse(NamedTuple):
    image: np.ndarray  # (1, H, W, C) float32 in [0, 1]
    alpha: Optional[np.ndarray]  # (1, H, W, 1) float32 in [0, 1], if present
    original_size: Tuple[int, int]  # (w, h) before any resizing
    original: Any  # the PIL image


def read_image(
    image: Any,
    max_wh: Optional[int],
    *,
    anchor: Optional[int] = 64,
    to_mask: bool = False,
    to_gray: bool = False,
    resample: str = "lanczos",
    normalize: bool = True,
) -> ReadImageResponse:
    """Load a path / PIL image / ndarray into a diffusion-ready batch array:
    restrict to `max_wh`, snap each side to a multiple of `anchor`, optional
    mask/grayscale conversion. RGBA inputs are flattened against white."""
    from PIL import Image

    if isinstance(image, str):
        pil = Image.open(image)
    elif isinstance(image, np.ndarray):
        arr = image
        if arr.ndim == 4:
            arr = arr[0]
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8) if arr.max() <= 1.5 else arr.astype(np.uint8)
        pil = Image.fromarray(arr[..., 0] if (arr.ndim == 3 and arr.shape[-1] == 1) else arr)
    else:
        pil = image
    original = pil
    original_size = pil.size
    alpha: Optional[np.ndarray] = None
    if to_mask or to_gray:
        if to_mask and "A" in pil.getbands():
            pil = pil.getchannel("A")
        else:
            pil = pil.convert("L")
    else:
        if "A" in pil.getbands():
            a = np.asarray(pil.getchannel("A"), np.float32) / 255.0
            alpha = a[None, ..., None]
            background = Image.new("RGB", pil.size, (255, 255, 255))
            background.paste(pil, mask=pil.getchannel("A"))
            pil = background
        else:
            pil = pil.convert("RGB")
    w, h = pil.size
    if max_wh is not None:
        w, h = restrict_wh(w, h, max_wh)
    if anchor is not None:
        w, h = get_suitable_size(w, anchor), get_suitable_size(h, anchor)
    if (w, h) != pil.size:
        filt = {"lanczos": Image.LANCZOS, "bilinear": Image.BILINEAR, "nearest": Image.NEAREST}[resample]
        pil = pil.resize((w, h), filt)
        if alpha is not None:
            a_img = Image.fromarray((alpha[0, ..., 0] * 255).astype(np.uint8)).resize((w, h), filt)
            alpha = (np.asarray(a_img, np.float32) / 255.0)[None, ..., None]
    arr = np.asarray(pil, np.float32)
    if normalize:
        arr = arr / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    if to_mask:
        arr = (arr > 0.5).astype(np.float32) if arr.max() <= 1.0 else (arr > 127.5).astype(np.float32)
    return ReadImageResponse(arr[None], alpha, original_size, original)


__all__ = [
    "ReadImageResponse",
    "read_image",
    "restrict_wh",
    "get_suitable_size",
    "to_alpha_channel",
]
