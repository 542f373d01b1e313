"""The CV data blocks (counterpart of `cflearn_tpu/data/blocks/cv.py`),
host-side and numpy only:

* runtime blocks — `TupleToBatchBlock`, `ToNumpyBlock`, `ToRGBBlock`,
  `ToHWCBlock`, `HWCToCHWBlock`, `FlattenBlock` (base `IRuntimeDataBlock`);
* normalize blocks — `StaticNormalizeBlock` (x / div),
  `AffineNormalizeBlock` ((x - center) / scale), `ImagenetNormalizeBlock`;
* resize and crop — `ResizeBlock`, `AnchoredResizeBlock`, `CenterCropBlock`,
  `RandomCropBlock`.

Arrays stay channel-last (NHWC or HWC), as in the JAX package, because the
port's models take NHWC as the JAX ones do. The resize is
`jax.image.resize`'s (half-pixel centres, the antialiased triangle or Keys
cubic kernel): `modules.layers.resize` with its weights built on the host,
run on CPU tensors in f32, not `F.interpolate`, whose antialiased bilinear
differs. `RandomCropBlock` draws its offsets from numpy's global generator as
the JAX block does, so that both crop alike from one seed.
"""

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ...constants import INPUT_KEY, LABEL_KEY
from ...modules.layers import resize
from ...schema.data import IDataBlock, INoInitDataBlock


class IRuntimeDataBlock(INoInitDataBlock):
    """A stateless transform of each batch's input."""

    def postprocess_item(self, item: Any, for_inference: bool) -> Any:
        if isinstance(item, dict) and INPUT_KEY in item:
            item[INPUT_KEY] = self.process(item[INPUT_KEY], for_inference)
        return item

    def process(self, net: np.ndarray, for_inference: bool) -> np.ndarray:
        raise NotImplementedError


@IDataBlock.register("tuple_to_batch")
class TupleToBatchBlock(INoInitDataBlock):
    def postprocess_item(self, item: Any, for_inference: bool) -> Any:
        if isinstance(item, (tuple, list)) and len(item) == 2:
            return {INPUT_KEY: np.asarray(item[0]), LABEL_KEY: np.asarray(item[1])}
        return item


@IDataBlock.register("to_numpy")
class ToNumpyBlock(IRuntimeDataBlock):
    def process(self, net: Any, for_inference: bool) -> np.ndarray:
        return np.asarray(net)


@IDataBlock.register("to_rgb")
class ToRGBBlock(IRuntimeDataBlock):
    """Gray to three channels, RGBA to RGB."""

    def process(self, net: np.ndarray, for_inference: bool) -> np.ndarray:
        if net.ndim == 2:
            net = net[..., None]
        if net.shape[-1] == 1:
            net = np.repeat(net, 3, axis=-1)
        elif net.shape[-1] == 4:
            net = net[..., :3]
        return net


@IDataBlock.register("to_hwc")
class ToHWCBlock(IRuntimeDataBlock):
    """CHW to HWC (and NCHW to NHWC) where the layout says so."""

    def process(self, net: np.ndarray, for_inference: bool) -> np.ndarray:
        if net.ndim == 3 and net.shape[0] in (1, 3, 4) and net.shape[-1] not in (1, 3, 4):
            return np.transpose(net, (1, 2, 0))
        if net.ndim == 4 and net.shape[1] in (1, 3, 4) and net.shape[-1] not in (1, 3, 4):
            return np.transpose(net, (0, 2, 3, 1))
        return net


@IDataBlock.register("hwc_to_chw")
class HWCToCHWBlock(IRuntimeDataBlock):
    def process(self, net: np.ndarray, for_inference: bool) -> np.ndarray:
        if net.ndim == 3:
            return np.transpose(net, (2, 0, 1))
        if net.ndim == 4:
            return np.transpose(net, (0, 3, 1, 2))
        return net


@IDataBlock.register("flatten")
class FlattenBlock(IRuntimeDataBlock):
    def process(self, net: np.ndarray, for_inference: bool) -> np.ndarray:
        if net.ndim >= 3:
            return net.reshape(net.shape[0], -1) if net.ndim == 4 else net.reshape(-1)
        return net


# normalize


@IDataBlock.register("static_normalize")
class StaticNormalizeBlock(IDataBlock):
    """x / div in f32."""

    @property
    def fields(self) -> List[str]:
        return ["div"]

    @property
    def init_fields(self) -> Dict[str, Any]:
        return {"div": 255.0}

    def postprocess_item(self, item: Any, for_inference: bool) -> Any:
        if isinstance(item, dict) and INPUT_KEY in item:
            item[INPUT_KEY] = np.asarray(item[INPUT_KEY]).astype(np.float32) / self.div
        return item


@IDataBlock.register("affine_normalize")
class AffineNormalizeBlock(IDataBlock):
    """(x - center) / scale in f32."""

    @property
    def fields(self) -> List[str]:
        return ["center", "scale"]

    @property
    def init_fields(self) -> Dict[str, Any]:
        return {"center": 0.5, "scale": 0.5}

    def postprocess_item(self, item: Any, for_inference: bool) -> Any:
        if isinstance(item, dict) and INPUT_KEY in item:
            net = np.asarray(item[INPUT_KEY]).astype(np.float32)
            item[INPUT_KEY] = (net - self.center) / self.scale
        return item


@IDataBlock.register("imagenet_normalize")
class ImagenetNormalizeBlock(INoInitDataBlock):
    """ImageNet's mean and std, after / 255 where the input is in [0, 255]."""

    mean = np.array([0.485, 0.456, 0.406], dtype=np.float32)
    std = np.array([0.229, 0.224, 0.225], dtype=np.float32)

    def postprocess_item(self, item: Any, for_inference: bool) -> Any:
        if isinstance(item, dict) and INPUT_KEY in item:
            net = np.asarray(item[INPUT_KEY]).astype(np.float32)
            if net.max() > 2.0:
                net = net / 255.0
            item[INPUT_KEY] = (net - self.mean) / self.std
        return item


# resize / crop


def resize_image(net: np.ndarray, size: Tuple[int, int], interpolation: str = "bilinear") -> np.ndarray:
    """`jax.image.resize` of an HWC or NHWC array to `size` in f32, on the
    host (`modules.layers.resize` on CPU tensors)."""
    squeeze = net.ndim == 3
    x = torch.from_numpy(np.ascontiguousarray(net, dtype=np.float32))
    out = resize(x[None] if squeeze else x, size, interpolation).numpy()
    return out[0] if squeeze else out


def _size_of(size: Any) -> Tuple[int, int]:
    return (size, size) if isinstance(size, int) else tuple(size)


@IDataBlock.register("resize")
class ResizeBlock(IDataBlock):
    @property
    def fields(self) -> List[str]:
        return ["size", "interpolation"]

    @property
    def init_fields(self) -> Dict[str, Any]:
        return {"size": 224, "interpolation": "bilinear"}

    def postprocess_item(self, item: Any, for_inference: bool) -> Any:
        if isinstance(item, dict) and INPUT_KEY in item:
            item[INPUT_KEY] = resize_image(np.asarray(item[INPUT_KEY]), _size_of(self.size), self.interpolation)
        return item


@IDataBlock.register("anchored_resize")
class AnchoredResizeBlock(IDataBlock):
    """The short side resized to `anchor`, the aspect ratio kept."""

    @property
    def fields(self) -> List[str]:
        return ["anchor", "interpolation"]

    @property
    def init_fields(self) -> Dict[str, Any]:
        return {"anchor": 256, "interpolation": "bilinear"}

    def postprocess_item(self, item: Any, for_inference: bool) -> Any:
        if isinstance(item, dict) and INPUT_KEY in item:
            net = np.asarray(item[INPUT_KEY])
            h, w = net.shape[-3], net.shape[-2]
            ratio = self.anchor / min(h, w)
            size = (int(round(h * ratio)), int(round(w * ratio)))
            item[INPUT_KEY] = resize_image(net, size, self.interpolation)
        return item


def _crop(net: np.ndarray, top: int, left: int, size: Tuple[int, int]) -> np.ndarray:
    if net.ndim == 3:
        return net[top : top + size[0], left : left + size[1]]
    return net[:, top : top + size[0], left : left + size[1]]


def _center(h: int, w: int, size: Tuple[int, int]) -> Tuple[int, int]:
    return max(0, (h - size[0]) // 2), max(0, (w - size[1]) // 2)


@IDataBlock.register("center_crop")
class CenterCropBlock(IDataBlock):
    @property
    def fields(self) -> List[str]:
        return ["size"]

    @property
    def init_fields(self) -> Dict[str, Any]:
        return {"size": 224}

    def postprocess_item(self, item: Any, for_inference: bool) -> Any:
        if isinstance(item, dict) and INPUT_KEY in item:
            net = np.asarray(item[INPUT_KEY])
            size = _size_of(self.size)
            item[INPUT_KEY] = _crop(net, *_center(net.shape[-3], net.shape[-2], size), size)
        return item


@IDataBlock.register("random_crop")
class RandomCropBlock(IDataBlock):
    """A crop at offsets drawn from numpy's global generator (top, then
    left); the centre crop for inference."""

    @property
    def fields(self) -> List[str]:
        return ["size"]

    @property
    def init_fields(self) -> Dict[str, Any]:
        return {"size": 224}

    def postprocess_item(self, item: Any, for_inference: bool) -> Any:
        if isinstance(item, dict) and INPUT_KEY in item:
            net = np.asarray(item[INPUT_KEY])
            size = _size_of(self.size)
            h, w = net.shape[-3], net.shape[-2]
            if for_inference:
                top, left = _center(h, w, size)
            else:
                top = np.random.randint(0, max(1, h - size[0] + 1))
                left = np.random.randint(0, max(1, w - size[1] + 1))
            item[INPUT_KEY] = _crop(net, top, left, size)
        return item
