"""ControlNet hint annotators (counterpart of
`cflearn_tpu/api/cv/annotator.py`): the `Annotator` registry with canny
(cv2), softedge (HED, else sobel), depth (MiDaS DPT, else a blur proxy),
pose (OpenPose), pidi (PiDiNet) and mlsd (M-LSD), and `ControlNetHints`.

Images go in as uint8 (or [0, 1] float) HWC / NHWC numpy and hints come out
as uint8 of the same layout. The nets run on the annotator's device (the
CUDA card unless `device` is given) without a gradient, on inputs cast to
their parameters' dtype; pre- and post-processing are the JAX package's, on
the host. The sobel and blur fallbacks are what the reference does without
a checkpoint. Checkpoints are local files: `pretrained=True` without a
`ckpt` takes the index entry's file from the download cache
(`download_checkpoint(tag, check_sha=True)`: a file that fails the entry's
recorded sha is fetched again, which fails offline).
"""

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ...toolkit.registry import WithRegister


def _resolve_annotator_ckpt(ckpt: Any, pretrained: bool, tag: str) -> Any:
    if ckpt is None and pretrained:
        from ...toolkit.misc import download_checkpoint

        ckpt = str(download_checkpoint(tag, check_sha=True))
    return ckpt


def run_net(net: nn.Module, x: np.ndarray) -> Any:
    """`net` on the float array `x`, moved to the net's device and dtype,
    without a gradient; every output back as f32 numpy."""
    p = next(net.parameters())
    with torch.no_grad():
        out = net(torch.as_tensor(x, device=p.device).to(p.dtype))
    if isinstance(out, tuple):
        return tuple(o.float().cpu().numpy() for o in out)
    return out.float().cpu().numpy()


class Annotator(WithRegister):
    d: Dict[str, type] = {}

    def annotate(self, image: np.ndarray, **kwargs: Any) -> np.ndarray:
        """uint8 HWC (or NHWC) in -> uint8 hint image out."""
        raise NotImplementedError

    @staticmethod
    def _norm(image: np.ndarray) -> np.ndarray:
        image = np.asarray(image)
        if image.dtype != np.uint8:
            image = (np.clip(image, 0, 1) * 255).astype(np.uint8) if image.max() <= 1.5 else image.astype(np.uint8)
        return image


@Annotator.register("canny")
class CannyAnnotator(Annotator):
    def __init__(self, low_threshold: int = 100, high_threshold: int = 200) -> None:
        self.low = low_threshold
        self.high = high_threshold

    def annotate(
        self,
        image: np.ndarray,
        *,
        low_threshold: Optional[int] = None,
        high_threshold: Optional[int] = None,
        **kwargs: Any,
    ) -> np.ndarray:
        """Per-call thresholds override the constructor's."""
        import cv2

        low = self.low if low_threshold is None else low_threshold
        high = self.high if high_threshold is None else high_threshold
        image = self._norm(image)
        squeeze = image.ndim == 3
        batch = image[None] if squeeze else image
        out = np.stack([np.repeat(cv2.Canny(img, low, high)[..., None], 3, axis=-1) for img in batch])
        return out[0] if squeeze else out


@Annotator.register("softedge")
class SoftEdgeAnnotator(Annotator):
    """Soft edges: the HED net when a checkpoint is given, else the sobel
    magnitude."""

    def __init__(self, hed_ckpt: Any = None, *, pretrained: bool = False, device: Any = None) -> None:
        self._hed = None
        hed_ckpt = _resolve_annotator_ckpt(hed_ckpt, pretrained, "hed")
        if hed_ckpt:
            from .third_party.hed import load_hed

            self._hed = load_hed(hed_ckpt, device=device)

    def annotate(self, image: np.ndarray, **kwargs: Any) -> np.ndarray:
        if self._hed is None:
            return self._sobel(image)
        img = self._norm(image).astype(np.float32)
        squeeze = img.ndim == 3
        batch = img[None] if squeeze else img
        edge = run_net(self._hed, batch)
        out = np.repeat((edge * 255).astype(np.uint8), 3, axis=-1)
        return out[0] if squeeze else out

    def _sobel(self, image: np.ndarray, **kwargs: Any) -> np.ndarray:
        import cv2

        image = self._norm(image)
        squeeze = image.ndim == 3
        batch = image[None] if squeeze else image
        outs = []
        for img in batch:
            gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
            gx = cv2.Sobel(gray, cv2.CV_32F, 1, 0)
            gy = cv2.Sobel(gray, cv2.CV_32F, 0, 1)
            mag = np.sqrt(gx**2 + gy**2)
            mag = (255 * mag / max(mag.max(), 1e-6)).astype(np.uint8)
            outs.append(np.repeat(mag[..., None], 3, axis=-1))
        out = np.stack(outs)
        return out[0] if squeeze else out


@Annotator.register("depth")
class DepthAnnotator(Annotator):
    """MiDaS DPT depth: uint8 RGB -> [-1, 1] (edge-padded to multiples of
    32) -> DPT -> per-image min-max normalised uint8 inverse depth. Without
    a checkpoint, the blur proxy."""

    def __init__(self, ckpt: Any = None, model_type: str = "dpt_large", *, pretrained: bool = False, device: Any = None) -> None:
        self._net = None
        ckpt = _resolve_annotator_ckpt(
            ckpt, pretrained, "midas_dpt_large" if model_type == "dpt_large" else "midas_dpt_hybrid"
        )
        if ckpt:
            from .third_party.midas import load_midas

            self._net = load_midas(ckpt, model_type=model_type, device=device)

    def annotate(self, image: np.ndarray, **kwargs: Any) -> np.ndarray:
        image = self._norm(image)
        squeeze = image.ndim == 3
        batch = image[None] if squeeze else image
        out = self._detect(batch) if self._net is not None else self._blur_proxy(batch)
        return out[0] if squeeze else out

    def raw_depth(self, batch: np.ndarray) -> np.ndarray:
        """uint8 NHWC -> the DPT's raw depth (B, H, W): the processing that
        `annotate` and `MiDaSAPI.detect_normal` share."""
        h, w = batch.shape[1:3]
        ph, pw = -h % 32, -w % 32
        x = batch.astype(np.float32) / 127.5 - 1.0
        if ph or pw:
            x = np.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")
        return run_net(self._net, x)[:, :h, :w]

    def _detect(self, batch: np.ndarray) -> np.ndarray:
        depth = self.raw_depth(batch)
        lo = depth.min(axis=(1, 2), keepdims=True)
        hi = depth.max(axis=(1, 2), keepdims=True)
        depth = (depth - lo) / np.maximum(hi - lo, 1e-6)
        return np.repeat((depth * 255.0).clip(0, 255).astype(np.uint8)[..., None], 3, axis=-1)

    @staticmethod
    def _blur_proxy(batch: np.ndarray) -> np.ndarray:
        import cv2

        outs = []
        for img in batch:
            gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY).astype(np.float32)
            blurred = cv2.GaussianBlur(gray, (21, 21), 0)
            depth = 255.0 - blurred
            depth = (255 * (depth - depth.min()) / max(float(np.ptp(depth)), 1e-6)).astype(np.uint8)
            outs.append(np.repeat(depth[..., None], 3, axis=-1))
        return np.stack(outs)


@Annotator.register("pose")
class PoseAnnotator(Annotator):
    """Body-pose hints from the OpenPose net's heatmap peaks; needs a
    `body_pose_model` checkpoint (`annotate` raises without one)."""

    def __init__(self, ckpt: Any = None, *, pretrained: bool = False, device: Any = None) -> None:
        self._net = None
        ckpt = _resolve_annotator_ckpt(ckpt, pretrained, "body_pose")
        if ckpt:
            from .third_party.openpose import load_openpose

            self._net = load_openpose(ckpt, device=device)

    def annotate(self, image: np.ndarray, **kwargs: Any) -> np.ndarray:
        if self._net is None:
            raise ValueError(
                "pose annotation needs a converted body_pose_model checkpoint "
                "(Annotator.make('pose', {'ckpt': path}))"
            )
        from .third_party.openpose import render_keypoints

        img = self._norm(image).astype(np.float32) / 255.0 - 0.5
        squeeze = img.ndim == 3
        batch = img[None] if squeeze else img
        _, heatmaps = run_net(self._net, batch)
        out = render_keypoints(heatmaps, batch.shape[1:3])
        return out[0] if squeeze else out


@Annotator.register("pidi")
class PiDiAnnotator(Annotator):
    """Soft edges from PiDiNet: uint8 RGB / 255 -> sigmoid edge map -> uint8
    (binarised at `threshold` where given); needs a checkpoint."""

    def __init__(self, ckpt: Any = None, inplane: int = 60, dil: int = 24, *, device: Any = None) -> None:
        self._net = None
        if ckpt:
            from .third_party.pidi import load_pidi

            self._net = load_pidi(ckpt, inplane=inplane, dil=dil, device=device)

    def annotate(self, image: np.ndarray, threshold: Any = None, **kwargs: Any) -> np.ndarray:
        if self._net is None:
            raise ValueError(
                "pidi annotation needs a converted table5_pidinet checkpoint "
                "(Annotator.make('pidi', {'ckpt': path}))"
            )
        image = self._norm(image)
        squeeze = image.ndim == 3
        batch = image[None] if squeeze else image
        edge = run_net(self._net, batch.astype(np.float32) / 255.0)
        if threshold is not None:
            edge = (edge > threshold).astype(np.float32)
        out = np.repeat((edge * 255.0).clip(0, 255).astype(np.uint8)[..., None], 3, axis=-1)
        return out[0] if squeeze else out


@Annotator.register("mlsd")
class MLSDAnnotator(Annotator):
    """Line-segment hints from M-LSD: each image resized to 512² (area), an
    all-ones plane joined before `/127.5 - 1`, the segments decoded and
    drawn white on black, 1 pixel wide, and resized back (nearest)."""

    def __init__(
        self, ckpt: Any = None, value_threshold: float = 0.1, distance_threshold: float = 0.1, *,
        pretrained: bool = False, device: Any = None,
    ) -> None:
        self.value_threshold = value_threshold
        self.distance_threshold = distance_threshold
        self._net = None
        ckpt = _resolve_annotator_ckpt(ckpt, pretrained, "mlsd")
        if ckpt:
            from .third_party.mlsd import load_mlsd

            self._net = load_mlsd(ckpt, device=device)

    def annotate(self, image: np.ndarray, **kwargs: Any) -> np.ndarray:
        if self._net is None:
            raise ValueError(
                "mlsd annotation needs a converted mlsd_large_512_fp32 "
                "checkpoint (Annotator.make('mlsd', {'ckpt': path}))"
            )
        import cv2

        from .third_party.mlsd import decode_lines

        image = self._norm(image)
        squeeze = image.ndim == 3
        batch = image[None] if squeeze else image
        outs = []
        for img in batch:
            h, w = img.shape[:2]
            resized = cv2.resize(img, (512, 512), interpolation=cv2.INTER_AREA)
            x = np.concatenate([resized.astype(np.float32), np.ones((512, 512, 1), np.float32)], axis=-1)
            x = x / 127.5 - 1.0
            tp_map = run_net(self._net, x[None])[0]
            lines = decode_lines(
                tp_map,
                score_thr=kwargs.get("value_threshold", self.value_threshold),
                dist_thr=kwargs.get("distance_threshold", self.distance_threshold),
            )
            canvas = np.zeros((512, 512), dtype=np.uint8)
            for x0, y0, x1, y1 in lines:
                cv2.line(canvas, (int(x0), int(y0)), (int(x1), int(y1)), 255, 1)
            canvas = cv2.resize(canvas, (w, h), interpolation=cv2.INTER_NEAREST)
            outs.append(np.repeat(canvas[..., None], 3, axis=-1))
        out = np.stack(outs)
        return out[0] if squeeze else out


class ControlNetHints:
    """Hint-type names."""

    canny = "canny"
    depth = "depth"
    softedge = "softedge"
    pose = "pose"
    mlsd = "mlsd"
