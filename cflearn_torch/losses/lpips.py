"""LPIPS perceptual distance (counterpart of `cflearn_tpu/losses/lpips.py`).

A VGG16 conv tower tapped after relu1_2 .. relu5_3, each tap unit-normalised
over channels, the squared difference of the two images' taps weighed by a
1x1 conv per tap and averaged over the map. The convs are plain `Conv`
layers (`F.conv2d`), as the JAX package computes them with `nnx.Conv`,
outside any Pallas kernel.

Dtypes follow the JAX package's mixed precision: `shift` and `scale` are f32
buffers (`nnx.Variable`s there, which its compute cast leaves f32), so a bf16
image minus `shift` is f32, and every conv computes in the promoted dtype of
its input and its (possibly bf16) weight: the tower runs in f32.

The pretrained weights are local torch files: torchvision's VGG16
(`features.{i}`) and the lpips lin heads (`mappings.{i}.net.1` or
`lin{i}.model.1`), given as paths or served from the download cache by the
index entries `vgg16_torchvision` and `lpips` (`toolkit.misc.download`, the
entries' shas checked). `LPIPSLoss(pretrained="auto")` loads them when both
are in the cache, and otherwise warns and keeps random weights (the JAX
package's fallback; the port does not try the network for "auto").
"""

import warnings
from typing import Any, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..modules.layers import Conv, resize_bilinear

# VGG16's layers: channels of each 3x3 conv, "M" a 2x2 max pool
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
# torchvision's `features.{i}` index of each conv
VGG16_TORCH_CONV_IDS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


class VGG16Features(nn.Module):
    """VGG16 conv tower returning the relu1_2 .. relu5_3 feature maps (NHWC)."""

    slice_points = [2, 4, 7, 10, 13]  # conv counts after which features are tapped

    def __init__(self) -> None:
        super().__init__()
        convs = []
        ch = 3
        for v in VGG16_CFG:
            if v != "M":
                convs.append(Conv(ch, int(v)))
                ch = int(v)
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        i = 0
        net = x
        for v in VGG16_CFG:
            if v == "M":
                net = F.max_pool2d(net.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
                continue
            net = F.relu(self.convs[i](net))
            i += 1
            if i in self.slice_points:
                feats.append(net)
        return feats


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (x.square().sum(dim=-1, keepdim=True).sqrt() + eps)


class LPIPS(nn.Module):
    """Learned perceptual distance per sample, of NHWC images in [-1, 1]."""

    feature_channels = [64, 128, 256, 512, 512]

    def __init__(self) -> None:
        super().__init__()
        self.vgg = VGG16Features()
        self.register_buffer("shift", torch.tensor([-0.030, -0.088, -0.188]))
        self.register_buffer("scale", torch.tensor([0.458, 0.448, 0.450]))
        self.lins = nn.ModuleList([Conv(c, 1, (1, 1), use_bias=False) for c in self.feature_channels])

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        # VGG16's five pooling stages need >= 32px: smaller images are upsampled first
        b, h, w, c = x.shape
        if h < 32 or w < 32:
            x, y = resize_bilinear(x, max(h, 32), max(w, 32)), resize_bilinear(y, max(h, 32), max(w, 32))
        x = (x - self.shift) / self.scale
        y = (y - self.shift) / self.scale
        total: Any = 0.0
        for feat_x, feat_y, lin in zip(self.vgg(x), self.vgg(y), self.lins):
            diff = (_normalize_tensor(feat_x) - _normalize_tensor(feat_y)).square()
            total = total + lin(diff).mean(dim=(1, 2, 3))
        return total


def _index_file(entry: str) -> Any:
    """The download cache's file of index entry `entry`, fetched where it is
    missing (`download`, with the entry's sha)."""
    from ..toolkit.misc import download
    from ..zoo.common import get_available

    info = get_available()["checkpoints"][entry]
    return download(info["url"], sha=info.get("sha"))


def _cached(entry: str) -> bool:
    from ..toolkit.misc import get_download_cache_dir
    from ..zoo.common import get_available

    info = get_available()["checkpoints"][entry]
    return (get_download_cache_dir() / (info.get("name") or info["url"].split("/")[-1])).is_file()


def load_lpips(lpips_ckpt: Any = None, vgg_ckpt: Any = None, *, pretrained: bool = False) -> LPIPS:
    """LPIPS with random weights, or (`pretrained`, or a path given) with the
    VGG16 tower from torchvision's `vgg16-397923af.pth` at `vgg_ckpt` and the
    lin heads from the lpips checkpoint at `lpips_ckpt`; a file not given
    comes from the download cache (the index entries `vgg16_torchvision`,
    `lpips`). Strict: every conv of the tower and every head is loaded,
    with its shape checked."""
    from ..zoo.convert import load_torch_state_dict

    net = LPIPS()
    if not (pretrained or lpips_ckpt or vgg_ckpt):
        return net
    if vgg_ckpt is None:
        vgg_ckpt = _index_file("vgg16_torchvision")
    if lpips_ckpt is None:
        lpips_ckpt = _index_file("lpips")
    vgg = load_torch_state_dict(vgg_ckpt)
    sd = {}
    for i, ti in enumerate(VGG16_TORCH_CONV_IDS):
        sd[f"vgg.convs.{i}.weight"] = vgg[f"features.{ti}.weight"]
        sd[f"vgg.convs.{i}.bias"] = vgg[f"features.{ti}.bias"]
    for key, value in load_torch_state_dict(lpips_ckpt).items():
        parts = key.split(".")
        if parts[-1] != "weight":
            continue
        if parts[0] == "mappings":
            sd[f"lins.{int(parts[1])}.weight"] = value
        elif parts[0].startswith("lin") and parts[0][3:].isdigit():
            sd[f"lins.{int(parts[0][3:])}.weight"] = value
    own = dict(net.named_parameters())
    wrong = sorted(set(own) ^ set(sd)) + [k for k in sd if k in own and tuple(sd[k].shape) != tuple(own[k].shape)]
    if wrong:
        raise ValueError(f"LPIPS checkpoints do not match the module, e.g. {wrong[:6]}")
    with torch.no_grad():
        for name, value in sd.items():
            own[name].copy_(value)
    return net


class LPIPSLoss(nn.Module):
    """The perceptual loss of predictions against targets, reduced over the
    batch (`reduction` "mean", "sum" or "none"). `pretrained`: "auto" loads
    the checkpoints given or in the download cache and falls back to random
    weights with a warning where they are not there or do not load; True
    requires them; False uses random weights."""

    def __init__(
        self, reduction: str = "mean", pretrained: Any = "auto", *, lpips_ckpt: Any = None, vgg_ckpt: Any = None
    ) -> None:
        super().__init__()
        self.reduction = reduction
        if pretrained in (False, None):
            self.net = LPIPS()
        elif pretrained == "auto" and not ((lpips_ckpt or _cached("lpips")) and (vgg_ckpt or _cached("vgg16_torchvision"))):
            self._random("the checkpoints are neither given nor in the download cache")
        else:
            try:
                self.net = load_lpips(lpips_ckpt, vgg_ckpt, pretrained=True)
            except Exception as e:  # noqa: BLE001  (the "auto" policy falls back, as in the JAX package)
                if pretrained is True:
                    raise
                self._random(str(e))

    def _random(self, why: str) -> None:
        warnings.warn(f"LPIPS pretrained weights unavailable ({why}); using random weights: "
                      "perceptual distances are NOT meaningful")
        self.net = LPIPS()

    def forward(self, predictions: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        losses = self.net(predictions, target)
        if self.reduction == "mean":
            return losses.mean()
        if self.reduction == "sum":
            return losses.sum()
        if self.reduction in ("none", None):
            return losses
        raise ValueError(f"unrecognized reduction '{self.reduction}'")
