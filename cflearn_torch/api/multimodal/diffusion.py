"""`DiffusionAPI` and `ControlledDiffusionAPI` (counterpart of
`cflearn_tpu/api/multimodal/diffusion.py`): txt2img with seeds, slerped
variations, batching, a callback, clip skip and the high-resolution second
pass; img2img; inpainting on a 9-channel inpainting UNet (NORMAL or MASKED:
cropped to the mask's box), on a concat-conditioned LDM, or by repaint on a
plain one; outpainting; `semantic2img` and `sr` on concat-conditioned LDMs;
every registered sampler; ToMe, DeepCache, style reference (`setup_hooks`),
tiling mode (`switch_circular`), LoRA packs, an SD weight pool; and
multi-ControlNet sampling with per-hint scales and start / end gating.
`from_sd` / `from_sd_inpainting`, `from_inpainting` and `from_semantic`
build the zoo's models with seeded random weights. `ControlledDiffusionAPI`
also runs the hint annotators (`get_hint_of`).

`compile(num_samples, size, ...)` is the JAX package's ahead-of-time
compile of one shape bucket, here as CUDA graphs: in a compiled bucket each
distinct UNet call of the sampler loop (the full pass, and DeepCache's
shallow pass) is captured once (`ops.graphs.CapturedCall`, the graphs of an
API sharing one memory pool) and replayed on every later call; DeepCache's
feature stays in the full graph's static output, which the shallow graph
reads in place. Every switch that would make the JAX package drop its
compiled programs drops the graphs, and the next call in the bucket
captures them again. On the CPU `compile` captures nothing and the calls
run eagerly.

The JAX package compiles each call into one cached program; here the calls
run the modules directly on the API's device (the CUDA card unless the
caller asks for another), through the kernels where the modules route them.
Images come back as uint8 NHWC numpy arrays. Inputs are numpy arrays (uint8,
or floats in [-1, 1]), paths or PIL images (through `utils.read_image`).

Every random draw of the API (the starting latents, the variations,
inpainting's noise) goes through `DiffusionAPI._randn`, the samplers'
through `ISampler._randn` and style reference's through
`SpatialTransformerHooks._randn`, each from a `torch.Generator` seeded by
the call's seed.
"""

from contextlib import contextmanager
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ...device import resolve_device
from ...modules.common import cast_parameters
from ...modules.core.convs import Conv2d
from ...modules.core.lora import LoRAManager, LoRAPack
from ...modules.core.mixed_stacks import SpatialTransformer, SpatialTransformerHooks, StyleReferenceStates
from ...modules.layers import resize, resize_bilinear
from ...modules.multimodal.diffusion.samplers import ISampler
from ...modules.multimodal.diffusion.unet import style_reference_write_gates
from ...modules.multimodal.diffusion.utils import CONCAT_TYPE, CROSS_ATTN_TYPE, HYBRID_TYPE
from ...modules.nlp.tokenizers import CLIPTokenizer
from ...ops.graphs import CapturedCall
from ...pipeline import default_tokenizer
from ...toolkit.misc import slerp
from ..common import Weights
from .utils import read_image

TNumberPair = Optional[Union[int, Tuple[int, int]]]


def _to_uint8(images: Union[torch.Tensor, np.ndarray]) -> np.ndarray:
    """[-1, 1] floats -> uint8 (truncated), in the images' dtype."""
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(images)
    return ((images.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8).cpu().numpy()


def _from_uint8(images: np.ndarray) -> np.ndarray:
    return images.astype(np.float32) / 127.5 - 1.0


def _is_path_or_pil(image: Any) -> bool:
    return isinstance(image, str) or (not isinstance(image, np.ndarray) and hasattr(image, "getbands"))


# ---------------------------------------------------------------------------
# crop-to-mask inpainting, on the host (numpy; resizes by torch on the CPU)
# ---------------------------------------------------------------------------


def _pair(v: TNumberPair) -> Optional[Tuple[int, int]]:
    if v is None:
        return None
    if isinstance(v, int):
        return v, v
    return int(v[0]), int(v[1])


def _resize_np(arr: np.ndarray, wh: Tuple[int, int], method: str = "bilinear") -> np.ndarray:
    """Resize an HW or HWC numpy array to (w, h) as `jax.image.resize` does:
    bilinear with half-pixel centres (antialiased where it shrinks), or
    nearest sampling pixel centres."""
    w, h = wh
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[..., None]
    x = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))[None]
    out = resize(x, (h, w), method)[0].numpy()
    return out[..., 0] if squeeze else out


def _box_blur(mask: np.ndarray, blur: Tuple[int, int]) -> np.ndarray:
    """Separable box blur of a 2-D float mask, edges replicated."""
    bw, bh = blur
    out = mask.astype(np.float32)
    if bw > 1:
        k = np.ones(bw, np.float32) / bw
        out = np.apply_along_axis(
            lambda r: np.convolve(np.pad(r, bw // 2, mode="edge"), k, "same")[bw // 2: bw // 2 + r.size], 1, out
        )
    if bh > 1:
        k = np.ones(bh, np.float32) / bh
        out = np.apply_along_axis(
            lambda c: np.convolve(np.pad(c, bh // 2, mode="edge"), k, "same")[bh // 2: bh // 2 + c.size], 0, out
        )
    return out


class ImageBox(NamedTuple):
    """An l / t / r / b crop box."""

    l: int
    t: int
    r: int
    b: int

    @classmethod
    def from_mask(cls, mask: np.ndarray, threshold: float) -> "ImageBox":
        ys, xs = np.nonzero(mask > threshold)
        if ys.size == 0:
            return cls(0, 0, mask.shape[1], mask.shape[0])
        return cls(int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1)

    def crop(self, arr: np.ndarray) -> np.ndarray:
        return arr[self.t: self.b, self.l: self.r]


def adjust_lt_rb(box: ImageBox, w: int, h: int, padding: TNumberPair) -> ImageBox:
    """Pad the mask's box, then widen it so that the crop keeps the image's
    aspect ratio."""
    l, t, r, b = box
    pad = _pair(padding)
    if pad is not None:
        l = max(0, l - pad[0])
        t = max(0, t - pad[1])
        r = min(w, r + pad[0])
        b = min(h, b + pad[1])
    ch, cw = b - t, r - l
    if ch / cw > h / w:
        dw, dh = (int(ch * w / h) - cw) // 2, 0
    else:
        dw, dh = 0, (int(cw * h / w) - ch) // 2
    if dw > 0:
        if l < dw:
            l, r = 0, min(w, cw + dw * 2)
        elif r + dw > w:
            l, r = max(0, w - cw - dw * 2), w
        else:
            l, r = l - dw, r + dw
    if dh > 0:
        if t < dh:
            t, b = 0, min(h, ch + dh * 2)
        elif b + dh > h:
            t, b = max(0, h - ch - dh * 2), h
        else:
            t, b = t - dh, b + dh
    return ImageBox(l, t, r, b)


class InpaintingMode(str, Enum):
    NORMAL = "normal"
    MASKED = "masked"


@dataclass
class InpaintingSettings:
    """MASKED mode crops to the padded box of the mask, diffuses the crop at
    the working resolution and pastes it back with a feathered blend."""

    mode: InpaintingMode = InpaintingMode.NORMAL
    mask_blur: TNumberPair = None
    mask_padding: TNumberPair = 32
    mask_binary_threshold: Optional[int] = 32
    target_wh: TNumberPair = None


class CropResponse(NamedTuple):
    box: ImageBox
    wh: Tuple[int, int]
    original_image: np.ndarray  # (b, H, W, C) float [-1, 1]
    cropped_mask: np.ndarray  # (ch, cw) float binary
    image: np.ndarray  # (b, h, w, C) resized crop
    mask: np.ndarray  # (b, h, w, 1) resized mask


def _round64(v: int) -> int:
    return max(64, int(round(v / 64)) * 64)


def fidelity_start_step(fidelity: float, num_steps: int) -> int:
    """Skip the first fidelity * n steps: fidelity 1 keeps the input, 0
    regenerates it."""
    return max(0, min(num_steps - 1, int(round(fidelity * num_steps))))


def crop_masked_area(image: np.ndarray, mask: np.ndarray, settings: InpaintingSettings) -> CropResponse:
    """`image` (b, H, W, C) float [-1, 1], `mask` (b, H, W, 1) float [0, 1];
    the batch shares sample 0's mask box."""
    b, h, w = image.shape[:3]
    mask2d = mask[0, :, :, 0]
    raw_threshold = settings.mask_binary_threshold
    threshold = (32 if raw_threshold is None else raw_threshold) / 255.0
    box = adjust_lt_rb(ImageBox.from_mask(mask2d, threshold), w, h, settings.mask_padding)
    t_wh = _pair(settings.target_wh)
    tw, th = t_wh if t_wh is not None else (w, h)
    tw, th = _round64(tw), _round64(th)
    cropped_mask = (box.crop(mask2d) > threshold).astype(np.float32)
    resized_image = np.stack([_resize_np(box.crop(img), (tw, th)) for img in image])
    resized_mask = _resize_np(cropped_mask, (tw, th), "nearest")
    resized_mask = np.broadcast_to(resized_mask[None, :, :, None], (b, th, tw, 1)).copy()
    return CropResponse(box, (tw, th), image, cropped_mask, resized_image, resized_mask)


def recover_masked_area(
    sampled: np.ndarray,
    crop: CropResponse,
    settings: InpaintingSettings,
    original_u8: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Resize the diffused crop back, blend it with the (blurred) mask and
    paste it into the original. uint8 NHWC; outside the box the pixels are
    the input's, bit for bit, when `original_u8` is given."""
    l, t, r, b = crop.box
    ch, cw = b - t, r - l
    blurred = crop.cropped_mask
    pad = _pair(settings.mask_padding)
    if pad is not None and pad[0] > 0 and pad[1] > 0:
        blurred = _box_blur(blurred, pad)
    blurred = blurred[..., None]
    if original_u8 is None:
        original_u8 = _to_uint8(crop.original_image)
    out = original_u8.copy()
    untouched = blurred[:, :, 0] == 0.0
    for i, s in enumerate(sampled):
        s = _resize_np(s, (cw, ch))
        region = crop.original_image[i, t:b, l:r]
        mixed_u8 = _to_uint8(np.ascontiguousarray(s * blurred + region * (1.0 - blurred)))
        mixed_u8[untouched] = out[i, t:b, l:r][untouched]
        out[i, t:b, l:r] = mixed_u8
    return out


def _signature(tree: Any) -> Any:
    """The shapes and dtypes of a tensor, a dict of them, or None."""
    if torch.is_tensor(tree):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, dict):
        return tuple((k, _signature(v)) for k, v in sorted(tree.items()))
    return tree


def _clone(tree: Any) -> Any:
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree


class _GraphedModel:
    """The model as a sampler sees it in a compiled bucket: every attribute
    is the model's, and `denoise` replays the CUDA graph of its signature
    (captured at its first call). The eps output is copied out of the
    graph's static tensor, since the next replay overwrites it and the
    multistep samplers keep past outputs; DeepCache's feature is handed on
    as the full graph's static output, which the shallow graph reads in
    place. A call with more than the UNet (controls, hooks) raises: a
    compiled bucket never runs part of its loop eagerly."""

    def __init__(self, api: "DiffusionAPI") -> None:
        self._api = api
        self._m = api.m

    def __getattr__(self, name: str) -> Any:
        return getattr(self._m, name)

    def _static_cache(self, cache: torch.Tensor) -> bool:
        return any(isinstance(c.static_outputs, tuple) and c.static_outputs[1] is cache for c in self._api._graphs.values())

    def denoise(
        self,
        net: torch.Tensor,
        timesteps: torch.Tensor,
        cond: Optional[Any] = None,
        *,
        deep_cache: Optional[torch.Tensor] = None,
        return_cache: bool = False,
        **kwargs: Any,
    ) -> Any:
        if kwargs:
            raise NotImplementedError(f"a compiled bucket captures the UNet call alone, not with {sorted(kwargs)}")
        api = self._api
        inputs: Dict[str, Any] = {"net": net, "timesteps": timesteps, "cond": cond}
        if deep_cache is not None:
            inputs["deep_cache"] = deep_cache
        key = tuple((k, _signature(v)) for k, v in inputs.items()) + (return_cache,)
        call = api._graphs.get(key)
        if call is None:
            static = {k: (v if k == "deep_cache" and self._static_cache(v) else _clone(v)) for k, v in inputs.items()}
            if api._graph_pool is None:
                api._graph_pool = torch.cuda.graph_pool_handle()
            m = self._m
            call = CapturedCall(lambda **kw: m.denoise(**kw, return_cache=return_cache), static, pool=api._graph_pool)
            api._graphs[key] = call
        out = call(**inputs)
        if deep_cache is not None or return_cache:
            return out[0].clone(), out[1]
        return out.clone()


class DiffusionAPI:
    """txt2img / img2img / inpainting over an `LDM` (SD), and outpainting,
    `semantic2img` and `sr` over the concat-conditioned LDMs. `use_bf16`
    casts its parameters to bf16 (the schedule buffers stay f32)."""

    def __init__(
        self,
        m: Any,
        *,
        use_bf16: bool = False,
        tokenizer: Optional[CLIPTokenizer] = None,
        device: Any = None,
    ) -> None:
        self.device = resolve_device(device)
        self.m = m.to(self.device).eval()
        self.use_bf16 = use_bf16
        if use_bf16:
            cast_parameters(self.m, torch.bfloat16)
        self.tokenizer = tokenizer or default_tokenizer()
        self.sampler_name = "ddim"
        self.sampler_config: Dict[str, Any] = {}
        self._sd_weights = Weights()
        self._current_sd: Optional[str] = None
        self.lora_manager = LoRAManager()
        self._style_ref: Optional[Dict[str, Any]] = None
        self._circular = False
        # `compile`: the buckets (UNet batch, image size), their UNet calls' graphs by signature, one memory pool
        self._compiled: set = set()
        self._graphs: Dict[Any, CapturedCall] = {}
        self._graph_pool: Any = None

    # ------------------------------------------------------------- switches

    def _drop_graphs(self) -> None:
        """Forget the captured UNet calls (where the JAX package clears its
        compiled programs); the compiled buckets capture again at their next
        call."""
        self._graphs.clear()
        self._graph_pool = None

    def switch_sampler(self, sampler: str, **sampler_config: Any) -> None:
        if sampler not in ISampler.d:
            raise ValueError(f"unknown sampler '{sampler}' (available: {sorted(ISampler.d)})")
        self.sampler_name = sampler
        self.sampler_config = sampler_config
        self._drop_graphs()

    def switch_circular(self, enable: bool) -> None:
        """Tiling mode: circular padding on every `Conv2d` of the model. As
        in the JAX package that reaches only the `Conv2d` modules (in SD:
        the UNet's and the VAE decoder's upsample convs); the other convs
        keep zero padding."""
        self._circular = enable
        for module in self.m.modules():
            if isinstance(module, Conv2d):
                module.set_circular(enable)
        self._drop_graphs()

    def set_tome_ratio(self, ratio: float, *, merge_mlp: bool = False) -> None:
        """ToMe token merging on every `SpatialTransformer` (`merge_mlp`: the
        feed-forward runs on the merged tokens too)."""
        for module in self.m.modules():
            if isinstance(module, SpatialTransformer):
                module.set_tome_ratio(ratio, merge_mlp=merge_mlp)
        self._drop_graphs()

    def set_deepcache(self, interval: Optional[int], *, cut: int = 3, center: Optional[float] = None) -> None:
        """DeepCache (Ma et al. 2023): every `interval`-th step of a ddim /
        basic sampler runs the full UNet and caches the deep feature, the
        others run the shallowest `cut` input blocks and `cut` + 1 output
        blocks around it (None or <= 1: off). `center` in [0, 1] places the
        same number of full passes around that point of the whole loop."""
        self.m.deepcache_interval = None if interval is not None and interval <= 1 else interval
        self.m.deepcache_cut = cut
        self.m.deepcache_center = center
        self._drop_graphs()

    def setup_hooks(
        self,
        *,
        tome_info: Optional[Dict[str, Any]] = None,
        style_reference_image: Optional[Any] = None,
        style_reference_states: Optional[Dict[str, Any]] = None,
    ) -> None:
        """ToMe (`tome_info`: {"ratio", "merge_mlp"}) and style reference
        ("reference-only") for `txt2img`: each denoise step runs a WRITE UNet
        pass over the q-sampled latent of `style_reference_image` (uint8 or
        [-1, 1] NHWC / HWC, a path or a PIL image; sides rounded up to
        multiples of 64) and lets self-attention READ the banked
        activations. `style_reference_states` holds `StyleReferenceStates`'
        settings. Without an image the style reference is cleared. A style
        reference cannot be compiled (`compile`): setting one also forgets
        the compiled buckets."""
        if tome_info is not None:
            self.set_tome_ratio(float(tome_info.get("ratio", 0.5)), merge_mlp=bool(tome_info.get("merge_mlp", False)))
        self._drop_graphs()
        if style_reference_image is None:
            self._style_ref = None
            return
        self._compiled.clear()
        states = StyleReferenceStates(**(style_reference_states or {}))
        image = self._norm_image(style_reference_image)
        h, w = image.shape[1:3]
        th, tw = _round64(h), _round64(w)
        if (th, tw) != (h, w):
            image = np.stack([_resize_np(im, (tw, th)) for im in image])
        gates = style_reference_write_gates(self.m.unet, states.reference_weight)
        self._style_ref = {"states": states, "gates": tuple(gates), "image": image}

    def _style_sig(self) -> Optional[Tuple[Any, ...]]:
        """What the style reference is set to: (fidelity, weight, gates,
        image shape), or None."""
        if self._style_ref is None:
            return None
        s = self._style_ref["states"]
        return (s.style_fidelity, s.reference_weight, self._style_ref["gates"], self._style_ref["image"].shape)

    def _style_hooks(
        self, ref_image: torch.Tensor, b: int, cfg: bool, generator: torch.Generator
    ) -> SpatialTransformerHooks:
        """The hooks of one txt2img batch of `b`: the reference encoded by
        the first stage (its latents in f32), and under CFG the uncond rows
        b..2b of the model's batch."""
        style = self._style_ref
        return SpatialTransformerHooks(
            style=style["states"], write_gates=list(style["gates"]),
            uncond_mask=(torch.arange(2 * b, device=self.device) >= b)[:, None, None] if cfg else None,
            ref_latent=self.m.encode_first_stage(ref_image).float(), generator=generator,
        )

    @contextmanager
    def _load_context(self, ignore_lora: bool) -> Iterator[Any]:
        restored = None
        if ignore_lora and self.lora_manager._active:
            restored = dict(self.lora_manager._active)
            self.lora_manager.deactivate(self.m)
        try:
            yield self.m
        finally:
            if restored:
                # the weights may have been replaced inside: fuse on the new base
                self.lora_manager.reset_base()
                self.lora_manager.apply_lora(self.m, *restored.keys(), scales=restored)
            self._drop_graphs()

    def load_context(self, *, ignore_lora: bool = True) -> Any:
        """A context yielding the bare model for weight loading: active LoRA
        fusions are removed on entry and fused again, on the weights found
        then, on exit."""
        return self._load_context(ignore_lora)

    # ----------------------------------------------------------------- lora

    def load_sd_lora(self, key: str, *, path: Optional[str] = None, pack: Optional[LoRAPack] = None) -> None:
        if pack is None:
            assert path is not None, "either `path` or `pack` is required"
            pack = LoRAManager.load_torch_lora(path)
        self.lora_manager.load_pack_with(key, pack)

    def inject_sd_lora(self, *keys: str) -> None:
        self.lora_manager.apply_lora(self.m, *keys)
        self._drop_graphs()

    def set_sd_lora_scales(self, scales: Dict[str, float]) -> None:
        self.lora_manager.set_scales(self.m, scales)
        self._drop_graphs()

    def cleanup_sd_lora(self) -> None:
        self.lora_manager.deactivate(self.m)
        self._drop_graphs()

    # --------------------------------------------------------- weight pools

    def prepare_sd(self, versions: Dict[str, Dict[str, Any]]) -> None:
        """Register alternative SD weights: {tag: {parameter name: array}}."""
        for tag, states in versions.items():
            self._sd_weights.register(tag, states)

    @torch.no_grad()
    def switch_sd(self, tag: str) -> None:
        states = self._sd_weights.get(tag)
        if states is None:
            raise ValueError(f"sd tag '{tag}' is not prepared")
        if self._current_sd != tag:
            params = dict(self.m.named_parameters())
            unknown = sorted(set(states) - set(params))
            if unknown:
                raise ValueError(f"not parameters of the model: {unknown[:10]}")
            for name, value in states.items():
                params[name].copy_(torch.as_tensor(np.asarray(value)))
            self._current_sd = tag
            self._drop_graphs()

    # ------------------------------------------------------------ internals

    def _tokens(self, texts: List[str]) -> torch.Tensor:
        return torch.as_tensor(self.tokenizer.tokenize(texts), dtype=torch.long, device=self.device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _randn(self, shape: Tuple[int, ...], generator: torch.Generator, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """N(0, 1) on the API's device: every draw the API makes."""
        return torch.randn(shape, generator=generator, device=self.device, dtype=dtype)

    def _sampler(self, graphed: bool = False) -> ISampler:
        """The sampler over the model, or over `_GraphedModel` (the UNet
        calls replayed from CUDA graphs) in a compiled bucket."""
        model = _GraphedModel(self) if graphed else self.m
        return ISampler.make(self.sampler_name, dict(self.sampler_config, model=model))

    def _in_compiled_bucket(self, rows: int, size: Tuple[int, int]) -> bool:
        return self.device.type == "cuda" and self._style_ref is None and (rows, size) in self._compiled

    def compile(
        self,
        *,
        num_samples: int = 1,
        size: Tuple[int, int] = (512, 512),
        num_steps: int = 20,
        guidance_scale: float = 7.5,
    ) -> None:
        """Compile txt2img for the bucket of `num_samples` images at `size`
        (sides rounded up to multiples of 64) ahead of its first call: on
        the card one txt2img in the bucket runs here and captures each UNet
        call of its loop in a CUDA graph (with CFG, 2 x `num_samples` rows;
        with DeepCache, the full and the shallow pass); later `sample` /
        `txt2img` calls in the bucket replay them, other shapes run eagerly.
        On the CPU nothing is captured. A style reference cannot be
        captured: its WRITE pass draws the reference's noise inside each
        UNet call and hands the banked activations between two passes
        through host-side hooks, so `compile` raises with one set."""
        if self._style_ref is not None:
            raise NotImplementedError(
                "compile with a style reference: its WRITE pass draws noise and banks activations through "
                "host-side hooks inside each UNet call, which a CUDA graph does not capture; clear it with "
                "`setup_hooks()` first"
            )
        size = (_round64(size[0]), _round64(size[1]))
        self._compiled.add((num_samples, size))
        if self.device.type == "cuda":
            self.sample(num_samples, size=size, num_steps=num_steps, guidance_scale=guidance_scale, seed=0)

    def graph_launches(self) -> Dict[str, int]:
        """{kernel: launches made by replays} over the captured UNet calls:
        each graph's launches per replay times its replays."""
        out: Dict[str, int] = {}
        for call in self._graphs.values():
            for k, n in call.launches().items():
                out[k] = out.get(k, 0) + n
        return out

    def _conds(self, tokens: torch.Tensor, uncond_tokens: torch.Tensor, guidance_scale: float) -> Tuple[Any, Any]:
        cond = self.m.get_cond(tokens)
        return cond, (self.m.get_cond(uncond_tokens) if guidance_scale != 1.0 else None)

    def _make_noise(
        self,
        num_samples: int,
        size: Tuple[int, int],
        seed: Optional[int],
        variations: Optional[List[Tuple[int, float]]],
    ) -> torch.Tensor:
        shape = (num_samples, size[0] // 8, size[1] // 8, self.m.out_channels)
        if seed is None:
            seed = np.random.randint(0, 2**31 - 1)
        z = self._randn(shape, self._generator(seed))
        for v_seed, strength in variations or []:
            z = slerp(self._randn(shape, self._generator(v_seed)), z, strength)
        return z

    @staticmethod
    def _prompts(cond: Optional[Union[str, List[str]]], n: int) -> List[str]:
        prompts = cond if cond is not None else [""] * n
        return [prompts] * n if isinstance(prompts, str) else list(prompts)

    # ------------------------------------------------------------------ api

    @torch.no_grad()
    def sample(
        self,
        num_samples: int,
        *,
        cond: Optional[Union[str, List[str]]] = None,
        negative_prompt: str = "",
        size: Tuple[int, int] = (512, 512),
        num_steps: int = 20,
        guidance_scale: float = 7.5,
        seed: Optional[int] = None,
        variations: Optional[List[Tuple[int, float]]] = None,
        variation_seed: Optional[int] = None,
        variation_strength: Optional[float] = None,
        z: Optional[Any] = None,
        batch_size: Optional[int] = None,
        callback: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        clip_skip: Optional[int] = None,
        highres_info: Optional[Dict[str, Any]] = None,
        export_path: Optional[str] = None,
        **kwargs: Any,
    ) -> np.ndarray:
        """txt2img. Returns uint8 NHWC images.

        `z` gives the starting latents; otherwise they are drawn from `seed`
        and slerped with each (seed, strength) of `variations`, then with
        `variation_seed` at `variation_strength`. With a style reference
        (`setup_hooks`) every batch is sampled with its hooks. `batch_size`
        splits `num_samples` into batches; `callback` maps the decoded float images
        (numpy) before the uint8 cast; `clip_skip` sets the text encoder's
        tap for this call; `highres_info` ({"upscale_factor", "fidelity"})
        upscales the result and runs img2img on it."""
        prompts = self._prompts(cond, num_samples)
        if len(prompts) != num_samples:
            raise ValueError(
                f"`num_samples` ({num_samples}) should be identical with the number of `cond` ({len(prompts)})"
            )
        size = (_round64(size[0]), _round64(size[1]))
        cm = getattr(self.m, "condition_model", None)
        clip_skip_backup: Optional[int] = None
        if clip_skip is not None and hasattr(cm, "clip_skip"):
            clip_skip_backup = cm.clip_skip
            cm.clip_skip = int(clip_skip)
        try:
            tokens = self._tokens(prompts)
            uncond = self._tokens([negative_prompt] * num_samples)
            if z is not None:
                z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
            else:
                z = self._make_noise(num_samples, size, seed, variations)
                if variation_seed is not None and variation_strength:
                    z = slerp(self._randn(tuple(z.shape), self._generator(variation_seed)), z, variation_strength)
            generator = self._generator(seed or 0)
            chunk = batch_size or num_samples
            ref_image = None if self._style_ref is None else torch.as_tensor(self._style_ref["image"], device=self.device)
            outs = []
            for lo in range(0, num_samples, chunk):
                hi = min(num_samples, lo + chunk)
                c, u = self._conds(tokens[lo:hi], uncond[lo:hi], guidance_scale)
                kw = {} if ref_image is None else {"hooks": self._style_hooks(ref_image, hi - lo, u is not None, generator)}
                latents = self._sampler(self._in_compiled_bucket(hi - lo, size)).sample(
                    z[lo:hi], cond=c, uncond=u, guidance_scale=guidance_scale, num_steps=num_steps, generator=generator,
                    **kw,
                )
                outs.append(self.m.decode(latents))
            images = torch.cat(outs, dim=0)
        finally:
            if clip_skip_backup is not None:
                cm.clip_skip = clip_skip_backup
        if callback is not None:
            images = torch.as_tensor(callback(images.float().cpu().numpy()), device=self.device)
        if highres_info:
            upscale = highres_info.get("upscale_factor", 2.0)
            hr_size = (int(size[0] * upscale), int(size[1] * upscale))
            return self.img2img(
                _to_uint8(resize_bilinear(images, *hr_size)), cond=prompts, negative_prompt=negative_prompt,
                fidelity=highres_info.get("fidelity", 0.3), num_steps=num_steps, guidance_scale=guidance_scale,
                seed=seed,
            )
        out = _to_uint8(images)
        if export_path is not None:
            self._export(out, export_path)
        return out

    def txt2img(self, txt: Union[str, List[str]], **kwargs: Any) -> np.ndarray:
        prompts = [txt] if isinstance(txt, str) else list(txt)
        return self.sample(len(prompts), cond=prompts, **kwargs)

    @torch.no_grad()
    def img2img(
        self,
        image: np.ndarray,
        *,
        cond: Optional[Union[str, List[str]]] = None,
        negative_prompt: str = "",
        fidelity: float = 0.2,
        num_steps: int = 20,
        guidance_scale: float = 7.5,
        seed: Optional[int] = None,
        export_path: Optional[str] = None,
        **kwargs: Any,
    ) -> np.ndarray:
        """`image`: uint8 or [-1, 1] float NHWC, a path or a PIL image.
        Sides that are not multiples of 64 are resized up to the rounded
        size for sampling, and the result back (for a path or a PIL image:
        to its size before `read_image` snapped it to the 64px grid)."""
        if _is_path_or_pil(image):
            res = read_image(image, None, anchor=64)
            image = (res.image * 2.0 - 1.0).astype(np.float32)
            original_hw = (res.original_size[1], res.original_size[0])  # read_image reports (w, h)
        else:
            image = self._norm_image(image)
            original_hw = (image.shape[1], image.shape[2])
        b = image.shape[0]
        rounded_hw = (_round64(original_hw[0]), _round64(original_hw[1]))
        x = torch.as_tensor(image, device=self.device)
        if (image.shape[1], image.shape[2]) != rounded_hw:
            x = resize_bilinear(x, *rounded_hw)
        prompts = self._prompts(cond, b)
        c, u = self._conds(self._tokens(prompts), self._tokens([negative_prompt] * b), guidance_scale)
        # the latents in f32, as the JAX encoder leaves them for an f32 image
        z0 = self.m.encode_first_stage(x).float()
        latents = self._sampler().sample_from(
            z0, cond=c, uncond=u, guidance_scale=guidance_scale, num_steps=num_steps,
            start_step=fidelity_start_step(fidelity, num_steps), generator=self._generator(seed or 0),
        )
        out = _to_uint8(self.m.decode(latents))
        if rounded_hw != original_hw:
            back = resize_bilinear(torch.from_numpy(out).float(), *original_hw)
            out = back.round().clamp(0, 255).to(torch.uint8).numpy()
        if export_path is not None:
            self._export(out, export_path)
        return out

    def _inpaint(
        self,
        image: np.ndarray,
        mask: np.ndarray,
        tokens: torch.Tensor,
        uncond_tokens: torch.Tensor,
        *,
        num_steps: int,
        guidance_scale: float,
        force_repaint: bool,
        ref_fidelity: Optional[float],
        seed: int,
    ) -> torch.Tensor:
        """The decoded inpainting (float NHWC). A 9-channel inpainting UNet
        takes the mask and the masked image's latents joined to its input
        (the hybrid condition; a concat-only LDM takes them as its
        condition); a plain UNet samples freely and keeps the original
        latents outside the mask (repaint). `ref_fidelity` starts from the
        q-sampled original latents at that fidelity."""
        m = self.m
        x = torch.as_tensor(image, device=self.device)
        mask_t = torch.as_tensor(mask, device=self.device)
        text, text_u = self._conds(tokens, uncond_tokens, guidance_scale)
        z0 = m.encode_first_stage(x).float()
        b, lh, lw, _ = z0.shape
        latent_mask = resize(mask_t, (lh, lw), "nearest")
        sampler = self._sampler()
        generator = self._generator(seed)
        z = self._randn(tuple(z0.shape), generator)
        start_step = None if ref_fidelity is None else fidelity_start_step(ref_fidelity, num_steps)

        def run_sampler(cond: Any, uncond: Any) -> torch.Tensor:
            kw = dict(cond=cond, uncond=uncond, guidance_scale=guidance_scale, num_steps=num_steps, generator=generator)
            if start_step is None:
                return sampler.sample(z, **kw)
            return sampler.sample_from(z0, start_step=start_step, **kw)

        if m.unet.in_channels > m.out_channels and not force_repaint:
            if m.condition_type == CONCAT_TYPE:
                # concat-only LDM inpainting: the masked image filled with -1,
                # then the mask in [-1, 1]; no text, no CFG; the unmasked
                # pixels come from the input
                zmb = m.encode_first_stage(x * (1.0 - mask_t) - mask_t).float()
                latents = run_sampler(torch.cat([zmb, latent_mask * 2.0 - 1.0], dim=-1), None)
                return x * (1.0 - mask_t) + m.decode(latents) * mask_t
            zm = m.encode_first_stage(x * (1.0 - mask_t)).float()
            concat = torch.cat([latent_mask, zm], dim=-1)
            cond = {CONCAT_TYPE: concat, CROSS_ATTN_TYPE: text}
            uncond = None if text_u is None else {CONCAT_TYPE: concat, CROSS_ATTN_TYPE: text_u}
            backup = m.condition_type
            m.condition_type = HYBRID_TYPE
            try:
                latents = run_sampler(cond, uncond)
            finally:
                m.condition_type = backup
        else:
            latents = run_sampler(text, text_u)
            latents = latents * latent_mask + z0 * (1.0 - latent_mask)
        return m.decode(latents)

    @torch.no_grad()
    def inpainting(
        self,
        image: np.ndarray,
        mask: np.ndarray,
        *,
        cond: Optional[Union[str, List[str]]] = None,
        negative_prompt: str = "",
        num_steps: int = 20,
        guidance_scale: float = 7.5,
        seed: Optional[int] = None,
        export_path: Optional[str] = None,
        inpainting_settings: Optional[InpaintingSettings] = None,
        use_raw_inpainting: bool = False,
        use_background_guidance: bool = False,
        reference_fidelity: float = 0.2,
        keep_original: bool = False,
        keep_original_fade: int = 50,
        **kwargs: Any,
    ) -> np.ndarray:
        """Masked generation (mask: 1 = regenerate). `inpainting_settings`
        selects NORMAL (the whole canvas) or MASKED (the crop around the
        mask); `use_raw_inpainting` forces repaint on a 9-channel UNet;
        `use_background_guidance` (or `refine_fidelity`) starts from the
        q-sampled original at `reference_fidelity`; `keep_original` pastes
        the original's unmasked pixels back over a `keep_original_fade`
        pixel band."""
        refine_fidelity = kwargs.pop("refine_fidelity", None)
        if refine_fidelity is not None:
            use_background_guidance = True
            reference_fidelity = float(refine_fidelity)
        if _is_path_or_pil(image):
            image = self._norm_image(image)
        raw = np.asarray(image)
        if raw.ndim == 3:
            raw = raw[None]
        original_u8 = raw if raw.dtype == np.uint8 else None
        image = self._norm_image(raw)
        b = image.shape[0]
        if _is_path_or_pil(mask):
            mask = read_image(mask, None, anchor=None, to_mask=True).image[..., 0]
        mask = np.asarray(mask).astype(np.float32)
        if mask.ndim == 2:
            mask = mask[None, :, :, None]
        elif mask.ndim == 3:
            mask = mask[..., None] if mask.shape[-1] not in (1,) else mask[None]
        mask = (mask > 0.5).astype(np.float32)
        full_mask = mask
        settings = inpainting_settings
        crop_ctx: Optional[CropResponse] = None
        if settings is not None and settings.mode == InpaintingMode.MASKED:
            crop_ctx = crop_masked_area(image, mask, settings)
            image, mask = crop_ctx.image, crop_ctx.mask
        if settings is not None:
            blur = _pair(settings.mask_blur)
            if blur is not None and blur[0] > 0 and blur[1] > 0:
                mask = np.stack([_box_blur(mk[:, :, 0], blur)[:, :, None] for mk in mask])
        prompts = self._prompts(cond, b)
        sampled = self._inpaint(
            image, mask, self._tokens(prompts), self._tokens([negative_prompt] * b), num_steps=num_steps,
            guidance_scale=guidance_scale, force_repaint=use_raw_inpainting,
            ref_fidelity=reference_fidelity if use_background_guidance else None, seed=seed or 0,
        )
        if crop_ctx is not None:
            out = recover_masked_area(
                np.clip(sampled.float().cpu().numpy(), -1.0, 1.0), crop_ctx, settings, original_u8=original_u8
            )
        else:
            out = _to_uint8(sampled)
        if keep_original:
            if original_u8 is not None:
                orig_u8 = original_u8
            else:
                orig_u8 = _to_uint8(crop_ctx.original_image if crop_ctx is not None else image)
            alpha2d = full_mask[0, :, :, 0]
            if keep_original_fade:
                f = int(keep_original_fade)
                alpha2d = _box_blur(alpha2d, (f, f))
            alpha = alpha2d[None, :, :, None]
            blended = out.astype(np.float32) * alpha + orig_u8.astype(np.float32) * (1.0 - alpha)
            blended_u8 = np.clip(np.round(blended), 0, 255).astype(np.uint8)
            untouched = alpha2d == 0.0
            blended_u8[:, untouched] = orig_u8[:, untouched]
            out = blended_u8
        if export_path is not None:
            self._export(out, export_path)
        return out

    def txt2img_inpainting(self, txt: Union[str, List[str]], image: np.ndarray, mask: np.ndarray, **kwargs: Any) -> np.ndarray:
        """Text-guided inpainting: `inpainting` with `cond=txt`."""
        return self.inpainting(image, mask, cond=txt, **kwargs)

    def _require_concat(self, what: str) -> None:
        if self.m.condition_type != CONCAT_TYPE:
            raise ValueError(f"`{what}` requires a concat-conditioned LDM")

    @torch.no_grad()
    def semantic2img(
        self, semantic: np.ndarray, *, num_steps: int = 20, seed: Optional[int] = None, **kwargs: Any
    ) -> np.ndarray:
        """Segmentation map -> image through the concat condition. `semantic`
        is a class-index map (an integer (H, W) or (B, H, W) array, one-hot
        to the condition model's `in_channels`) or a one-hot (B, H, W, C)
        array; values stay {0, 1}. A condition model (the semantic LDM's
        `Rescaler`) takes the map at full resolution; without one the map is
        resized (nearest) to h // 8 x w // 8, as the JAX package does for
        any first stage."""
        self._require_concat("semantic2img")
        if _is_path_or_pil(semantic):
            from PIL import Image

            img = Image.open(semantic) if isinstance(semantic, str) else semantic
            semantic = np.asarray(img.convert("L"))
        semantic = np.asarray(semantic)
        num_classes = getattr(self.m.condition_model, "in_channels", None)
        # integer (..., C) arrays with C the condition model's channels are already one-hot
        is_index_map = np.issubdtype(semantic.dtype, np.integer) and (
            semantic.ndim <= 2 or (semantic.ndim == 3 and semantic.shape[-1] != (num_classes or -1))
        )
        if is_index_map:
            if num_classes is None:
                num_classes = int(semantic.max()) + 1
            semantic = np.eye(num_classes, dtype=np.float32)[semantic]
        if semantic.ndim == 3:
            semantic = semantic[None]
        sem = torch.as_tensor(semantic.astype(np.float32), device=self.device)
        b, h, w, _ = sem.shape
        if self.m.condition_model is None:
            sem = resize(sem, (h // 8, w // 8), "nearest")
        cond = self.m.get_cond(sem)
        generator = self._generator(seed or 0)
        z = self._randn((b, cond.shape[1], cond.shape[2], self.m.out_channels), generator)
        latents = self._sampler().sample(z, cond=cond, num_steps=num_steps, generator=generator)
        return _to_uint8(self.m.decode(latents))

    @torch.no_grad()
    def sr(self, image: np.ndarray, *, num_steps: int = 20, seed: Optional[int] = None, **kwargs: Any) -> np.ndarray:
        """Diffusion super-resolution x4: the [-1, 1] image upsampled
        (`jax.image.resize`'s bicubic) is the concat condition of latents at
        the upsampled size, decoded by the first stage where there is one."""
        self._require_concat("sr")
        image = self._norm_image(image)
        b, h, w, c = image.shape
        up = 4
        lr_up = resize(torch.as_tensor(image, device=self.device), (h * up, w * up), "bicubic")
        generator = self._generator(seed or 0)
        z = self._randn((b, h * up, w * up, self.m.out_channels), generator)
        latents = self._sampler().sample(z, cond=lr_up, num_steps=num_steps, generator=generator)
        return _to_uint8(self.m.decode(latents) if self.m.first_stage is not None else latents)

    def outpainting(self, image: Any, second: Any = None, *, anchor: str = "center", **kwargs: Any) -> np.ndarray:
        """Outpainting in two conventions: `outpainting(txt, rgba)` with an
        RGBA uint8 array whose alpha is the mask (transparent = generate),
        through `txt2img_inpainting`; or `outpainting(image, **kwargs)`,
        which pads the canvas by a quarter of each side (zeros, mid-grey in
        [-1, 1]) and inpaints the border."""
        if isinstance(image, str) and second is not None:
            if _is_path_or_pil(second):
                from PIL import Image

                second = Image.open(second) if isinstance(second, str) else second
                if second.mode != "RGBA":
                    raise ValueError("`image` should be `RGBA` in outpainting")
            arr = np.asarray(second)
            rgb, alpha = arr[..., :3], arr[..., 3]
            mask = (255 - alpha.astype(np.int32)).astype(np.uint8)
            return self.txt2img_inpainting(image, rgb, (mask > 127).astype(np.float32), **kwargs)
        image = self._norm_image(image)
        b, h, w, c = image.shape
        pad_h, pad_w = h // 4, w // 4
        canvas = np.zeros((b, h + 2 * pad_h, w + 2 * pad_w, c), dtype=np.float32)
        canvas[:, pad_h: pad_h + h, pad_w: pad_w + w] = image
        mask = np.ones((b, h + 2 * pad_h, w + 2 * pad_w, 1), dtype=np.float32)
        mask[:, pad_h: pad_h + h, pad_w: pad_w + w] = 0.0
        return self.inpainting(canvas, mask, **kwargs)

    # ---------------------------------------------------------------- utils

    @staticmethod
    def _norm_image(image: Any) -> np.ndarray:
        """uint8 -> [-1, 1] f32; floats as they are; HWC gets a batch axis;
        a path or a PIL image through `read_image`."""
        if _is_path_or_pil(image):
            return (read_image(image, None).image * 2.0 - 1.0).astype(np.float32)
        image = np.asarray(image)
        if image.ndim == 3:
            image = image[None]
        if image.dtype == np.uint8:
            image = _from_uint8(image)
        return image.astype(np.float32)

    @staticmethod
    def _export(images: np.ndarray, path: str) -> None:
        try:
            from PIL import Image
        except ImportError:
            np.save(path + ".npy", images)
            return
        if images.shape[0] == 1:
            Image.fromarray(images[0]).save(path)
        else:
            stem, _, suffix = path.rpartition(".")
            for i, img in enumerate(images):
                Image.fromarray(img).save(f"{stem}_{i}.{suffix}")

    # ----------------------------------------------------------- construct

    @classmethod
    def from_sd(
        cls,
        version: str = "v1",
        *,
        pretrained: bool = False,
        use_bf16: bool = True,
        device: Any = None,
        seed: int = 0,
        **kwargs: Any,
    ) -> "DiffusionAPI":
        """SD of `version` through the zoo's `load_sd`, with seeded random
        weights or (`pretrained`) the version's checkpoint from the local
        cache, built in bf16 (`use_bf16`) or f32 on `device` (the CUDA card
        unless the caller asks for another). Versions ending in
        `_inpainting` build `StableDiffusionInpainting`; the community tags
        ("v1.5", "anime*", "dreamlike*") are the v1 architecture; "v2_v" is
        the v-prediction model."""
        from ...zoo.common import load_sd

        m = load_sd(
            version, pretrained=pretrained, device=resolve_device(device),
            dtype=torch.bfloat16 if use_bf16 else torch.float32, seed=seed,
        )
        return cls(m, use_bf16=use_bf16, device=device, **kwargs)

    @classmethod
    def from_sd_inpainting(cls, *, pretrained: bool = False, use_bf16: bool = True, **kwargs: Any) -> "DiffusionAPI":
        return cls.from_sd("v1_inpainting", pretrained=pretrained, use_bf16=use_bf16, **kwargs)

    @classmethod
    def _from_zoo(
        cls, factory: Callable[..., Any], pretrained: bool, use_bf16: bool, ldm_kwargs: Optional[Dict[str, Any]],
        device: Any, seed: int, kwargs: Dict[str, Any],
    ) -> "DiffusionAPI":
        m = factory(
            pretrained=pretrained, device=resolve_device(device), dtype=torch.bfloat16 if use_bf16 else torch.float32,
            seed=seed, **(ldm_kwargs or {}),
        )
        return cls(m, use_bf16=use_bf16, device=device, **kwargs)

    @classmethod
    def from_inpainting(
        cls, *, pretrained: bool = False, use_bf16: bool = True, ldm_kwargs: Optional[Dict[str, Any]] = None,
        device: Any = None, seed: int = 0, **kwargs: Any,
    ) -> "DiffusionAPI":
        """The concat-conditioned LDM inpainting model (`zoo.ldm_inpainting`:
        7 latent channels, an attention-free VQ first stage, resblock
        resampling), seeded random weights or (`pretrained`) its checkpoint
        from the local cache; `ldm_kwargs` go to the zoo's constructor."""
        from ...zoo.common import ldm_inpainting

        return cls._from_zoo(ldm_inpainting, pretrained, use_bf16, ldm_kwargs, device, seed, kwargs)

    @classmethod
    def from_semantic(
        cls, *, pretrained: bool = False, use_bf16: bool = True, ldm_kwargs: Optional[Dict[str, Any]] = None,
        device: Any = None, seed: int = 0, **kwargs: Any,
    ) -> "DiffusionAPI":
        """The semantic-map LDM (`zoo.ldm_semantic`: 182-channel one-hot maps
        through a `Rescaler`, the concat condition), seeded random weights
        or (`pretrained`) its checkpoint from the local cache."""
        from ...zoo.common import ldm_semantic

        return cls._from_zoo(ldm_semantic, pretrained, use_bf16, ldm_kwargs, device, seed, kwargs)


class ControlledDiffusionAPI(DiffusionAPI):
    """Multi-ControlNet txt2img: control branches keyed by hint name, with
    per-hint scales and start / end gating."""

    def __init__(self, m: Any, **kwargs: Any) -> None:
        super().__init__(m, **kwargs)
        self.controls: Dict[str, Any] = {}
        self.control_scales: Dict[str, float] = {}
        self.annotators: Dict[str, Any] = {}
        self._control_enabled = True

    def prepare_control(self, hint: str, control_net: Any) -> None:
        """Register a ControlNet for a hint type (moved to the API's device)."""
        self.controls[hint] = control_net.to(self.device).eval()
        self.control_scales.setdefault(hint, 1.0)

    def switch_control(self, *hints: str) -> None:
        """Keep only the given hints' controls."""
        self.controls = {h: c for h, c in self.controls.items() if h in hints}
        self._drop_graphs()

    def enable_control(self) -> None:
        self._control_enabled = True

    def disable_control(self) -> None:
        """`sample_with_control` samples without control while disabled."""
        self._control_enabled = False

    def prepare_annotator(self, hint: str, **kwargs: Any) -> None:
        """Build the annotator of a hint type once (`Annotator.make(hint,
        kwargs)`: a checkpoint, a model type, a device), so that later
        `get_hint_of` calls reuse its loaded net."""
        from ..cv.annotator import Annotator

        if hint not in self.annotators:
            self.annotators[hint] = Annotator.make(hint, kwargs)

    def prepare_annotators(self) -> None:
        """Prepare the annotator of every prepared control's hint type that
        names one (a control under a name of its own has none)."""
        from ..cv.annotator import Annotator

        for hint in self.controls:
            if Annotator.has(hint):
                self.prepare_annotator(hint)

    def get_hint_of(self, hint: str, image: np.ndarray, **kwargs: Any) -> np.ndarray:
        """The hint of `image` by the hint type's annotator (prepared with
        its defaults if it is not yet); `kwargs` go to `annotate`."""
        self.prepare_annotator(hint)
        return self.annotators[hint].annotate(image, **kwargs)

    @torch.no_grad()
    def sample_with_control(
        self,
        num_samples: int,
        hint_images: Dict[str, np.ndarray],
        *,
        cond: Optional[Union[str, List[str]]] = None,
        negative_prompt: str = "",
        size: Tuple[int, int] = (512, 512),
        num_steps: int = 20,
        guidance_scale: float = 7.5,
        seed: Optional[int] = None,
        hint_starts: Optional[Dict[str, float]] = None,
        hint_ends: Optional[Dict[str, float]] = None,
        **kwargs: Any,
    ) -> np.ndarray:
        """Every prepared hint of `hint_images` (uint8 or [-1, 1] NHWC, at
        the image size) drives its ControlNet at once; the residuals are
        summed at the per-hint scales, each hint on between its start and
        end fractions of the loop."""
        if not self._control_enabled:
            return self.sample(
                num_samples, cond=cond, negative_prompt=negative_prompt, size=size, num_steps=num_steps,
                guidance_scale=guidance_scale, seed=seed, **kwargs,
            )
        names = list(hint_images)
        nets = []
        for name in names:
            control_net = self.controls.get(name)
            if control_net is None:
                raise ValueError(f"control '{name}' is not prepared")
            nets.append(control_net)
        prompts = self._prompts(cond, num_samples)
        c, u = self._conds(self._tokens(prompts), self._tokens([negative_prompt] * num_samples), guidance_scale)
        hints = [torch.as_tensor(self._norm_image(hint_images[n]), device=self.device) for n in names]
        n_levels = len(nets[0].unet.input_chans) + 2
        scales = [[self.control_scales.get(n, 1.0)] * n_levels for n in names]
        starts = [None if not hint_starts else hint_starts.get(n) for n in names]
        ends = [None if not hint_ends else hint_ends.get(n) for n in names]
        gating = any(s is not None for s in starts) or any(e is not None for e in ends)
        gate_kw = {"control_hint_start": starts, "control_hint_end": ends} if gating else {}
        generator = self._generator(seed or 0)
        z = self._randn((num_samples, size[0] // 8, size[1] // 8, self.m.out_channels), generator)
        latents = self._sampler().sample(
            z, cond=c, uncond=u, guidance_scale=guidance_scale, num_steps=num_steps, generator=generator,
            control_net=nets, control_hint=hints, control_scales=scales, **gate_kw,
        )
        return _to_uint8(self.m.decode(latents))
