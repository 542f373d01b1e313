"""Output-quality measurement for the lossy serving configurations
(counterpart of `cflearn_tpu/toolkit/quality.py`, numpy only).

Each lossy lever (ToMe, DeepCache, the guidance interval, the W8A8 decode)
is measured by its output's deviation from the lossless pipeline on the same
weights, seed and prompt: latent-space error and the decoded images' PSNR /
SSIM. CLIPScore (`clip_score`) measures images against their prompts in a
CLIP embedding space; absolute scores need pretrained CLIP weights, which
are not in the repository. `make_txt2img_with_latents` is the txt2img that
such measurements run.
"""

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["psnr", "ssim", "latent_error", "clip_score_from_embeddings", "clip_score", "QualityReport",
           "compare_outputs", "make_txt2img_with_latents"]


def psnr(ref: np.ndarray, x: np.ndarray, *, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB. `inf` for identical inputs."""
    ref = np.asarray(ref, np.float64)
    x = np.asarray(x, np.float64)
    mse = float(np.mean((ref - x) ** 2))
    if mse == 0.0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (ax / sigma) ** 2)
    k /= k.sum()
    return np.outer(k, k)


def _filter2d_valid(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """'valid' 2D correlation of (H, W) with (k, k) via stride tricks."""
    k = kernel.shape[0]
    h, w = img.shape
    windows = np.lib.stride_tricks.sliding_window_view(img, (k, k))
    return np.einsum("hwij,ij->hw", windows, kernel, optimize=True).reshape(h - k + 1, w - k + 1)


def ssim(ref: np.ndarray, x: np.ndarray, *, data_range: float = 1.0) -> float:
    """Mean structural similarity (Wang et al. 2004): 11x11 gaussian window
    (sigma 1.5), C1=(0.01 L)^2, C2=(0.03 L)^2. Accepts (H, W), (H, W, C) or
    (N, H, W, C); channels and batch are averaged."""
    ref = np.asarray(ref, np.float64)
    x = np.asarray(x, np.float64)
    if ref.shape != x.shape:
        raise ValueError(f"shape mismatch: {ref.shape} vs {x.shape}")
    if ref.ndim == 2:
        ref, x = ref[None, ..., None], x[None, ..., None]
    elif ref.ndim == 3:
        ref, x = ref[None], x[None]
    kernel = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for n in range(ref.shape[0]):
        for c in range(ref.shape[-1]):
            a, b = ref[n, :, :, c], x[n, :, :, c]
            mu_a = _filter2d_valid(a, kernel)
            mu_b = _filter2d_valid(b, kernel)
            mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
            var_a = _filter2d_valid(a * a, kernel) - mu_aa
            var_b = _filter2d_valid(b * b, kernel) - mu_bb
            cov = _filter2d_valid(a * b, kernel) - mu_ab
            s = ((2 * mu_ab + c1) * (2 * cov + c2)) / ((mu_aa + mu_bb + c1) * (var_a + var_b + c2))
            vals.append(float(s.mean()))
    return float(np.mean(vals))


def latent_error(ref: np.ndarray, x: np.ndarray) -> Dict[str, float]:
    """MSE and relative L2 error between latent tensors."""
    ref = np.asarray(ref, np.float64)
    x = np.asarray(x, np.float64)
    mse = float(np.mean((ref - x) ** 2))
    denom = float(np.linalg.norm(ref))
    rel = float(np.linalg.norm(ref - x)) / denom if denom > 0 else float("nan")
    return {"latent_mse": mse, "latent_rel_err": rel}


def clip_score_from_embeddings(image_embeds: np.ndarray, text_embeds: np.ndarray, *, scale: float = 100.0) -> float:
    """CLIPScore over paired (image_i, text_i) embeddings (Hessel et al.
    2021, eq. 1): `scale * max(cos(E_I, E_C), 0)` averaged over the pairs,
    in float64. `scale` is 100 (torchmetrics' convention; the paper's w is
    2.5). The embeddings are L2-normalised here, so raw and normalised
    embeddings score alike."""
    img = np.asarray(image_embeds, np.float64)
    txt = np.asarray(text_embeds, np.float64)
    if img.shape != txt.shape:
        raise ValueError(f"paired embeddings expected, got {img.shape} vs {txt.shape}")
    img = img / np.maximum(np.linalg.norm(img, axis=-1, keepdims=True), 1e-12)
    txt = txt / np.maximum(np.linalg.norm(txt, axis=-1, keepdims=True), 1e-12)
    cos = np.sum(img * txt, axis=-1)
    return float(scale * np.mean(np.maximum(cos, 0.0)))


def clip_score(
    images: Any, texts: Any, *, extractor: Any = None, scale: float = 100.0, batch_size: int = 64
) -> float:
    """CLIPScore of `images` (anything `CLIPExtractor.get_image_latent`
    takes) against their prompts `texts` (one string broadcasts over the
    batch). `extractor`: a `cflearn_torch.api.CLIPExtractor`; without one,
    the zoo's pretrained ViT-B/32 is loaded from the local cache onto the
    card (`CLIPExtractor.from_zoo`), which raises: the index's HF CLIP file
    fills no parameter through the `clip_text` mapping. Random weights give
    a deterministic but arbitrary embedding space: scores compare runs, not
    models."""
    if extractor is None:
        from ..api.multimodal.clip import CLIPExtractor

        extractor = CLIPExtractor.from_zoo(pretrained=True)
    n = len(images)
    if isinstance(texts, str):
        texts = [texts] * n
    if len(texts) != n:
        raise ValueError(f"{n} images vs {len(texts)} texts")
    img = extractor.get_image_latent(images, batch_size=batch_size)
    txt = extractor.get_text_latent(list(texts), batch_size=batch_size)
    return clip_score_from_embeddings(img, txt, scale=scale)


class QualityReport(NamedTuple):
    latent_mse: float
    latent_rel_err: float
    image_psnr: float
    image_ssim: float
    image_max_abs: float

    def to_dict(self) -> Dict[str, float]:
        return dict(self._asdict())


def compare_outputs(
    ref_latents: np.ndarray,
    ref_images: np.ndarray,
    latents: np.ndarray,
    images: np.ndarray,
) -> QualityReport:
    """Compare a variant's (latents, decoded images) against the lossless
    ground truth. Images are float in [-1, 1] (the VAE decode range); PSNR /
    SSIM are computed after rescaling to [0, 1]."""
    le = latent_error(ref_latents, latents)
    ref_img = np.clip((np.asarray(ref_images, np.float64) + 1.0) / 2.0, 0.0, 1.0)
    img = np.clip((np.asarray(images, np.float64) + 1.0) / 2.0, 0.0, 1.0)
    return QualityReport(
        latent_mse=le["latent_mse"],
        latent_rel_err=le["latent_rel_err"],
        image_psnr=psnr(ref_img, img),
        image_ssim=ssim(ref_img, img),
        image_max_abs=float(np.max(np.abs(ref_img - img))),
    )


def make_txt2img_with_latents(
    model: Any,
    *,
    sampler: str = "ddim",
    sampler_config: Optional[Dict[str, Any]] = None,
    num_steps: int = 20,
    guidance_scale: float = 7.5,
) -> Callable[..., Tuple[Any, Any]]:
    """txt2img that returns (latents, float images): the measurement version
    of the serving pipeline (cond and uncond tokens through one text encode,
    the sampler, the decode). `model` is an LDM / `StableDiffusion` whose
    levers (ToMe, the `deepcache_*` attributes) are read at each call.
    Returns `txt2img(tokens, uncond_tokens, z, generator=None)`; it runs
    without a gradient, on the tensors' device."""
    import torch

    from ..modules.multimodal.diffusion.samplers import ISampler

    config = dict(sampler_config or {})

    @torch.no_grad()
    def txt2img(tokens: Any, uncond_tokens: Any, z: Any, generator: Any = None) -> Tuple[Any, Any]:
        cond, uncond = model.get_cond(torch.cat([tokens, uncond_tokens], dim=0)).chunk(2, dim=0)
        s = ISampler.make(sampler, {"model": model, **config})
        latents = s.sample(
            z, cond=cond, uncond=uncond, guidance_scale=guidance_scale, num_steps=num_steps, generator=generator
        )
        return latents, model.decode(latents)

    return txt2img
