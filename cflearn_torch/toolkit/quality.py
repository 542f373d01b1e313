"""Output-quality measurement for the lossy serving configurations
(counterpart of `cflearn_tpu/toolkit/quality.py`, numpy only).

Each lossy lever (ToMe, DeepCache, the guidance interval, the W8A8 decode)
is measured by its output's deviation from the lossless pipeline on the same
weights, seed and prompt: latent-space error and the decoded images' PSNR /
SSIM. CLIP score needs pretrained CLIP weights and is not ported.
"""

from typing import Dict, NamedTuple

import numpy as np

__all__ = ["psnr", "ssim", "latent_error", "QualityReport", "compare_outputs"]


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
