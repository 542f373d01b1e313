from .common import (
    CONFIGS_DIR,
    ae_kl_f4,
    ae_kl_f8,
    ae_kl_f16,
    ae_vq_f4,
    ae_vq_f4_no_attn,
    ae_vq_f8,
    build_module,
    clip,
    clip_large,
    esr,
    esr_anime,
    ldm_inpainting,
    ldm_semantic,
    ldm_vq,
    load_module,
    open_clip_ViT_H_14,
    parse_config,
)

__all__ = [
    "CONFIGS_DIR", "ae_kl_f4", "ae_kl_f8", "ae_kl_f16", "ae_vq_f4", "ae_vq_f4_no_attn", "ae_vq_f8", "build_module",
    "clip", "clip_large", "esr", "esr_anime", "ldm_inpainting", "ldm_semantic", "ldm_vq", "load_module",
    "open_clip_ViT_H_14", "parse_config",
]
