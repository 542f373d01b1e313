"""Shared by the port's checkpoint tests: the tiny widths of the converters'
cases and the JAX npd / holder helpers."""

import numpy as np
import torch.nn as nn
from flax import nnx

from cflearn_tpu.toolkit.tree import tree_to_npd

UNET = dict(start_channels=32, num_res_blocks=1, channel_multipliers=(1, 2))
UNET_V1 = dict(UNET, attention_downsample_rates=(1,), num_heads=4, context_dim=32)
UNET_V2 = dict(UNET, attention_downsample_rates=(1, 2), num_head_channels=8, num_heads=None, context_dim=32,
               use_linear_in_transformer=True)
VAE = dict(img_size=64, inner_channels=32, z_channels=4, embedding_channels=4, channel_multipliers=(1, 2, 2, 2),
           num_res_blocks=1)
RRDB = dict(latent_channels=16, growth_channels=8, num_blocks=2)
VAE_MAP = {k: VAE[k] for k in ("img_size", "inner_channels", "z_channels", "embedding_channels",
                               "channel_multipliers", "num_res_blocks")}


def unet_map(cfg):
    return dict(UNET, attention_downsample_rates=cfg["attention_downsample_rates"],
                use_linear_in_transformer=cfg.get("use_linear_in_transformer", False))


def npd_of(module, prefix: str = ""):
    return {prefix + k: np.asarray(v) for k, v in tree_to_npd(nnx.state(module, nnx.Param)).items()}


def dotted(npd):
    """JAX npd keys ("unet/conv_in/kernel/value") -> the bridge's dotted paths."""
    return {k[: -len("/value")].replace("/", "."): v for k, v in npd.items()}


def holder_of(prefix: str, module: nn.Module) -> nn.Module:
    holder = nn.Module()
    if prefix:
        setattr(holder, prefix, module)
        return holder
    return module
