"""`UNetDiffuser` — the SD UNet (counterpart of
`cflearn_tpu/modules/multimodal/diffusion/unet.py`: the full pass and
DeepCache's shallow pass; no ControlNet, no hooks). Channel-last NHWC."""

import math
from typing import Any, List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...common import register_module, zero_module
from ...core.convs import Downsample, ResidualBlockWithTimeEmbedding, UpsampleConv2d
from ...core.mixed_stacks import SpatialTransformer
from ...layers import Conv, Embed, GroupNorm, Linear


def timestep_embedding(timesteps: torch.Tensor, dim: int, *, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding in f32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


class _InBlock(nn.Module):
    """One input/output stage: a chain of resblock / transformer / resampler."""

    def __init__(self, modules: List[nn.Module]) -> None:
        super().__init__()
        self.mods = nn.ModuleList(modules)

    def forward(
        self, net: torch.Tensor, time_embed: torch.Tensor, context: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        for mod in self.mods:
            if isinstance(mod, ResidualBlockWithTimeEmbedding):
                net = mod(net, time_embed)
            elif isinstance(mod, SpatialTransformer):
                net = mod(net, context)
            else:
                net = mod(net)
        return net


@register_module("diffusion/unet")
class UNetDiffuser(nn.Module):
    """SD UNet. SD-1.5: in/out 4 channels, start 320, multipliers
    (1, 2, 4, 4), attention at downsample rates (1, 2, 4), 8 heads, context
    768. `num_classes`: a class-label embedding added to the time embedding
    (the `adm` condition)."""

    def __init__(
        self,
        *,
        in_channels: int = 4,
        out_channels: int = 4,
        start_channels: int = 320,
        num_res_blocks: int = 2,
        attention_downsample_rates: Tuple[int, ...] = (1, 2, 4),
        channel_multipliers: Tuple[int, ...] = (1, 2, 4, 4),
        num_heads: Optional[int] = 8,
        num_head_channels: Optional[int] = None,
        num_transformer_layers: int = 1,
        context_dim: Optional[int] = 768,
        use_linear_in_transformer: bool = False,
        use_scale_shift_norm: bool = False,
        use_checkpoint: Union[bool, str] = False,
        num_classes: Optional[int] = None,
    ) -> None:
        super().__init__()
        if isinstance(use_checkpoint, str):
            raise NotImplementedError(
                f"use_checkpoint='{use_checkpoint}': the selective policies choose XLA residuals "
                "and are not ported; pass True to recompute each block in the backward"
            )
        self.use_checkpoint = use_checkpoint
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.start_channels = start_channels
        time_embed_dim = start_channels * 4
        self.time_fc1 = Linear(start_channels, time_embed_dim)
        self.time_fc2 = Linear(time_embed_dim, time_embed_dim)
        self.num_classes = num_classes
        self.label_embed = None if num_classes is None else Embed(num_classes, time_embed_dim)

        def make_attn(ch: int) -> nn.Module:
            if num_head_channels is not None:
                heads, head_dim = ch // num_head_channels, num_head_channels
            else:
                heads = num_heads or 8
                head_dim = ch // heads
            return SpatialTransformer(
                ch, heads, head_dim, num_layers=num_transformer_layers, context_dim=context_dim,
                use_linear=use_linear_in_transformer,
            )

        def resblock(cin: int, cout: int) -> nn.Module:
            return ResidualBlockWithTimeEmbedding(
                cin, cout, time_embed_dim=time_embed_dim, use_scale_shift_norm=use_scale_shift_norm
            )

        self.conv_in = Conv(in_channels, start_channels)
        input_blocks: List[_InBlock] = []
        input_chans = [start_channels]
        ch, ds = start_channels, 1
        for level, mult in enumerate(channel_multipliers):
            for _ in range(num_res_blocks):
                out_ch = start_channels * mult
                mods: List[nn.Module] = [resblock(ch, out_ch)]
                ch = out_ch
                if ds in attention_downsample_rates:
                    mods.append(make_attn(ch))
                input_blocks.append(_InBlock(mods))
                input_chans.append(ch)
            if level != len(channel_multipliers) - 1:
                input_blocks.append(_InBlock([Downsample(ch, symmetric=True)]))
                input_chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(input_blocks)

        self.mid = _InBlock([resblock(ch, ch), make_attn(ch), resblock(ch, ch)])

        output_blocks: List[_InBlock] = []
        chans = list(input_chans)
        for level, mult in reversed(list(enumerate(channel_multipliers))):
            for i in range(num_res_blocks + 1):
                skip_ch = chans.pop()
                out_ch = start_channels * mult
                mods = [resblock(ch + skip_ch, out_ch)]
                ch = out_ch
                if ds in attention_downsample_rates:
                    mods.append(make_attn(ch))
                if level != 0 and i == num_res_blocks:
                    mods.append(UpsampleConv2d(ch, ch, factor=2.0))
                    ds //= 2
                output_blocks.append(_InBlock(mods))
        self.output_blocks = nn.ModuleList(output_blocks)

        self.norm_out = GroupNorm(ch, num_groups=32, eps=1e-5)
        self.conv_out = zero_module(Conv(ch, out_channels))

    @property
    def param_dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def time_embed(self, timesteps: torch.Tensor) -> torch.Tensor:
        # the whole net runs in the parameters' dtype: cast the f32 sinusoids
        emb = timestep_embedding(timesteps, self.start_channels).to(self.param_dtype)
        return self.time_fc2(F.silu(self.time_fc1(emb)))

    def _run_block(self, block: nn.Module, *args: Any) -> torch.Tensor:
        """With `use_checkpoint`, an input / output block keeps only its
        inputs and is computed again in the backward (the mid block is not
        checkpointed, as in the JAX module)."""
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(
        self,
        net: torch.Tensor,
        timesteps: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        *,
        deep_cache: Optional[torch.Tensor] = None,
        cache_cut: Optional[int] = None,
        return_cache: bool = False,
    ) -> Any:
        """DeepCache (Ma et al. 2023) feature reuse: with `cache_cut=c`, a
        full pass (`deep_cache` None, `return_cache=True`) also returns the
        feature entering `output_blocks[-(c+1)]`; a shallow pass (`deep_cache`
        given) runs only the first `c` input blocks and the last `c+1` output
        blocks around the cached deep feature, skipping the deep levels and
        the mid block. With `return_cache` the result is (out, cache).
        `labels` (B,) class ids add their embedding to the time embedding."""
        p_dtype = self.param_dtype
        net = net.to(p_dtype)
        if context is not None:
            context = context.to(p_dtype)
        time_embed = self.time_embed(timesteps)
        if self.label_embed is not None and labels is not None:
            time_embed = time_embed + self.label_embed(labels)
        net = self.conv_in(net)
        hs = [net]
        shallow = deep_cache is not None and cache_cut is not None
        cache_out = None
        if shallow:
            for block in self.input_blocks[:cache_cut]:
                net = self._run_block(block, net, time_embed, context)
                hs.append(net)
            net = deep_cache.to(p_dtype)
            out_blocks = list(self.output_blocks)[-(cache_cut + 1):]
            cache_out = deep_cache
        else:
            for block in self.input_blocks:
                net = self._run_block(block, net, time_embed, context)
                hs.append(net)
            net = self.mid(net, time_embed, context)
            out_blocks = list(self.output_blocks)
        capture_at = None if cache_cut is None else len(self.output_blocks) - (cache_cut + 1)
        for i, block in enumerate(out_blocks):
            if not shallow and return_cache and i == capture_at:
                cache_out = net
            net = self._run_block(block, torch.cat([net, hs.pop()], dim=-1), time_embed, context)
        out = self.conv_out(F.silu(self.norm_out(net)))
        return (out, cache_out) if return_cache else out
