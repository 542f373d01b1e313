"""`UNetDiffuser` — the SD UNet and the LDM UNets — and `ControlNet`
(counterpart of `cflearn_tpu/modules/multimodal/diffusion/unet.py`: the full
pass with the ControlNet residuals added, DeepCache's shallow pass, the
transformer hooks of style reference, and per-block checkpointing under a
`jax.checkpoint_policies` name). Channel-last NHWC."""

import math
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...common import register_module, zero_module
from ...core.attentions import MultiHeadSpatialAttention
from ...core.convs import Downsample, ResidualBlockWithTimeEmbedding, UpsampleConv2d
from ...core.mixed_stacks import BasicTransformerBlock, SpatialTransformer, SpatialTransformerHooks
from ...layers import Conv, Embed, GroupNorm, Linear
from ....toolkit.misc import checkpoint_context_fn, resolve_checkpoint_policy


def walk_transformer_blocks(unet: "UNetDiffuser") -> List[BasicTransformerBlock]:
    """The `BasicTransformerBlock`s in the order a full forward calls them:
    the input blocks', the mid block's, the output blocks'."""
    blocks: List[BasicTransformerBlock] = []
    for stage in list(unet.input_blocks) + [unet.mid] + list(getattr(unet, "output_blocks", [])):
        for mod in stage.mods:
            if isinstance(mod, SpatialTransformer):
                blocks.extend(mod.blocks)
    return blocks


def style_reference_write_gates(unet: "UNetDiffuser", reference_weight: float) -> List[bool]:
    """Per-block bank gates of style reference, in call order: the blocks
    sorted by width, widest first (a stable sort, so equal widths keep their
    call order), and the first `reference_weight` fraction of them on."""
    blocks = walk_transformer_blocks(unet)
    order = np.argsort(np.asarray([-b.norm1.weight.shape[0] for b in blocks]), kind="stable")
    n = max(1, len(blocks))
    gates = [False] * len(blocks)
    for rank, call_idx in enumerate(order):
        gates[call_idx] = reference_weight > rank / n
    return gates


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
        self,
        net: torch.Tensor,
        time_embed: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        *,
        hooks: Optional[SpatialTransformerHooks] = None,
    ) -> torch.Tensor:
        for mod in self.mods:
            if isinstance(mod, ResidualBlockWithTimeEmbedding):
                net = mod(net, time_embed)
            elif isinstance(mod, SpatialTransformer):
                net = mod(net, context, hooks=hooks)
            else:
                net = mod(net)
        return net


@register_module("diffusion/unet")
class UNetDiffuser(nn.Module):
    """Diffusion UNet. SD-1.5: in/out 4 channels, start 320, multipliers
    (1, 2, 4, 4), attention at downsample rates (1, 2, 4), 8 heads, context
    768. `use_spatial_transformer=False` puts a `MultiHeadSpatialAttention`
    (no context) where SD has a transformer: the LDM UNets.
    `resample_with_resblock` resamples by time-embedded resblocks with
    `down` / `up` (the LDM-inpainting UNet), else a stride-2 conv
    (`resample_with_conv`, or a 2x2 average pool without it) down and a
    nearest 2x resize and conv up. `dropout` reaches every resblock (and the
    transformers' blocks), in training mode. `num_classes`: a class-label
    embedding added to the time embedding (the `adm` condition).
    `with_output_blocks=False` builds the encoder half only (`conv_in`, the
    time embedding, the input blocks and the mid block): what a `ControlNet`
    runs of its copy of the UNet.

    `use_checkpoint`: True recomputes each input and output block in the
    backward (the mid block is not checkpointed, as in the JAX module); a
    `jax.checkpoint_policies` name keeps what that policy keeps
    (`toolkit.misc.resolve_checkpoint_policy`) and recomputes the rest. An
    unknown name raises `ValueError` when it is set."""

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
        use_spatial_transformer: bool = True,
        num_transformer_layers: int = 1,
        context_dim: Optional[int] = 768,
        use_linear_in_transformer: bool = False,
        use_scale_shift_norm: bool = False,
        num_classes: Optional[int] = None,
        dropout: float = 0.0,
        use_checkpoint: Union[bool, str] = False,
        resample_with_conv: bool = True,
        resample_with_resblock: bool = False,
        with_output_blocks: bool = True,
    ) -> None:
        super().__init__()
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
            if not use_spatial_transformer:
                return MultiHeadSpatialAttention(ch, num_heads=heads)
            return SpatialTransformer(
                ch, heads, head_dim, num_layers=num_transformer_layers, context_dim=context_dim,
                use_linear=use_linear_in_transformer, dropout=dropout,
            )

        def resblock(cin: int, cout: int, **kw: Any) -> nn.Module:
            return ResidualBlockWithTimeEmbedding(
                cin, cout, time_embed_dim=time_embed_dim, dropout=dropout, use_scale_shift_norm=use_scale_shift_norm,
                **kw,
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
                if resample_with_resblock:
                    down: nn.Module = resblock(ch, ch, down=True)
                else:
                    down = Downsample(ch, use_conv=resample_with_conv, symmetric=True)
                input_blocks.append(_InBlock([down]))
                input_chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(input_blocks)
        self.input_chans = input_chans

        self.mid = _InBlock([resblock(ch, ch), make_attn(ch), resblock(ch, ch)])
        if not with_output_blocks:
            return

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
                    mods.append(resblock(ch, ch, up=True) if resample_with_resblock else UpsampleConv2d(ch, ch, factor=2.0))
                    ds //= 2
                output_blocks.append(_InBlock(mods))
        self.output_blocks = nn.ModuleList(output_blocks)

        self.norm_out = GroupNorm(ch, num_groups=32, eps=1e-5)
        self.conv_out = zero_module(Conv(ch, out_channels))

    @property
    def use_checkpoint(self) -> Union[bool, str]:
        return self._use_checkpoint

    @use_checkpoint.setter
    def use_checkpoint(self, value: Union[bool, str]) -> None:
        # a policy name is checked now, not at the first step with a gradient
        if isinstance(value, str):
            resolve_checkpoint_policy(value)
        self._use_checkpoint = value

    @property
    def param_dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def time_embed(self, timesteps: torch.Tensor) -> torch.Tensor:
        # the whole net runs in the parameters' dtype: cast the f32 sinusoids
        emb = timestep_embedding(timesteps, self.start_channels).to(self.param_dtype)
        return self.time_fc2(F.silu(self.time_fc1(emb)))

    def _run_block(self, block: nn.Module, *args: Any, **kwargs: Any) -> torch.Tensor:
        """With `use_checkpoint`, an input / output block keeps only its
        inputs (and, under a policy name, the outputs the policy keeps) and
        is computed again in the backward."""
        if self.use_checkpoint and torch.is_grad_enabled():
            if isinstance(self.use_checkpoint, str):
                kwargs["context_fn"] = checkpoint_context_fn(self.use_checkpoint)
            return checkpoint(block, *args, use_reentrant=False, **kwargs)
        return block(*args, **kwargs)

    def forward(
        self,
        net: torch.Tensor,
        timesteps: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        *,
        control: Optional[List[torch.Tensor]] = None,
        hooks: Optional[SpatialTransformerHooks] = None,
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
        `labels` (B,) class ids add their embedding to the time embedding.
        `control`: ControlNet residuals, one per skip (`conv_in` and each
        input block) and one for the mid block (last): the mid block's
        output and each skip get theirs added (a shallow pass takes the
        first cut + 1). `hooks` reach every transformer block (style
        reference's WRITE and READ passes)."""
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
                net = self._run_block(block, net, time_embed, context, hooks=hooks)
                hs.append(net)
            net = deep_cache.to(p_dtype)
            out_blocks = list(self.output_blocks)[-(cache_cut + 1):]
            cache_out = deep_cache
        else:
            for block in self.input_blocks:
                net = self._run_block(block, net, time_embed, context, hooks=hooks)
                hs.append(net)
            net = self.mid(net, time_embed, context, hooks=hooks)
            if control is not None:
                net = net + control[-1]
            out_blocks = list(self.output_blocks)
        capture_at = None if cache_cut is None else len(self.output_blocks) - (cache_cut + 1)
        for i, block in enumerate(out_blocks):
            if not shallow and return_cache and i == capture_at:
                cache_out = net
            skip = hs.pop()
            if control is not None:
                skip = skip + control[len(hs)]
            net = self._run_block(block, torch.cat([net, skip], dim=-1), time_embed, context, hooks=hooks)
        out = self.conv_out(F.silu(self.norm_out(net)))
        return (out, cache_out) if return_cache else out


@register_module("diffusion/control_net")
class ControlNet(nn.Module):
    """The zero-conv control branch: a hint encoder (eight times down, by
    stride-2 convs with padding 1 on both sides), `hint_out` (zero), a copy
    of the UNet's encoder half fed the latents plus the encoded hint, and a
    zero 1x1 conv per level (`zero_convs`, `mid_zero`). It returns the
    residuals that `UNetDiffuser.forward(control=...)` adds. The convs are
    plain `F.conv2d`, as `nnx.Conv` is in the JAX module (no kernel
    route). Like the UNet, it runs in its parameters' dtype (the JAX module
    promotes an f32 hint against bf16 parameters to f32).

    The JAX module builds a whole `UNetDiffuser` and runs its encoder half;
    this one builds only that half (`with_output_blocks=False`), and
    `bridge.control_net_params` leaves the JAX module's unused leaves out."""

    def __init__(
        self,
        *,
        hint_channels: int = 3,
        in_channels: int = 4,
        start_channels: int = 320,
        num_res_blocks: int = 2,
        attention_downsample_rates: Tuple[int, ...] = (1, 2, 4),
        channel_multipliers: Tuple[int, ...] = (1, 2, 4, 4),
        num_heads: int = 8,
        context_dim: Optional[int] = 768,
        use_linear_in_transformer: bool = False,
        num_transformer_layers: int = 1,
        dropout: float = 0.0,
    ) -> None:
        super().__init__()
        chs = [16, 16, 32, 32, 96, 96, 256]
        strides = [1, 1, 2, 1, 2, 1, 2]
        mods: List[nn.Module] = []
        prev = hint_channels
        for c, s in zip(chs, strides):
            mods.append(Conv(prev, c, strides=(s, s), padding=((1, 1), (1, 1))))
            prev = c
        self.hint_blocks = nn.ModuleList(mods)
        self.hint_out = zero_module(Conv(prev, start_channels))
        self.unet = UNetDiffuser(
            in_channels=in_channels, out_channels=in_channels, start_channels=start_channels,
            num_res_blocks=num_res_blocks, attention_downsample_rates=attention_downsample_rates,
            channel_multipliers=channel_multipliers, num_heads=num_heads, context_dim=context_dim,
            use_linear_in_transformer=use_linear_in_transformer, num_transformer_layers=num_transformer_layers,
            dropout=dropout, with_output_blocks=False,
        )
        self.zero_convs = nn.ModuleList([zero_module(Conv(c, c, (1, 1))) for c in self.unet.input_chans])
        mid_ch = self.unet.input_chans[-1]
        self.mid_zero = zero_module(Conv(mid_ch, mid_ch, (1, 1)))

    def forward(
        self,
        net: torch.Tensor,
        hint: torch.Tensor,
        timesteps: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        *,
        max_levels: Optional[int] = None,
    ) -> List[torch.Tensor]:
        """net: (B, h, w, in_channels) latents; hint: (B, 8h, 8w,
        hint_channels). `max_levels` cuts the residual list, and the compute
        behind the deeper ones: a DeepCache shallow pass takes only the
        first cut + 1."""
        p_dtype = self.unet.param_dtype
        time_embed = self.unet.time_embed(timesteps)
        if context is not None:
            context = context.to(p_dtype)
        guided = hint.to(p_dtype)
        for conv in self.hint_blocks:
            guided = F.silu(conv(guided))
        guided = self.hint_out(guided)
        h = self.unet.conv_in(net.to(p_dtype)) + guided
        outs = [self.zero_convs[0](h)]
        if max_levels is not None and len(outs) >= max_levels:
            return outs
        for i, block in enumerate(self.unet.input_blocks):
            h = block(h, time_embed, context)
            outs.append(self.zero_convs[i + 1](h))
            if max_levels is not None and len(outs) >= max_levels:
                return outs
        h = self.unet.mid(h, time_embed, context)
        outs.append(self.mid_zero(h))
        return outs
