"""The SD UNet's transformer stack (counterpart of
`cflearn_tpu/modules/core/mixed_stacks.py`: the plain branch, ToMe, and the
hooks of LoRA-style q / k / v transforms and style reference). `dropout`
acts in training mode only."""

from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.group_norm import gn_call
from ..layers import Conv, GroupNorm, LayerNorm, Linear
from .activations import GEGLU
from .attentions import CrossAttention
from .tome import compute_merge


class FeedForward(nn.Module):
    """GEGLU feed-forward (the `activation="geglu"` branch), dropout after
    each layer."""

    def __init__(self, in_dim: int, latent_dim: int, dropout: float = 0.0) -> None:
        super().__init__()
        self.net1 = GEGLU(in_dim=in_dim, out_dim=latent_dim)
        self.linear2 = Linear(latent_dim, in_dim)
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = self.linear2(F.dropout(self.net1(x), self.dropout, self.training))
        return F.dropout(net, self.dropout, self.training)


class StyleReferenceStates:
    """Style reference ("reference-only") settings: `reference_weight` is the
    fraction of transformer blocks, widest first, that bank and read the
    reference's activations; `style_fidelity` mixes plain self-attention
    back in on the CFG uncond rows."""

    def __init__(self, *, style_fidelity: float = 0.5, reference_weight: float = 1.0) -> None:
        self.style_fidelity = float(style_fidelity)
        self.reference_weight = float(reference_weight)


class SpatialTransformerHooks:
    """What the transformer blocks consult on a UNet call: `qkv_fn(module,
    q, k, v)` transforms each attention's q, k and v; style reference runs
    two UNet passes a denoise step, a WRITE pass over the noised reference
    latent that banks each gated block's normed input, then the READ pass
    whose self-attention attends over [self, bank]. `ref_latent` is the
    reference's latent, `uncond_mask` (2b, 1, 1) marks a CFG batch's uncond
    rows, `generator` feeds the reference's noise (drawn through `_randn`)."""

    def __init__(
        self,
        qkv_fn: Optional[Callable] = None,
        *,
        style: Optional[StyleReferenceStates] = None,
        write_gates: Optional[List[bool]] = None,
        uncond_mask: Optional[torch.Tensor] = None,
        ref_latent: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        self.qkv_fn = qkv_fn
        self.style = style
        self.write_gates = write_gates or []
        self.uncond_mask = uncond_mask
        self.ref_latent = ref_latent
        self.generator = generator
        self.mode: Optional[str] = None
        self.bank: Dict[int, torch.Tensor] = {}
        self._idx = 0

    def process_qkv(self, module: Any, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Any:
        if self.qkv_fn is None:
            return q, k, v
        return self.qkv_fn(module, q, k, v)

    def begin(self, mode: Optional[str]) -> None:
        """Start a WRITE ("write") or READ ("read") pass, or end them (None).
        Blocks are numbered in call order, the same in both passes of a step;
        a WRITE pass empties the bank."""
        self.mode = mode
        self._idx = 0
        if mode == "write":
            self.bank = {}

    def next_index(self) -> int:
        i = self._idx
        self._idx += 1
        return i

    def gate_of(self, idx: int) -> bool:
        if not self.write_gates:
            return True
        return bool(self.write_gates[idx]) if idx < len(self.write_gates) else False

    def _randn(self, shape: Any, like: torch.Tensor) -> torch.Tensor:
        """N(0, 1) of `shape` in `like`'s dtype and device: the reference's
        noise at each denoise step."""
        return torch.randn(tuple(shape), generator=self.generator, device=like.device, dtype=like.dtype)


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> GEGLU FF, all pre-norm residual. The
    LayerNorms keep flax's default epsilon 1e-6."""

    def __init__(
        self, query_dim: int, num_heads: int, head_dim: int, *, context_dim: Optional[int] = None, dropout: float = 0.0
    ) -> None:
        super().__init__()
        self.norm1 = LayerNorm(query_dim)
        self.attn1 = CrossAttention(query_dim=query_dim, heads=num_heads, dim_head=head_dim, dropout=dropout)
        self.norm2 = LayerNorm(query_dim)
        self.attn2 = CrossAttention(
            query_dim=query_dim, context_dim=context_dim, heads=num_heads, dim_head=head_dim, dropout=dropout
        )
        self.norm3 = LayerNorm(query_dim)
        self.ff = FeedForward(query_dim, query_dim * 4, dropout)

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        *,
        hooks: Optional[SpatialTransformerHooks] = None,
        tome_info: Optional[Any] = None,
    ) -> torch.Tensor:
        """`tome_info` = (h, w, ratio, merge_mlp): ToMe merges the tokens for
        the self-attention (and, with merge_mlp, for the FF, with the same
        matching), the block's input `x` being the similarity metric.

        `hooks` in a style-reference pass: WRITE banks norm1(x) (on a gated
        block) and attends as usual; READ attends over [norm1(x), bank], and
        where `style_fidelity` > 1e-5 and the uncond mask spans the batch (a
        CFG call) the uncond rows take fidelity x plain + (1 - fidelity) x
        reference. ToMe comes first, as in the JAX module: with ToMe on, a
        block skips style reference."""
        style_mode = None if hooks is None else hooks.mode
        if tome_info is not None:
            h, w, ratio, merge_mlp = tome_info
            merge, unmerge, _ = compute_merge(x, h, w, ratio=ratio)
            x = x + unmerge(self.attn1(merge(self.norm1(x)), hooks=hooks))
            x = x + self.attn2(self.norm2(x), context=context, hooks=hooks)
            if merge_mlp:
                return x + unmerge(self.ff(merge(self.norm3(x))))
            return x + self.ff(self.norm3(x))
        if style_mode in ("write", "read"):
            idx = hooks.next_index()
            xn = self.norm1(x)
            bank = hooks.bank.get(idx) if style_mode == "read" else None
            if style_mode == "write" and hooks.gate_of(idx):
                hooks.bank[idx] = xn
            if bank is None:
                x = x + self.attn1(xn, hooks=hooks)
            else:
                refd = self.attn1(xn, context=torch.cat([xn, bank.to(xn.dtype)], dim=1), hooks=hooks)
                fidelity = hooks.style.style_fidelity
                # a guidance-interval segment outside the band runs at batch b: no uncond rows to mix
                mask = hooks.uncond_mask
                if fidelity > 1e-5 and mask is not None and mask.shape[0] == xn.shape[0]:
                    mixed = fidelity * self.attn1(xn, hooks=hooks) + (1.0 - fidelity) * refd
                    refd = torch.where(mask, mixed, refd)
                x = x + refd
        else:
            x = x + self.attn1(self.norm1(x), hooks=hooks)
        x = x + self.attn2(self.norm2(x), context=context, hooks=hooks)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm -> proj-in -> transformer blocks -> proj-out + skip."""

    def __init__(
        self,
        in_channels: int,
        num_heads: int,
        head_dim: int,
        *,
        num_layers: int = 1,
        context_dim: Optional[int] = None,
        dropout: float = 0.0,
        use_linear: bool = False,
    ) -> None:
        super().__init__()
        inner_dim = num_heads * head_dim
        self.norm = GroupNorm(in_channels, num_groups=32, eps=1e-6)
        self.use_linear = use_linear
        if use_linear:
            self.proj_in = Linear(in_channels, inner_dim)
            self.proj_out = Linear(inner_dim, in_channels)
        else:
            self.proj_in = Conv(in_channels, inner_dim, (1, 1))
            self.proj_out = Conv(inner_dim, in_channels, (1, 1))
        self.blocks = nn.ModuleList(
            BasicTransformerBlock(inner_dim, num_heads, head_dim, context_dim=context_dim, dropout=dropout)
            for _ in range(num_layers)
        )
        # ToMe ratio (0 = off), set through `set_tome_ratio`
        self.tome_ratio = 0.0
        self.tome_merge_mlp = False

    def set_tome_ratio(self, ratio: float, *, merge_mlp: bool = False) -> None:
        self.tome_ratio = float(ratio)
        self.tome_merge_mlp = bool(merge_mlp)

    def forward(
        self, x: torch.Tensor, context: Optional[torch.Tensor] = None, *, hooks: Optional[SpatialTransformerHooks] = None
    ) -> torch.Tensor:
        b, h, w, c = x.shape
        net = gn_call(self.norm, x)
        if self.use_linear:
            net = self.proj_in(net.reshape(b, h * w, c))
        else:
            net = self.proj_in(net).reshape(b, h * w, -1)
        tome_info = (h, w, self.tome_ratio, self.tome_merge_mlp) if self.tome_ratio > 0 else None
        for block in self.blocks:
            net = block(net, context=context, hooks=hooks, tome_info=tome_info)
        if self.use_linear:
            net = self.proj_out(net).reshape(b, h, w, c)
        else:
            net = self.proj_out(net.reshape(b, h, w, -1))
        return x + net


def walk_spatial_transformer_blocks(m: nn.Module, fn: Callable[[BasicTransformerBlock], Any]) -> None:
    """Apply `fn` to every `BasicTransformerBlock` under `m`, once each."""
    for module in m.modules():
        if isinstance(module, BasicTransformerBlock):
            fn(module)


def walk_spatial_transformer_hooks(m: nn.Module, fn: Optional[Callable] = None) -> List[Any]:
    """The `hooks` attributes of the transformer blocks under `m` (None ones
    left out), each visited with `fn(hooks, all_hooks)` when given. As in the
    JAX package, the blocks take their hooks as a call argument and carry no
    such attribute unless a caller sets one."""
    all_hooks: List[Any] = []
    walk_spatial_transformer_blocks(m, lambda block: all_hooks.append(getattr(block, "hooks", None)))
    all_hooks = [h for h in all_hooks if h is not None]
    if fn is not None:
        for hooks in all_hooks:
            fn(hooks, all_hooks)
    return all_hooks
