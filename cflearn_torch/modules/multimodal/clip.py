"""The CLIP text tower (counterpart of `cflearn_tpu/modules/multimodal/clip.py`,
`CLIPAttention` .. `TeTEncoder`). The CLIP LayerNorms use epsilon 1e-5."""

from typing import List

import torch
import torch.nn as nn

from ...ops.attention import sdp_attn
from ..common import register_module
from ..core.activations import gelu, quick_gelu
from ..layers import Embed, LayerNorm, Linear


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.out_proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, *, causal: bool = False) -> torch.Tensor:
        b, l, d = x.shape
        h = self.num_heads

        def split(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, l, h, d // h).transpose(1, 2)

        out = sdp_attn(split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)), causal=causal)
        return self.out_proj(out.transpose(1, 2).reshape(b, l, d))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, *, ratio: float = 4.0, activation: str = "quick_gelu") -> None:
        super().__init__()
        hidden = int(dim * ratio)
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x)
        x = quick_gelu(x) if self.activation == "quick_gelu" else gelu(x)
        return self.fc2(x)


class CLIPBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, *, activation: str = "quick_gelu") -> None:
        super().__init__()
        self.ln_1 = LayerNorm(dim, eps=1e-5)
        self.attn = CLIPAttention(dim, num_heads)
        self.ln_2 = LayerNorm(dim, eps=1e-5)
        self.mlp = CLIPMLP(dim, activation=activation)

    def forward(self, x: torch.Tensor, *, causal: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal=causal)
        return x + self.mlp(self.ln_2(x))


@register_module("tet")
class TeTEncoder(nn.Module):
    """Causal text transformer over token ids; clip-skip picks an earlier
    hidden state."""

    def __init__(
        self,
        *,
        vocab_size: int = 49408,
        context_length: int = 77,
        latent_dim: int = 512,
        num_layers: int = 12,
        num_heads: int = 8,
        activation: str = "quick_gelu",
    ) -> None:
        super().__init__()
        self.context_length = context_length
        self.token_embedding = Embed(vocab_size, latent_dim)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, latent_dim))
        self.blocks = nn.ModuleList(
            CLIPBlock(latent_dim, num_heads, activation=activation) for _ in range(num_layers)
        )
        self.ln_final = LayerNorm(latent_dim, eps=1e-5)

    def forward(
        self,
        token_ids: torch.Tensor,
        *,
        clip_skip: int = 0,
        apply_final_ln: bool = True,
    ) -> torch.Tensor:
        x = self.token_embedding(token_ids) + self.positional_embedding[None, : token_ids.shape[1]]
        hidden_states: List[torch.Tensor] = []
        for block in self.blocks:
            x = block(x, causal=True)
            hidden_states.append(x)
        if clip_skip > 0:
            x = hidden_states[-(clip_skip + 1)]
        return self.ln_final(x) if apply_final_ln else x
