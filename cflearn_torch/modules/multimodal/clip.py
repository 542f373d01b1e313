"""CLIP (counterpart of `cflearn_tpu/modules/multimodal/clip.py`): the
text tower (`TeTEncoder`, registered "tet"), the ViT vision tower
(`CLIPVisionTower`) and the joint embedding model (`CLIP`, registered
"clip"). The CLIP LayerNorms use epsilon 1e-5. `ChineseCLIP` (registered
"clip.chinese") is a ViT-L/14 vision tower with a BERT text tower
(`BertTextEncoder`).

The vision tower's self-attention runs at L = (img_size / patch)^2 + 1: at
224px that is 50 tokens for ViT-B/32 (the library path) and 257 for the
/14 towers, which `sdp_attn` routes to the flash kernel. The BERT tower's
bidirectional attention at ChineseCLIP's 52 tokens stays on the library
path."""

import math
from typing import Any, Dict, List

import torch
import torch.nn as nn

from ...constants import PREDICTIONS_KEY
from ...ops.attention import sdp_attn
from ..common import register_module
from ..core.activations import gelu, quick_gelu
from ..layers import Conv, Embed, LayerNorm, Linear


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
            # -1: under tensor parallelism the projections hold this rank's heads only
            return t.reshape(b, l, h, -1).transpose(1, 2)

        out = sdp_attn(split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)), causal=causal)
        return self.out_proj(out.transpose(1, 2).reshape(b, l, -1))


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
        return_pooled: bool = False,
    ) -> Any:
        x = self.token_embedding(token_ids) + self.positional_embedding[None, : token_ids.shape[1]]
        hidden_states: List[torch.Tensor] = []
        for block in self.blocks:
            x = block(x, causal=True)
            hidden_states.append(x)
        if clip_skip > 0:
            x = hidden_states[-(clip_skip + 1)]
        if apply_final_ln:
            x = self.ln_final(x)
        if return_pooled:
            # the EOT row: the largest id (the first of equal ones, as `jnp.argmax`)
            eot = token_ids.argmax(dim=-1)
            return x, x[torch.arange(x.shape[0], device=x.device), eot]
        return x

    def embed_with(self, embeddings: torch.Tensor, *, apply_final_ln: bool = True) -> torch.Tensor:
        """The tower on precomputed token embeddings (custom or
        textual-inversion embeddings)."""
        x = embeddings + self.positional_embedding[None, : embeddings.shape[1]]
        for block in self.blocks:
            x = block(x, causal=True)
        return self.ln_final(x) if apply_final_ln else x


class CLIPVisionTower(nn.Module):
    """ViT: a patch conv without bias (XLA "SAME" padding), the class token,
    the positional table, `ln_pre`, the blocks, `ln_post` on the class row."""

    def __init__(
        self,
        *,
        img_size: int = 224,
        patch_size: int = 32,
        latent_dim: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        activation: str = "quick_gelu",
    ) -> None:
        super().__init__()
        self.conv = Conv(3, latent_dim, (patch_size, patch_size), strides=(patch_size, patch_size), use_bias=False)
        num_patches = (img_size // patch_size) ** 2
        self.class_embedding = nn.Parameter(torch.empty(latent_dim))
        self.positional_embedding = nn.Parameter(torch.empty(num_patches + 1, latent_dim))
        self.ln_pre = LayerNorm(latent_dim, eps=1e-5)
        self.blocks = nn.ModuleList(
            CLIPBlock(latent_dim, num_heads, activation=activation) for _ in range(num_layers)
        )
        self.ln_post = LayerNorm(latent_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = self.conv(x)  # (B, H / p, W / p, D)
        b, h, w, d = net.shape
        net = net.reshape(b, h * w, d)
        cls = self.class_embedding[None, None].expand(b, 1, d)
        net = torch.cat([cls, net], dim=1) + self.positional_embedding[None]
        net = self.ln_pre(net)
        for block in self.blocks:
            net = block(net)
        return self.ln_post(net[:, 0])


class IPerceptor(nn.Module):
    """Image / text joint embedding interface."""

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def encode_text(self, token_ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


def _normalize(latent: torch.Tensor) -> torch.Tensor:
    return latent / torch.linalg.vector_norm(latent, dim=-1, keepdim=True)


@register_module("clip")
class CLIP(IPerceptor):
    """CLIP with ViT-B/32 defaults: NHWC images and token ids to embeddings
    in one space, and the logits between them at the learned scale."""

    def __init__(
        self,
        *,
        img_size: int = 224,
        latent_dim: int = 512,
        vision_latent_dim: int = 768,
        vision_patch_size: int = 32,
        vision_num_layers: int = 12,
        vision_num_heads: int = 12,
        vocab_size: int = 49408,
        context_length: int = 77,
        text_latent_dim: int = 512,
        text_num_layers: int = 12,
        text_num_heads: int = 8,
        activation: str = "quick_gelu",
        build_text_tower: bool = True,
    ) -> None:
        super().__init__()
        self.img_size = img_size
        self.context_length = context_length
        self.vit = CLIPVisionTower(
            img_size=img_size,
            patch_size=vision_patch_size,
            latent_dim=vision_latent_dim,
            num_layers=vision_num_layers,
            num_heads=vision_num_heads,
            activation=activation,
        )
        self.visual_projection = Linear(vision_latent_dim, latent_dim, bias=False)
        if build_text_tower:  # off where a subclass brings its own text tower
            self.token_encoder = TeTEncoder(
                vocab_size=vocab_size,
                context_length=context_length,
                latent_dim=text_latent_dim,
                num_layers=text_num_layers,
                num_heads=text_num_heads,
                activation=activation,
            )
            self.text_projection = Linear(text_latent_dim, latent_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.empty(()))

    def init_constants(self) -> None:
        """The logit scale's initial value, log(1 / 0.07) (`init_parameters`
        calls this after its draws)."""
        with torch.no_grad():
            self.logit_scale.fill_(math.log(1.0 / 0.07))

    def encode_image(self, image: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
        latent = self.visual_projection(self.vit(image))
        return _normalize(latent) if normalize else latent

    def encode_text(self, token_ids: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
        _, pooled = self.token_encoder(token_ids, return_pooled=True)
        latent = self.text_projection(pooled)
        return _normalize(latent) if normalize else latent

    def forward(self, image: torch.Tensor, token_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        image_embeds = self.encode_image(image)
        text_embeds = self.encode_text(token_ids)
        logits = self.logit_scale.exp() * image_embeds @ text_embeds.T
        return {
            "image_embeds": image_embeds,
            "text_embeds": text_embeds,
            "logits_per_image": logits,
            "logits_per_text": logits.T,
            PREDICTIONS_KEY: logits,
        }


class _BertBlock(nn.Module):
    """Post-norm transformer block (residual, then LayerNorm), tanh-GELU MLP."""

    def __init__(self, dim: int, num_heads: int, *, norm_eps: float) -> None:
        super().__init__()
        self.attn = CLIPAttention(dim, num_heads)
        self.ln_1 = LayerNorm(dim, eps=norm_eps)
        self.mlp = CLIPMLP(dim, activation="gelu")
        self.ln_2 = LayerNorm(dim, eps=norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ln_1(x + self.attn(x, causal=False))
        return self.ln_2(x + self.mlp(x))


class BertTextEncoder(nn.Module):
    """ChineseCLIP's BERT text tower: token, token-type (always type 0) and
    positional embeddings, an embedding LayerNorm, post-norm blocks with
    bidirectional attention and no padding mask, and the [CLS] pooler with a
    tanh head."""

    def __init__(
        self,
        *,
        vocab_size: int = 21128,
        context_length: int = 512,
        latent_dim: int = 1024,
        num_layers: int = 24,
        num_heads: int = 16,
        token_type_size: int = 2,
        norm_eps: float = 1e-12,
    ) -> None:
        super().__init__()
        self.context_length = context_length
        self.token_embedding = Embed(vocab_size, latent_dim)
        self.token_type_embedding = Embed(token_type_size, latent_dim)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, latent_dim))
        self.embedding_norm = LayerNorm(latent_dim, eps=norm_eps)
        self.blocks = nn.ModuleList(_BertBlock(latent_dim, num_heads, norm_eps=norm_eps) for _ in range(num_layers))
        self.pooler = Linear(latent_dim, latent_dim)

    def forward(self, token_ids: torch.Tensor, *, return_pooled: bool = False) -> Any:
        x = (
            self.token_embedding(token_ids)
            + self.token_type_embedding(torch.zeros_like(token_ids))
            + self.positional_embedding[None, : token_ids.shape[1]]
        )
        x = self.embedding_norm(x)
        for block in self.blocks:
            x = block(x)
        if return_pooled:
            return x, torch.tanh(self.pooler(x[:, 0]))  # the [CLS] row
        return x


@register_module("clip.chinese")
class ChineseCLIP(CLIP):
    """ChineseCLIP: a ViT-L/14 vision tower and a Chinese BERT text tower
    (`BertTextEncoder`), whose ids come from `ChineseCLIPTokenizer`."""

    def __init__(
        self,
        *,
        img_size: int = 224,
        latent_dim: int = 768,
        vocab_size: int = 21128,
        context_length: int = 512,
        text_latent_dim: int = 1024,
        text_num_layers: int = 24,
        text_num_heads: int = 16,
        token_type_size: int = 2,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            img_size=img_size,
            latent_dim=latent_dim,
            vision_latent_dim=kwargs.pop("vision_latent_dim", 1024),
            vision_patch_size=kwargs.pop("vision_patch_size", 14),
            vision_num_layers=kwargs.pop("vision_num_layers", 24),
            vision_num_heads=kwargs.pop("vision_num_heads", 16),
            build_text_tower=False,
        )
        if kwargs:
            raise TypeError(f"unrecognized ChineseCLIP kwargs: {sorted(kwargs)}")
        self.token_encoder = BertTextEncoder(
            vocab_size=vocab_size,
            context_length=context_length,
            latent_dim=text_latent_dim,
            num_layers=text_num_layers,
            num_heads=text_num_heads,
            token_type_size=token_type_size,
        )
        self.text_projection = Linear(text_latent_dim, latent_dim, bias=False)
        self.context_length = context_length
