"""Condition models (counterpart of
`cflearn_tpu/modules/multimodal/diffusion/cond_models.py`): the CLIP text
condition (token ids in) in `condition_models`, and `Rescaler` (the
semantic LDM's spatial condition) in `specialized_condition_models`."""

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ...common import PrefixModules
from ...layers import Conv, resize
from ..clip import TeTEncoder

condition_models = PrefixModules("condition_models")
specialized_condition_models = PrefixModules("specialized_condition_models")


@condition_models.register("clip_text")
class CLIPTextConditionModel(nn.Module):
    """Token ids -> per-token hidden states (B, 77, D), final LayerNorm on."""

    def __init__(
        self,
        *,
        latent_dim: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        context_length: int = 77,
        vocab_size: int = 49408,
        clip_skip: int = 0,
    ) -> None:
        super().__init__()
        self.clip_skip = clip_skip
        self.encoder = TeTEncoder(
            vocab_size=vocab_size,
            context_length=context_length,
            latent_dim=latent_dim,
            num_layers=num_layers,
            num_heads=num_heads,
            activation="quick_gelu",
        )

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        if token_ids.is_floating_point():
            return token_ids  # an already-encoded context passes through
        return self.encoder(token_ids, clip_skip=self.clip_skip, apply_final_ln=True)

    def encode_with_custom_embeddings(
        self, token_ids: torch.Tensor, custom_embeddings: Optional[Dict[int, Any]] = None
    ) -> torch.Tensor:
        """Textual inversion: the rows of `token_ids` equal to a key of
        `custom_embeddings` take that embedding (a (D,) vector) in place of
        the table's, then the tower runs on the embeddings with the final
        LayerNorm (`clip_skip` does not apply)."""
        embeddings = self.encoder.token_embedding(token_ids)
        for token_id, embed in (custom_embeddings or {}).items():
            embed = torch.as_tensor(embed, dtype=embeddings.dtype, device=embeddings.device)
            embeddings = torch.where((token_ids == token_id)[..., None], embed, embeddings)
        return self.encoder.embed_with(embeddings)


@specialized_condition_models.register("rescaler")
class Rescaler(nn.Module):
    """Shrink a spatial NHWC condition by `multiplier` per stage with
    `jax.image.resize`'s method (antialiased; the sizes by Python's
    `round`, half to even, at least 1), then map its channels by a 1x1 conv
    (`out_channels`; no bias unless `bias`). The semantic LDM runs two
    stages over 182 one-hot channels to 3."""

    def __init__(
        self,
        *,
        in_channels: int = 3,
        out_channels: Optional[int] = None,
        num_stages: int = 1,
        multiplier: float = 0.5,
        method: str = "bilinear",
        bias: bool = False,
    ) -> None:
        super().__init__()
        supported = {"nearest", "linear", "bilinear", "trilinear", "bicubic"}
        if method not in supported:
            raise ValueError(f"`method` should be one of {supported}")
        self.in_channels = in_channels
        self.num_stages = num_stages
        self.multiplier = multiplier
        self.method = method
        self.channel_mapper = None if out_channels is None else Conv(in_channels, out_channels, (1, 1), use_bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.num_stages):
            h, w = x.shape[1:3]
            size = (max(1, int(round(h * self.multiplier))), max(1, int(round(w * self.multiplier))))
            x = resize(x, size, self.method)
        if self.channel_mapper is not None:
            x = self.channel_mapper(x)
        return x


SpatialRescaler = Rescaler
