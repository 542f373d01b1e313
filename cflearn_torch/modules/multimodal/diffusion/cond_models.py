"""Condition models (counterpart of
`cflearn_tpu/modules/multimodal/diffusion/cond_models.py`). The input is
token ids; the BPE tokenizer is a later slice."""

import torch
import torch.nn as nn

from ...common import PrefixModules
from ..clip import TeTEncoder

condition_models = PrefixModules("condition_models")


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
