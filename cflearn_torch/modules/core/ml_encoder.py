"""The categorical feature encoder of the tabular models (counterpart of
`cflearn_tpu/modules/core/ml_encoder.py`): `Encoder` encodes each
categorical column of a (.., d) float input by one-hot or by an embedding
table (`Embed`, one per column, under its column index) and passes the
numerical columns through; `MLEncodePack.merged` concatenates numerical,
one-hot and embedding parts in that order. Indices are truncated to integers
and clipped into each table, as in the JAX package."""

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Embed


@dataclasses.dataclass
class MLEncodePack:
    one_hot: Optional[torch.Tensor]
    embedding: Optional[torch.Tensor]
    numerical: Optional[torch.Tensor]

    @property
    def merged(self) -> torch.Tensor:
        return torch.cat([p for p in (self.numerical, self.one_hot, self.embedding) if p is not None], dim=-1)


def auto_embedding_dim(num_values: int) -> int:
    """4 x num_values ** 0.25, rounded, clipped to [2, 32]."""
    return max(2, min(32, int(round(4 * num_values**0.25))))


class Encoder(nn.Module):
    """`columns`: {column index: {"dim": number of values, "methods":
    "embedding" (the default) | "one_hot", "dim_embed": width}}; an
    embedding is `embedding_dim` wide where given, else
    `auto_embedding_dim(dim)`. Dropout acts on the embeddings in training
    mode."""

    def __init__(
        self, columns: Dict[str, Dict[str, Any]], *, embedding_dim: Optional[int] = None, dropout: float = 0.0
    ) -> None:
        super().__init__()
        self.columns = {str(k): dict(v) for k, v in columns.items()}
        self.one_hot_columns: List[int] = []
        self.one_hot_dims: List[int] = []
        self.embed_columns: List[int] = []
        self.embed_dims: List[int] = []
        embeds = {}
        for k in sorted(self.columns, key=int):
            setting = self.columns[k]
            dim = int(setting["dim"])
            if setting.get("methods", "embedding") == "one_hot":
                self.one_hot_columns.append(int(k))
                self.one_hot_dims.append(dim)
            else:
                e_dim = int(setting.get("dim_embed") or embedding_dim or auto_embedding_dim(dim))
                embeds[k] = Embed(dim, e_dim)
                self.embed_columns.append(int(k))
                self.embed_dims.append(e_dim)
        self.embeds = nn.ModuleDict(embeds)
        self.dropout = dropout

    @property
    def categorical_columns(self) -> List[int]:
        return sorted(self.one_hot_columns + self.embed_columns)

    @property
    def encoded_dim(self) -> int:
        return sum(self.one_hot_dims) + sum(self.embed_dims)

    @property
    def dim_increment(self) -> int:
        """The change of the feature dim that the encoding makes."""
        return self.encoded_dim - len(self.categorical_columns)

    def forward(self, x: torch.Tensor) -> MLEncodePack:
        cat_set = set(self.categorical_columns)
        num_idx = [j for j in range(x.shape[-1]) if j not in cat_set]
        numerical = x[..., num_idx] if num_idx else None
        one_hot = None
        if self.one_hot_columns:
            one_hot = torch.cat([
                F.one_hot(x[..., j].to(torch.int64).clamp(0, dim - 1), dim).to(x.dtype)
                for j, dim in zip(self.one_hot_columns, self.one_hot_dims)
            ], dim=-1)
        embedding = None
        if self.embed_columns:
            pieces = []
            for j in self.embed_columns:
                table = self.embeds[str(j)]
                pieces.append(table(x[..., j].to(torch.int64).clamp(0, table.num_embeddings - 1)))
            embedding = F.dropout(torch.cat(pieces, dim=-1), self.dropout, self.training)
        return MLEncodePack(one_hot, embedding, numerical)


class EncodingResult(NamedTuple):
    """Raw categorical encodings."""

    indices: Optional[torch.Tensor]
    one_hot: Optional[torch.Tensor]
    embedding: Optional[torch.Tensor]

    @property
    def merged(self) -> Optional[torch.Tensor]:
        if self.one_hot is None and self.embedding is None:
            return None
        if self.one_hot is None:
            return self.embedding
        if self.embedding is None:
            return self.one_hot
        return torch.cat([self.one_hot, self.embedding], dim=-1)


def ml_encode(encoder: Optional[Encoder], net: torch.Tensor) -> MLEncodePack:
    """`encoder(net)`, or `net` as the numerical part where there is no
    encoder or no categorical column."""
    if encoder is None or not getattr(encoder, "categorical_columns", None):
        return MLEncodePack(None, None, net)
    return encoder(net)
