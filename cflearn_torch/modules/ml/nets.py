"""The other tabular nets (counterpart of `cflearn_tpu/modules/ml/nets.py`):
"wnd" (a linear wide part and an FCNN deep part), "rnn" (a GRU or LSTM
stack over (B, T, d), optionally bidirectional), the mixed-stack nets
"fnet", "mixer", "transformer" and "pool_former" (each feature a token of
`latent_dim`, then `MixedStackedEncoder`), "dndf", "nbm" (a neural basis
model) and "ndt" (a neural decision tree, which `from_sklearn_tree` can
start from a fitted scikit-learn tree).

The recurrent cells are flax's, with its parameter names: a GRU cell's
`dense_i` (input -> r, z, n, with a bias) and `dense_h` (hidden -> r, z, n,
no bias), n = tanh(x_n + r * h_n); an LSTM cell's `dense_i` (no bias) and
`dense_h` (with the bias), gates i, f, g, o. The recurrence runs token by
token from a zero carry, as `nnx.RNN` scans it.
"""

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..common import register_module
from ..core.customs import DNDF
from ..core.mixed_stacks import MixedStackedEncoder
from ..layers import Linear
from .fcnn import FCNN


@register_module("wnd")
class WideAndDeep(nn.Module):
    """The first `wide_dim` features (all by default) through a linear wide
    part, plus every feature through an FCNN."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        hidden_units: Optional[List[int]] = None,
        *,
        wide_dim: Optional[int] = None,
        **fcnn_kwargs: Any,
    ) -> None:
        super().__init__()
        self.wide_dim = wide_dim or input_dim
        self.wide = Linear(self.wide_dim, output_dim)
        self.deep = FCNN(input_dim, output_dim, hidden_units, **fcnn_kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wide(x[..., : self.wide_dim]) + self.deep(x)


class GRUCell(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int) -> None:
        super().__init__()
        self.hidden_dim = hidden_dim
        self.dense_i = Linear(in_dim, 3 * hidden_dim)
        self.dense_h = Linear(hidden_dim, 3 * hidden_dim, bias=False)

    def initial_carry(self, x: torch.Tensor) -> Any:
        return x.new_zeros((x.shape[0], self.hidden_dim))

    def step(self, h: torch.Tensor, xi: torch.Tensor) -> Any:
        """One step from `xi`, the input's `dense_i` projection."""
        xr, xz, xn = xi.chunk(3, dim=-1)
        hr, hz, hn = self.dense_h(h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        return h, h


class OptimizedLSTMCell(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int) -> None:
        super().__init__()
        self.hidden_dim = hidden_dim
        self.dense_i = Linear(in_dim, 4 * hidden_dim, bias=False)
        self.dense_h = Linear(hidden_dim, 4 * hidden_dim)

    def initial_carry(self, x: torch.Tensor) -> Any:
        zeros = x.new_zeros((x.shape[0], self.hidden_dim))
        return zeros, zeros

    def step(self, carry: Any, xi: torch.Tensor) -> Any:
        c, h = carry
        i, f, g, o = (xi + self.dense_h(h)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class RecurrentLayer(nn.Module):
    """`nnx.RNN`: the cell over the tokens of (B, T, d), every step's output."""

    def __init__(self, cell: nn.Module) -> None:
        super().__init__()
        self.cell = cell

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xi = self.cell.dense_i(x)
        carry = self.cell.initial_carry(x)
        outs = []
        for t in range(x.shape[1]):
            carry, out = self.cell.step(carry, xi[:, t])
            outs.append(out)
        return torch.stack(outs, dim=1)


@register_module("rnn")
class RNN(nn.Module):
    """`num_layers` recurrent layers ("gru" or "lstm" cells) over (B, T, d)
    (a (B, d) input is one token); bidirectional stacks run a second layer
    over the reversed tokens and concatenate. The head reads the last token."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        *,
        cell_type: str = "gru",
        hidden_dim: int = 256,
        num_layers: int = 1,
        bidirectional: bool = False,
    ) -> None:
        super().__init__()
        cell = OptimizedLSTMCell if cell_type.lower() == "lstm" else GRUCell
        self.bidirectional = bidirectional
        layers, bwd_layers = [], []
        in_dim = input_dim
        for _ in range(num_layers):
            layers.append(RecurrentLayer(cell(in_dim, hidden_dim)))
            if bidirectional:
                bwd_layers.append(RecurrentLayer(cell(in_dim, hidden_dim)))
            in_dim = hidden_dim * (2 if bidirectional else 1)
        self.layers = nn.ModuleList(layers)
        self.bwd_layers = nn.ModuleList(bwd_layers) if bidirectional else None
        self.head = Linear(in_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 2:
            x = x[:, None, :]
        if not self.bidirectional:
            for layer in self.layers:
                x = layer(x)
            return self.head(x[:, -1])
        for fwd, bwd in zip(self.layers, self.bwd_layers):
            x = torch.cat([fwd(x), bwd(x.flip(1)).flip(1)], dim=-1)
        return self.head(x[:, -1])


class MixedStackedModule(nn.Module):
    """Each of the `input_dim` features a token (`to_token`: a linear map
    from 1 to `latent_dim`), then `MixedStackedEncoder` (mixers
    `latent_ratio` 4 x wider), then a linear head. A wider input is flattened
    first."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        *,
        token_mixing_type: str,
        num_layers: int = 4,
        latent_dim: int = 32,
        dropout: float = 0.0,
        norm_type: str = "layer_norm",
        use_head_token: bool = True,
        token_mixing_config: Optional[Dict[str, Any]] = None,
        channel_mixing_type: str = "ff",
        channel_mixing_config: Optional[Dict[str, Any]] = None,
        pipeline_parallel: bool = False,
        pp_microbatches: Optional[int] = None,
    ) -> None:
        super().__init__()
        self.to_token = Linear(1, latent_dim)
        self.encoder = MixedStackedEncoder(
            latent_dim, input_dim, token_mixing_type=token_mixing_type, token_mixing_config=token_mixing_config,
            channel_mixing_type=channel_mixing_type, channel_mixing_config=channel_mixing_config,
            num_layers=num_layers, dropout=dropout, norm_type=norm_type, use_head_token=use_head_token,
            pipeline_parallel=pipeline_parallel, pp_microbatches=pp_microbatches,
        )
        self.head = Linear(latent_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = self.to_token(x.reshape(x.shape[0], -1)[..., None])
        return self.head(self.encoder(tokens))


@register_module("fnet")
class FNet(MixedStackedModule):
    def __init__(self, input_dim: int, output_dim: int, **kwargs: Any) -> None:
        kwargs.setdefault("token_mixing_type", "fourier")
        super().__init__(input_dim, output_dim, **kwargs)


@register_module("mixer")
class Mixer(MixedStackedModule):
    def __init__(self, input_dim: int, output_dim: int, **kwargs: Any) -> None:
        kwargs.setdefault("token_mixing_type", "mlp")
        kwargs.setdefault("use_head_token", False)
        super().__init__(input_dim, output_dim, **kwargs)


@register_module("transformer")
class TabTransformer(MixedStackedModule):
    """Self-attention over the feature tokens and a head token: at the
    defaults 8 heads of 16 (latent 32, mixers 128 wide), so a table of 255
    or more columns runs the flash kernels."""

    def __init__(self, input_dim: int, output_dim: int, **kwargs: Any) -> None:
        kwargs.setdefault("token_mixing_type", "attention")
        super().__init__(input_dim, output_dim, **kwargs)


@register_module("pool_former")
class PoolFormer(MixedStackedModule):
    def __init__(self, input_dim: int, output_dim: int, **kwargs: Any) -> None:
        kwargs.setdefault("token_mixing_type", "pool")
        kwargs.setdefault("use_head_token", False)
        super().__init__(input_dim, output_dim, **kwargs)


@register_module("dndf")
class DNDFModule(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, **kwargs: Any) -> None:
        super().__init__()
        self.dndf = DNDF(input_dim, output_dim, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dndf(x)


@register_module("nbm")
class NBM(nn.Module):
    """A neural basis model: one FCNN (`single_basis`, no norm) maps each
    feature to `num_bases` bases, with `use_pairwise` another (`basis`) each
    pair of features; `weights` (units, bases, out) combines them per unit,
    plus `bias`. `basis` is built (two inputs with pairs, one without) even
    where no pair uses it, as in the JAX package."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        *,
        num_bases: int = 64,
        hidden_units: Optional[List[int]] = None,
        use_pairwise: bool = False,
        dropout: float = 0.0,
    ) -> None:
        super().__init__()
        hidden_units = hidden_units or [64, 64]
        self.use_pairwise = use_pairwise
        self.input_dim = input_dim
        self.pairs = [(i, j) for i in range(input_dim) for j in range(i + 1, input_dim)] if use_pairwise else []
        self.basis = FCNN(2 if use_pairwise else 1, num_bases, hidden_units, norm_type=None, dropout=dropout)
        self.single_basis = FCNN(1, num_bases, hidden_units, norm_type=None, dropout=dropout)
        self.weights = nn.Parameter(torch.empty(input_dim + len(self.pairs), num_bases, output_dim))
        self.bias = nn.Parameter(torch.empty(output_dim))

    def init_constants(self) -> None:
        """`weights` ~ N(0, 0.02^2) (`init_parameters`' draw rescaled)."""
        if self.weights.device.type != "meta":
            with torch.no_grad():
                self.weights.mul_(0.02 * self.weights[0].numel() ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d = x.shape
        feats = [self.single_basis(x.reshape(b * d, 1)).reshape(b, d, -1)]
        if self.pairs:
            idx = torch.as_tensor(self.pairs, device=x.device)
            pair_in = x[:, idx].reshape(b * len(self.pairs), 2)
            feats.append(self.basis(pair_in).reshape(b, len(self.pairs), -1))
        out = torch.einsum("bun,uno->bo", torch.cat(feats, dim=1), self.weights)
        return out + self.bias


@register_module("ndt")
class NDT(nn.Module):
    """A neural decision tree: tanh planes -> softmax routes -> leaves."""

    def __init__(
        self, input_dim: int, output_dim: int, *, num_internals: Optional[int] = None, num_leaves: Optional[int] = None
    ) -> None:
        super().__init__()
        num_internals = num_internals or max(4, 2 * input_dim)
        num_leaves = num_leaves or num_internals + 1
        self.to_planes = Linear(input_dim, num_internals)
        self.to_routes = Linear(num_internals, num_leaves)
        self.to_leaves = Linear(num_leaves, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        routes = torch.softmax(self.to_routes(torch.tanh(self.to_planes(x))), dim=-1)
        return self.to_leaves(routes)

    @classmethod
    def from_sklearn_tree(
        cls, tree: Any, input_dim: int, output_dim: int, *, scale: float = 10.0, device: Any = None, seed: int = 0
    ) -> "NDT":
        """An NDT (built by `build_module`, on `device`) whose planes are the
        fitted tree's splits (x[feature] - threshold, times `scale`), whose
        routes add each leaf's path signs over its length, with no bias, and
        whose leaves are the tree's normalised class counts (of a classifier
        with `output_dim` classes). scikit-learn is needed only to fit the
        tree."""
        from ..common import build_module

        t = tree.tree_
        internals = [i for i in range(t.node_count) if t.children_left[i] != -1]
        leaves = [i for i in range(t.node_count) if t.children_left[i] == -1]
        ndt = build_module(
            cls, config=dict(input_dim=input_dim, output_dim=output_dim, num_internals=max(1, len(internals)),
                             num_leaves=max(1, len(leaves))), device=device, seed=seed,
        )
        if not internals:
            return ndt
        internal_idx = {n: i for i, n in enumerate(internals)}
        leaf_idx = {n: i for i, n in enumerate(leaves)}
        w = np.zeros((input_dim, len(internals)), dtype=np.float32)
        b = np.zeros((len(internals),), dtype=np.float32)
        for n, i in internal_idx.items():
            w[t.feature[n], i] = scale
            b[i] = -scale * t.threshold[n]
        route_w = np.zeros((len(internals), len(leaves)), dtype=np.float32)

        def walk(node: int, path: List[Any]) -> None:
            if t.children_left[node] == -1:
                for i, sgn in path:
                    route_w[i, leaf_idx[node]] = sgn * scale / max(len(path), 1)
                return
            i = internal_idx[node]
            walk(t.children_left[node], path + [(i, -1.0)])
            walk(t.children_right[node], path + [(i, 1.0)])

        walk(0, [])
        leaf_w = np.zeros((len(leaves), output_dim), dtype=np.float32)
        for n, li in leaf_idx.items():
            value = t.value[n].ravel()
            if len(value) == output_dim:
                leaf_w[li] = value / max(value.sum(), 1e-8)
        with torch.no_grad():
            ndt.to_planes.weight.copy_(torch.from_numpy(w.T.copy()))
            ndt.to_planes.bias.copy_(torch.from_numpy(b))
            ndt.to_routes.weight.copy_(torch.from_numpy(route_w.T.copy()))
            ndt.to_routes.bias.zero_()
            ndt.to_leaves.weight.copy_(torch.from_numpy(leaf_w.T.copy()))
        return ndt


Transformer = TabTransformer
