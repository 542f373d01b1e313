"""Mixed-stack transformers (counterpart of
`cflearn_tpu/modules/core/mixed_stacks.py`).

The token- and channel-mixer registries (`token_mixers`, `channel_mixers`)
with the token mixers "attention" (the port's `Attention`, so `sdp_attn`
and the flash kernels where the shape routes there), "fourier" (FNet: the
real part of a 2-D FFT), "mlp" (MLP-Mixer), "pool" (PoolFormer) and "rwkv"
(the unstabilised exp(k) recurrence, as in the JAX package), and the
channel mixers "ff", "mix_ff", "rwkv" and "moe" (top-k routing with
capacity-bounded dense dispatch on one device, its load-balancing loss
recorded as an `AuxLossVariable`); `PositionalEncoding`, `MixingBlock` and
`MixedStackedEncoder`, the stack behind the ViT encoder and the tabular
mixed-stack nets (an optional head token, a learned positional table, a
mean pooler); `BertPooler` and `SequencePooler`.
`MixedStackedEncoder(pipeline_parallel=True)` holds its blocks as one
stacked template (`pp_block`, each parameter leading with the block axis,
the JAX layout) and runs them through `parallel.pp.pipeline_apply`, GPipe
over the ambient mesh's `pipe` axis (one block after another without
one). The MoE mixer's experts split over the mesh's `model` axis
(`parallel.tp.place_params`), and on a batch sharded over `data` x `fsdp`
its router takes its capacity and statistic over the global batch.

The SD UNet's transformer stack: the plain branch, ToMe, and the hooks of
LoRA-style q / k / v transforms and style reference. `dropout` acts in
training mode only."""

import math
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.group_norm import gn_call
from ..common import PrefixModules
from ...schema.model import AuxLossVariable
from ..layers import Conv, ConvN, GroupNorm, LayerNorm, Linear
from .activations import GEGLU, build_activation, gelu
from .attentions import Attention, CrossAttention
from .tome import compute_merge

token_mixers = PrefixModules("token_mixer")
channel_mixers = PrefixModules("channel_mixer")


def build_token_mixer(name: str, *args: Any, **kwargs: Any) -> nn.Module:
    return token_mixers.build(name, *args, **kwargs)


def build_channel_mixer(name: str, *args: Any, **kwargs: Any) -> nn.Module:
    return channel_mixers.build(name, *args, **kwargs)


register_token_mixer = token_mixers.register
register_channel_mixer = channel_mixers.register


@token_mixers.register("attention")
class AttentionTokenMixer(nn.Module):
    """Self-attention over the tokens: one `in_proj` to 3 x `latent_dim`
    (so a head is latent_dim / num_heads wide), `out_proj` back to
    `in_dim`."""

    def __init__(self, in_dim: int, num_tokens: int, latent_dim: int, *, num_heads: int = 8, dropout: float = 0.0) -> None:
        super().__init__()
        self.net = Attention(
            in_dim, num_heads, embed_dim=latent_dim, out_dim=in_dim, dropout=dropout, is_self_attention=True
        )

    def forward(self, x: torch.Tensor, **kwargs: Any) -> torch.Tensor:
        return self.net(x, **kwargs)


@token_mixers.register("fourier")
class FourierTokenMixer(nn.Module):
    """FNet: the real part of the FFT over the channels, then over the
    tokens, in the input's dtype."""

    def __init__(self, in_dim: int, num_tokens: int, latent_dim: int, **kwargs: Any) -> None:
        super().__init__()

    def forward(self, x: torch.Tensor, **kwargs: Any) -> torch.Tensor:
        return torch.fft.fft(torch.fft.fft(x, dim=-1), dim=-2).real.to(x.dtype)


@token_mixers.register("mlp")
class MLPTokenMixer(nn.Module):
    """MLP-Mixer: two linear layers across the tokens, GELU between."""

    def __init__(self, in_dim: int, num_tokens: int, latent_dim: int, *, dropout: float = 0.0) -> None:
        super().__init__()
        self.fc1 = Linear(num_tokens, num_tokens)
        self.fc2 = Linear(num_tokens, num_tokens)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, **kwargs: Any) -> torch.Tensor:
        net = F.dropout(gelu(self.fc1(x.transpose(-1, -2))), self.dropout, self.training)
        return self.fc2(net).transpose(-1, -2)


@token_mixers.register("pool")
class PoolTokenMixer(nn.Module):
    """PoolFormer: the mean over a `pool_size` window of tokens (the ends
    padded with the edge tokens), minus the token."""

    def __init__(self, in_dim: int, num_tokens: int, latent_dim: int, *, pool_size: int = 3, **kwargs: Any) -> None:
        super().__init__()
        self.pool_size = pool_size

    def forward(self, x: torch.Tensor, **kwargs: Any) -> torch.Tensor:
        k, n = self.pool_size, x.shape[1]
        pad = k // 2
        padded = torch.cat([x[:, :1].expand(-1, pad, -1), x, x[:, -1:].expand(-1, pad, -1)], dim=1)
        total = padded[:, 0:n]
        for i in range(1, k):
            total = total + padded[:, i:i + n]
        return total / float(k) - x


@token_mixers.register("rwkv")
class RWKVTokenMixer(nn.Module):
    """RWKV time mixing: a token-by-token recurrence over exp(k) with the
    learned decay exp(-exp(`time_decay`)) and bonus `time_first`, gated by
    sigmoid(r). The recurrence is the JAX package's as written, with no
    stabilisation. At init `time_decay` is -1 and `time_first` 0 (the JAX
    package draws them around those values with a spread of 0.1)."""

    def __init__(self, in_dim: int, num_tokens: int, latent_dim: int, **kwargs: Any) -> None:
        super().__init__()
        self.time_decay = nn.Parameter(torch.empty(in_dim))
        self.time_first = nn.Parameter(torch.empty(in_dim))
        self.to_k = Linear(in_dim, in_dim, bias=False)
        self.to_v = Linear(in_dim, in_dim, bias=False)
        self.to_r = Linear(in_dim, in_dim, bias=False)
        self.to_out = Linear(in_dim, in_dim, bias=False)

    def init_constants(self) -> None:
        with torch.no_grad():
            self.time_decay.fill_(-1.0)
            self.time_first.zero_()

    def forward(self, x: torch.Tensor, **kwargs: Any) -> torch.Tensor:
        k, v, r = self.to_k(x), self.to_v(x), torch.sigmoid(self.to_r(x))
        decay = torch.exp(-torch.exp(self.time_decay))
        u = self.time_first
        num = torch.zeros_like(k[:, 0])
        den = torch.zeros_like(k[:, 0])
        outs = []
        for t in range(x.shape[1]):
            kt, vt = k[:, t], v[:, t]
            ek, euk = torch.exp(kt), torch.exp(u + kt)
            outs.append((num + euk * vt) / torch.clamp_min(den + euk, 1e-8))
            num = decay * num + ek * vt
            den = decay * den + ek
        return self.to_out(r * torch.stack(outs, dim=1))


@channel_mixers.register("ff")
class FeedForward(nn.Module):
    """Two linear layers with `activation` between them (GEGLU's own
    projection for "geglu", the SD transformer's), dropout after each in
    training mode (after the second only with `add_last_dropout`)."""

    def __init__(
        self, in_dim: int, latent_dim: int, dropout: float = 0.0, *, activation: str = "gelu",
        add_last_dropout: bool = True,
    ) -> None:
        super().__init__()
        self.net1 = GEGLU(in_dim=in_dim, out_dim=latent_dim) if activation == "geglu" else None
        if self.net1 is None:
            self.linear1 = Linear(in_dim, latent_dim)
            self.act = build_activation(activation)
        self.linear2 = Linear(latent_dim, in_dim)
        self.dropout = dropout
        self.last_dropout = dropout if add_last_dropout else 0.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = self.act(self.linear1(x)) if self.net1 is None else self.net1(x)
        net = self.linear2(F.dropout(net, self.dropout, self.training))
        return F.dropout(net, self.last_dropout, self.training)


@channel_mixers.register("mix_ff")
class MixFeedForward(nn.Module):
    """fc1 -> a depthwise 3-wide conv along the tokens (SAME) -> GELU ->
    dropout -> fc2."""

    def __init__(self, in_dim: int, latent_dim: int, dropout: float = 0.0, **kwargs: Any) -> None:
        super().__init__()
        self.fc1 = Linear(in_dim, latent_dim)
        self.conv = ConvN(latent_dim, latent_dim, (3,), groups=latent_dim)
        self.fc2 = Linear(latent_dim, in_dim)
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = gelu(self.conv(self.fc1(x)))
        return self.fc2(F.dropout(net, self.dropout, self.training))


@channel_mixers.register("rwkv")
class RWKVChannelMixer(nn.Module):
    """RWKV channel mixing: sigmoid(r(x)) * v(relu(k(x))^2)."""

    def __init__(self, in_dim: int, latent_dim: int, dropout: float = 0.0, **kwargs: Any) -> None:
        super().__init__()
        self.to_k = Linear(in_dim, latent_dim, bias=False)
        self.to_r = Linear(in_dim, in_dim, bias=False)
        self.to_v = Linear(latent_dim, in_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = torch.square(F.relu(self.to_k(x)))
        return torch.sigmoid(self.to_r(x)) * self.to_v(k)


@channel_mixers.register("moe")
class MoEChannelMixer(nn.Module):
    """A mixture of `num_experts` GELU feed-forwards: each token goes to its
    `top_k` experts by the router's softmax (taken one argmax at a time, the
    lower index first among equal scores), at most `capacity` tokens an
    expert (ceil(n x `capacity_factor` x top_k / num_experts), capped at n);
    a token past an expert's capacity, in token order and the first choice's
    round before the second's, is dropped there and falls through to the
    residual. The kept gates are renormalised to sum to 1. Dispatch and
    combine are one-hot products, computed in f32. Each forward records the
    Switch load-balancing loss E x sum_e f_e P_e (f: the top-1 dispatch
    fraction, P: the mean router probability) times `aux_loss_weight` in
    `aux_loss`. The experts' tensors lead with the expert axis.

    On a mesh: with the experts split over `model` (`tp_group`, this rank's
    first expert `expert_offset`), each rank runs its experts on every
    token and the combine is summed over the group; on a batch sharded over
    `data` x `fsdp` (`parallel.mesh.batch_shard_context`) the router's
    probabilities are gathered over the batch's group, so that the capacity,
    the overflow order and the statistic are those of the global batch, as
    the JAX program computes them, and each rank combines its own tokens."""

    tp_group: Any = None
    expert_offset: int = 0

    def __init__(
        self,
        in_dim: int,
        latent_dim: int,
        dropout: float = 0.0,
        *,
        num_experts: int = 4,
        top_k: int = 2,
        capacity_factor: float = 1.5,
        aux_loss_weight: float = 0.01,
    ) -> None:
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k={top_k} must be in [1, num_experts={num_experts}]")
        self.router = Linear(in_dim, num_experts, bias=False)
        self.experts_w1 = nn.Parameter(torch.empty(num_experts, in_dim, latent_dim))
        self.experts_b1 = nn.Parameter(torch.empty(num_experts, latent_dim))
        self.experts_w2 = nn.Parameter(torch.empty(num_experts, latent_dim, in_dim))
        self.experts_b2 = nn.Parameter(torch.empty(num_experts, in_dim))
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.dropout = dropout
        self.aux_loss = AuxLossVariable(torch.zeros(()))

    def init_constants(self) -> None:
        """The experts' kernels ~ N(0, 1 / fan_in) over their input axis, the
        biases 0 (`init_parameters` drew over the whole expert slice)."""
        with torch.no_grad():
            self.experts_w1.mul_(self.experts_w1.shape[-1] ** 0.5)
            self.experts_w2.mul_(self.experts_w2.shape[-1] ** 0.5)
            self.experts_b1.zero_()
            self.experts_b2.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ...parallel import comm
        from ...parallel.mesh import batch_group

        b, t, c = x.shape
        e = self.num_experts
        xf = x.reshape(b * t, c)
        probs = torch.softmax(self.router(xf).float(), dim=-1)
        shard = batch_group()
        if shard is not None:
            probs = comm.gather_batch(probs, shard.group)
        n = probs.shape[0]
        cap = min(n, max(1, int(math.ceil(n * self.capacity_factor * self.top_k / e))))
        top1 = F.one_hot(probs.argmax(dim=-1), e).float()
        lb = e * torch.sum(top1.mean(dim=0) * probs.mean(dim=0))
        self.aux_loss = AuxLossVariable(self.aux_loss_weight * lb)

        dispatch = probs.new_zeros((n, e, cap))
        combine = probs.new_zeros((n, e, cap))
        used = torch.zeros((e,), dtype=torch.int64, device=x.device)
        remaining = probs
        gate_total = probs.new_zeros((n,))
        for _ in range(self.top_k):
            onehot = F.one_hot(remaining.argmax(dim=-1), e)
            gate = torch.sum(remaining * onehot, dim=-1)
            pos = torch.sum((torch.cumsum(onehot, dim=0) - 1 + used[None]) * onehot, dim=-1)
            keep = (pos < cap).float()
            slot = F.one_hot(pos.clamp(0, cap - 1), cap).float()
            assign = onehot.float()[:, :, None] * slot[:, None, :] * keep[:, None, None]
            dispatch = dispatch + assign
            combine = combine + gate[:, None, None] * assign
            gate_total = gate_total + gate * keep
            used = used + torch.sum(onehot * keep[:, None].to(torch.int64), dim=0)
            remaining = remaining * (1 - onehot.float())
        combine = combine / torch.clamp_min(gate_total, 1e-9)[:, None, None]
        if shard is not None:  # this rank's tokens
            rows = slice(shard.index * b * t, (shard.index + 1) * b * t)
            dispatch, combine = dispatch[rows], combine[rows]
        # this rank's experts (all of them off a mesh): their inputs' gradients sum over `model`
        e0, e1 = self.expert_offset, self.expert_offset + self.experts_w1.shape[0]
        x_in = comm.copy_to(xf.float(), self.tp_group)
        combine = comm.copy_to(combine, self.tp_group)[:, e0:e1]
        ex_in = torch.einsum("nec,nd->ecd", dispatch[:, e0:e1], x_in)
        h = gelu(torch.einsum("ecd,edh->ech", ex_in, self.experts_w1) + self.experts_b1[:, None])
        h = F.dropout(h, self.dropout, self.training)
        out_e = torch.einsum("ech,ehd->ecd", h, self.experts_w2) + self.experts_b2[:, None]
        y = comm.reduce_from(torch.einsum("nec,ecd->nd", combine, out_e), self.tp_group)
        return y.to(x.dtype).reshape(b, t, c)


class PositionalEncoding(nn.Module):
    """A learned positional table (1, num_tokens + num_head_tokens, dim),
    drawn N(0, 0.02^2), added to the first tokens; dropout after it in
    training mode. With `is_trainable=False` the table is a buffer."""

    def __init__(
        self, dim: int, num_tokens: int, *, num_head_tokens: int = 0, is_trainable: bool = True, dropout: float = 0.0
    ) -> None:
        super().__init__()
        table = torch.empty(1, num_tokens + num_head_tokens, dim)
        if is_trainable:
            self.pos_encoding = nn.Parameter(table)
        else:
            self.register_buffer("pos_encoding", table)
        self.dropout = dropout

    def init_constants(self) -> None:
        """The table ~ N(0, 0.02^2): `init_parameters`' N(0, 1 / fan_in)
        draw rescaled, or, for a buffer, one drawn from a generator seeded 0."""
        t = self.pos_encoding
        with torch.no_grad():
            if isinstance(t, nn.Parameter):
                t.mul_(0.02 * t[0].numel() ** 0.5)
            elif t.device.type != "meta":
                gen = torch.Generator(device=t.device).manual_seed(0)
                t.copy_(torch.randn(t.shape, generator=gen, device=t.device) * 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.pos_encoding[:, : x.shape[1]].to(x.dtype)
        return F.dropout(x, self.dropout, self.training)


class MixingBlock(nn.Module):
    """x + token_mixer(norm(x)), then + channel_mixer(norm(x))."""

    def __init__(
        self,
        in_dim: int,
        num_tokens: int,
        latent_dim: int,
        *,
        token_mixing_type: str,
        token_mixing_config: Optional[dict] = None,
        channel_mixing_type: str = "ff",
        channel_mixing_config: Optional[dict] = None,
        dropout: float = 0.0,
        drop_path: float = 0.0,
        norm_type: str = "layer_norm",
    ) -> None:
        super().__init__()
        from .norms import NormFactory

        self.token_norm = NormFactory(norm_type).make(in_dim)
        self.token_mixer = token_mixers.build(token_mixing_type, in_dim, num_tokens, latent_dim, **(token_mixing_config or {}))
        self.channel_norm = NormFactory(norm_type).make(in_dim)
        cm_config = dict(channel_mixing_config or {})
        cm_config.setdefault("dropout", dropout)
        self.channel_mixer = channel_mixers.build(channel_mixing_type, in_dim, latent_dim, **cm_config)

    def forward(self, x: torch.Tensor, **kwargs: Any) -> torch.Tensor:
        x = x + self.token_mixer(self.token_norm(x), **kwargs)
        return x + self.channel_mixer(self.channel_norm(x))


class MixedStackedEncoder(nn.Module):
    """`num_layers` `MixingBlock`s of width `in_dim` (mixers `latent_ratio`
    x wider), behind an optional head token (`head_token`, N(0, 0.02^2),
    prepended) and positional table, then a norm. Returns the head token's
    row, else the tokens' mean (`head_pooler="mean"`), else every token;
    `return_tokens` returns every token."""

    def __init__(
        self,
        in_dim: int,
        num_tokens: int,
        *,
        token_mixing_type: str,
        token_mixing_config: Optional[dict] = None,
        channel_mixing_type: str = "ff",
        channel_mixing_config: Optional[dict] = None,
        num_layers: int = 4,
        dropout: float = 0.0,
        norm_type: str = "layer_norm",
        latent_ratio: float = 4.0,
        use_head_token: bool = False,
        use_positional_encoding: bool = False,
        head_pooler: Optional[str] = "mean",
        pipeline_parallel: bool = False,
        pp_microbatches: Optional[int] = None,
    ) -> None:
        super().__init__()
        from .norms import NormFactory

        latent_dim = int(round(in_dim * latent_ratio))
        self.use_head_token = use_head_token
        self.head_token = nn.Parameter(torch.empty(1, 1, in_dim)) if use_head_token else None
        self.pos_encoding = (
            PositionalEncoding(in_dim, num_tokens, num_head_tokens=int(use_head_token), dropout=dropout)
            if use_positional_encoding
            else None
        )
        blocks = [
            MixingBlock(
                in_dim, num_tokens + int(use_head_token), latent_dim,
                token_mixing_type=token_mixing_type, token_mixing_config=token_mixing_config,
                channel_mixing_type=channel_mixing_type, channel_mixing_config=channel_mixing_config,
                dropout=dropout, norm_type=norm_type,
            )
            for _ in range(num_layers)
        ]
        self.pipeline_parallel = pipeline_parallel
        self.pp_microbatches = pp_microbatches
        if pipeline_parallel:
            from ...parallel.pp import stack_module_states

            # the blocks as one template whose parameters lead with the block axis (the JAX `pp_block`)
            self.pp_block, _ = stack_module_states(blocks)
            self.blocks = None
            # the pipeline's objectives (MoE balance), which the template's own variables do not keep
            self.pp_aux = AuxLossVariable(torch.zeros(()))
        else:
            self.pp_block = None
            self.blocks = nn.ModuleList(blocks)
        self.head_norm = NormFactory(norm_type).make(in_dim)
        self.head_pooler = head_pooler

    def init_constants(self) -> None:
        if self.head_token is not None:
            with torch.no_grad():
                self.head_token.mul_(0.02 * self.head_token[0].numel() ** 0.5)

    def _pipelined(self, x: torch.Tensor, **kwargs: Any) -> torch.Tensor:
        """The stacked blocks through `pipeline_apply` on the ambient mesh's
        `pipe` axis (one block after another without one); their objectives
        land in `pp_aux`, the template's own stay zero."""
        from torch.func import functional_call

        from ...parallel.mesh import get_active_pipe_mesh
        from ...parallel.pp import pipeline_apply
        from ...schema.model import aux_losses

        template = self.pp_block
        stacked = dict(template.named_parameters())
        mesh = get_active_pipe_mesh()
        if mesh is not None and not all(getattr(p, "_pipe_shard", False) for p in stacked.values()):
            raise ValueError(
                "a pipelined stack on a mesh with pipe > 1 runs its stage's blocks only: place it first "
                "(`parallel.tp.place_params`, which the Trainer and `DiffusionAPI.use_mesh` call)"
            )

        def block_fn(params: Dict[str, torch.Tensor], h: torch.Tensor) -> Any:
            h = functional_call(template, params, (h,), kwargs)
            aux = h.new_zeros((), dtype=torch.float32)
            for value in aux_losses(template):
                aux = aux + value.sum().float()
            return h, aux

        x, aux = pipeline_apply(
            block_fn, stacked, x, mesh=mesh, num_microbatches=self.pp_microbatches, with_aux=True
        )
        for sub in template.modules():
            for key, value in list(vars(sub).items()):
                if isinstance(value, AuxLossVariable):
                    setattr(sub, key, AuxLossVariable(torch.zeros((), device=x.device)))
        self.pp_aux = AuxLossVariable(aux)
        return x

    def forward(self, x: torch.Tensor, *, return_tokens: bool = False, **kwargs: Any) -> torch.Tensor:
        if self.head_token is not None:
            head = self.head_token.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
            x = torch.cat([head, x], dim=1)
        if self.pos_encoding is not None:
            x = self.pos_encoding(x)
        if self.pipeline_parallel:
            x = self._pipelined(x, **kwargs)
        else:
            for block in self.blocks:
                x = block(x, **kwargs)
        x = self.head_norm(x)
        if return_tokens:
            return x
        if self.head_token is not None:
            return x[:, 0]
        if self.head_pooler == "mean":
            return x.mean(dim=1)
        return x


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
        self.ff = FeedForward(query_dim, query_dim * 4, dropout, activation="geglu")

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


# the reference's name of the spatial transformer's inner block
SpatialTransformerBlock = BasicTransformerBlock


class ITokenMixer(nn.Module):
    """The token-mixer interface: `forward(net, **kwargs) -> net`."""


class IChannelMixer(nn.Module):
    """The channel-mixer interface: `forward(net) -> net`."""


class BertPooler(nn.Module):
    """The first token -> linear -> tanh."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.linear = Linear(dim, dim)

    def forward(self, net: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.linear(net[:, 0]))


class SequencePooler(nn.Module):
    """A softmax over the tokens of a learned projection weighs the tokens:
    one pooled row, or one for each of `aux_heads` as well."""

    def __init__(self, dim: int, aux_heads: Optional[List[str]] = None, bias: bool = True) -> None:
        super().__init__()
        self.out_dim = 1 + (0 if aux_heads is None else len(aux_heads))
        self.projection = Linear(dim, self.out_dim, bias=bias)

    def forward(self, net: torch.Tensor) -> torch.Tensor:
        weights = torch.softmax(self.projection(net), dim=1)
        net = weights.transpose(-1, -2) @ net
        return net if self.out_dim > 1 else net.squeeze(-2)


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
