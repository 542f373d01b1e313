"""LoRA as a weight transform (counterpart of `cflearn_tpu/modules/core/lora.py`).

A `LoRAPack` holds low-rank deltas keyed by the port's parameter names, in
PyTorch's `nn.Linear` layout (the layout of kohya / diffusers checkpoints):
`down` (rank, in), `up` (out, rank), and W' = W + s * (up @ down). The JAX
package keeps (in, out) kernels and `down @ up`: the same delta, transposed.
`LoRAManager` records the base weights, fuses the chosen packs into them at
per-pack scales, and restores the base bit for bit.
"""

import re
import warnings
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn


class LoRAPack:
    """One set of low-rank deltas: {parameter name: (down, up)}, with its
    rank and alpha (scale alpha / rank)."""

    def __init__(
        self,
        deltas: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
        *,
        rank: int,
        alpha: Optional[float] = None,
    ) -> None:
        self.deltas = deltas
        self.rank = rank
        self.alpha = alpha if alpha is not None else float(rank)

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    @classmethod
    def create(
        cls,
        module: nn.Module,
        *,
        rank: int = 4,
        alpha: Optional[float] = None,
        target_patterns: Tuple[str, ...] = (r".*attn.*\.to_[qkv]\.weight", r".*attn.*\.to_out\.weight"),
        generator: Optional[torch.Generator] = None,
    ) -> "LoRAPack":
        """A fresh pack over the matching 2-D parameters: `down` ~ N(0,
        0.01^2) from `generator` (seed 0 when none is given), `up` zero."""
        regs = [re.compile(p) for p in target_patterns]
        deltas: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        for name, w in module.named_parameters():
            if w.ndim != 2 or not any(r.fullmatch(name) or r.match(name) for r in regs):
                continue
            if generator is None:
                generator = torch.Generator(device=w.device).manual_seed(0)
            out_dim, in_dim = w.shape
            down = (torch.randn((rank, in_dim), generator=generator, device=w.device) * 0.01).to(w.dtype)
            deltas[name] = (down, torch.zeros((out_dim, rank), dtype=w.dtype, device=w.device))
        return cls(deltas, rank=rank, alpha=alpha)


class LoRAManager:
    """Load, fuse, rescale and remove LoRA packs on a module."""

    def __init__(self) -> None:
        self._packs: Dict[str, LoRAPack] = {}
        self._backup: Optional[Dict[str, torch.Tensor]] = None
        self._active: Dict[str, float] = {}

    def load_pack_with(self, key: str, pack: LoRAPack) -> None:
        self._packs[key] = pack

    @torch.no_grad()
    def prepare(self, module: nn.Module) -> None:
        """Record the base weights of every parameter a loaded pack touches.
        A parameter first touched by a pack loaded later is recorded then:
        no pack has fused it yet, so its weight is still the base."""
        touched = set()
        for pack in self._packs.values():
            touched.update(pack.deltas)
        if self._backup is None:
            self._backup = {}
        params = dict(module.named_parameters())
        for name in touched:
            if name not in self._backup and name in params:
                self._backup[name] = params[name].detach().clone()

    @torch.no_grad()
    def apply_lora(self, module: nn.Module, *keys: str, scales: Optional[Dict[str, float]] = None) -> None:
        """Fuse the packs `keys` into the module's weights: each recorded
        parameter becomes its base plus, per pack, scale * pack.scale * (up
        @ down) (the product in f32, cast to the weight's dtype, then
        added). Parameters no chosen pack touches go back to their base."""
        self.prepare(module)
        assert self._backup is not None
        scales = scales or {}
        for key in keys:
            if key not in self._packs:
                raise ValueError(f"LoRA pack '{key}' is not loaded")
        params = dict(module.named_parameters())
        fused_count = 0
        for name, base in self._backup.items():
            w = base.clone()
            for key in keys:
                pack = self._packs[key]
                delta = pack.deltas.get(name)
                if delta is None:
                    continue
                down, up = (t.to(device=w.device, dtype=torch.float32) for t in delta)
                w = w + (scales.get(key, 1.0) * pack.scale * (up @ down)).to(w.dtype)
                fused_count += 1
            params[name].copy_(w)
        if keys and fused_count == 0:
            warnings.warn(
                "apply_lora fused no layer: the pack's parameter names do not match this module's "
                "(wrong module, or an unconverted checkpoint?)"
            )
        self._active = {k: scales.get(k, 1.0) for k in keys}

    def set_scales(self, module: nn.Module, scales: Dict[str, float]) -> None:
        self.apply_lora(module, *scales.keys(), scales=scales)

    def reset_base(self) -> None:
        """Forget the recorded base weights: the next `prepare` records the
        module's current ones (after its weights were replaced wholesale)."""
        self._backup = None

    @torch.no_grad()
    def deactivate(self, module: nn.Module) -> None:
        """Put the recorded base weights back, bit for bit."""
        if self._backup is None:
            return
        params = dict(module.named_parameters())
        for name, base in self._backup.items():
            params[name].copy_(base)
        self._active = {}

    # checkpoint IO -----------------------------------------------------------

    @staticmethod
    def torch_lora_key_to_path(key: str, *, num_res_blocks: int = 2) -> Optional[str]:
        """A kohya / diffusers LoRA module key (the part before
        `.lora_down.weight`) -> the port's UNet parameter name. CompVis
        (`lora_unet_input_blocks_4_1_...`) and diffusers
        (`lora_unet_down_blocks_1_attentions_0_...`) names of the attention
        q / k / v / out and the transformer's feed-forward are mapped;
        anything else (the text encoder's `lora_te_` keys) gives None."""
        if not key.startswith("lora_unet_"):
            return None
        name = key[len("lora_unet_"):]
        per_level = num_res_blocks + 1
        m = re.match(r"middle_block_1_(.*)$", name) or re.match(r"mid_block_attentions_0_(.*)$", name)
        if m:
            base, rest = "unet.mid.mods.1", m.group(1)
        else:
            m = re.match(r"(input|output)_blocks_(\d+)_1_(.*)$", name)
            if m:
                idx = int(m.group(2))
                if m.group(1) == "input":
                    idx -= 1  # CompVis input_blocks.0 is conv_in
                base, rest = f"unet.{m.group(1)}_blocks.{idx}.mods.1", m.group(3)
            else:
                m = re.match(r"(down|up)_blocks_(\d+)_attentions_(\d+)_(.*)$", name)
                if not m:
                    return None
                kind = "input" if m.group(1) == "down" else "output"
                idx = per_level * int(m.group(2)) + int(m.group(3))
                base, rest = f"unet.{kind}_blocks.{idx}.mods.1", m.group(4)
        m = re.match(r"transformer_blocks_(\d+)_(attn[12])_(to_q|to_k|to_v|to_out)(?:_0)?$", rest)
        if m:
            return f"{base}.blocks.{m.group(1)}.{m.group(2)}.{m.group(3)}.weight"
        m = re.match(r"transformer_blocks_(\d+)_ff_net_0_proj$", rest)
        if m:
            return f"{base}.blocks.{m.group(1)}.ff.net1.net.weight"
        m = re.match(r"transformer_blocks_(\d+)_ff_net_2$", rest)
        if m:
            return f"{base}.blocks.{m.group(1)}.ff.linear2.weight"
        return None

    @staticmethod
    def load_torch_lora(inp: Union[str, Dict[str, Any]], *, rank_key: str = "lora_down") -> LoRAPack:
        """A kohya / diffusers torch LoRA checkpoint (a `.pt` / `.ckpt` /
        `.safetensors` path, or its state dict) as a pack over the port's
        UNet parameters. Each layer's `alpha` folds alpha / rank into its
        `down`, so the pack's own scale is 1. Layers that do not map are
        skipped with a warning."""
        sd = _load_state_dict(inp) if isinstance(inp, str) else dict(inp)
        deltas: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        rank = 4
        skipped = 0
        for k, v in sd.items():
            if f".{rank_key}" not in k:
                continue
            up_k = k.replace(f".{rank_key}", ".lora_up")
            if up_k not in sd:
                continue
            module_key = k.split(f".{rank_key}")[0]
            target = LoRAManager.torch_lora_key_to_path(module_key)
            if target is None:
                skipped += 1
                continue
            down = torch.as_tensor(v).float()
            up = torch.as_tensor(sd[up_k]).float()
            rank = int(down.shape[0])
            alpha_k = module_key + ".alpha"
            if alpha_k in sd:
                down = down * (float(torch.as_tensor(sd[alpha_k])) / rank)
            deltas[target] = (down, up)
        if skipped:
            warnings.warn(f"skipped {skipped} unmappable LoRA layers (text-encoder / conv LoRAs are not mapped)")
        return LoRAPack(deltas, rank=rank, alpha=float(rank))


def _load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A `.ckpt` / `.pt` (pickle, tensors only) or `.safetensors` checkpoint."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd)
