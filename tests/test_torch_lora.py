"""The port's LoRA (`cflearn_torch/modules/core/lora.py`) against the JAX
package's `LoRAManager`, on a tiny DDPM whose UNet has two res blocks a
level (so that both checkpoint naming styles index as in SD) and attention
at both levels: the key mapping of kohya / diffusers checkpoints, a LoRA
file the test writes itself (CompVis and diffusers keys, per-layer alpha,
`.pt` and `.safetensors`)
fused by both packages, two packs at per-pack scales (`set_scales`), a
`LoRAPack` built from numpy arrays carried across by the bridge,
`deactivate` restoring the base bit for bit, and the `DiffusionAPI` LoRA
methods with `load_context`.

The JAX fuse runs in numpy on the host, the port's in torch: the rank-4
products sum in different orders. Tolerance: 1e-6 of each weight's
max|JAX| (f32 rounding of a rank-4 product and one add)."""

import numpy as np
import pytest
import torch
from flax import nnx

from _torch_bridge_common import bridged, flat_params, rel_err
import cflearn_torch
from cflearn_torch.bridge import lora_deltas_from_nnx, lora_path_to_port, tree_from_nnx
from cflearn_torch.modules.core.lora import LoRAManager as TManager, LoRAPack as TPack
from cflearn_torch.modules.multimodal.diffusion.ldm import SDLoRAMode, convert_lora
from cflearn_tpu.modules.core.lora import LoRAManager as JManager, LoRAPack as JPack
from cflearn_tpu.modules.multimodal.diffusion.ddpm import DDPM
from cflearn_tpu.toolkit.tree import tree_to_npd

TOL = 1e-6
UNET = dict(
    start_channels=32, num_res_blocks=2, channel_multipliers=(1, 2), attention_downsample_rates=(1, 2), num_heads=4,
    context_dim=32,
)
LAYERS = [f"transformer_blocks_0_{a}_{p}" for a in ("attn1", "attn2") for p in ("to_q", "to_k", "to_v", "to_out_0")]
LAYERS += ["transformer_blocks_0_ff_net_0_proj", "transformer_blocks_0_ff_net_2"]
# every transformer of the UNet, in both naming styles: (CompVis, diffusers)
LOCATIONS = [
    ("input_blocks_1_1", "down_blocks_0_attentions_0"), ("input_blocks_2_1", "down_blocks_0_attentions_1"),
    ("input_blocks_4_1", "down_blocks_1_attentions_0"), ("input_blocks_5_1", "down_blocks_1_attentions_1"),
    ("middle_block_1", "mid_block_attentions_0"),
] + [(f"output_blocks_{i}_1", f"up_blocks_{i // 3}_attentions_{i % 3}") for i in range(6)]


@pytest.fixture(scope="module")
def models():
    jm = DDPM(img_size=8, num_timesteps=50, unet_config=UNET, rngs=nnx.Rngs(0))
    tm = bridged(jm, cflearn_torch.build(cflearn_torch.DDPM, device="cpu", img_size=8, num_timesteps=50, unet_config=UNET))
    return jm, tm


def _jax_npd(jm):
    return tree_to_npd(nnx.state(jm, nnx.Param))


def test_key_mapping(models):
    """Every key the JAX mapper sends to a JAX parameter maps, through the
    bridge's name for that parameter, to the port mapper's name, with the
    transposed shape; unmapped keys are unmapped on both sides."""
    jm, tm = models
    npd, params = _jax_npd(jm), dict(tm.named_parameters())
    keys = [f"lora_unet_{loc}_{layer}" for pair in LOCATIONS for loc in pair for layer in LAYERS]
    targets = set()
    for key in keys:
        jpath, tname = JManager.torch_lora_key_to_path(key), TManager.torch_lora_key_to_path(key)
        assert jpath in npd, key
        assert tname == lora_path_to_port(jpath) and tname in params, key
        assert tuple(params[tname].shape) == npd[jpath].shape[::-1], key
        targets.add(tname)
    # the two styles name the same 11 transformers: 10 layers each
    assert len(targets) == 10 * 11
    for key in ("lora_te_text_model_encoder_layers_0_self_attn_q_proj", "lora_unet_input_blocks_1_0_in_layers_2",
                "lora_unet_down_blocks_0_resnets_0_conv1", "lora_unet_middle_block_0_emb_layers_1"):
        assert JManager.torch_lora_key_to_path(key) is None and TManager.torch_lora_key_to_path(key) is None


def _lora_file(path, models, seed, layers):
    """A kohya-style checkpoint: `<module>.lora_down.weight` (rank, in),
    `<module>.lora_up.weight` (out, rank), `<module>.alpha`; half the
    modules CompVis-named, half diffusers-named, plus a text-encoder layer;
    a `.pt` pickle or, by its suffix, a `.safetensors` file."""
    jm, _ = models
    npd = _jax_npd(jm)
    rng = np.random.RandomState(seed)
    sd = {}
    for i, (compvis, diffusers) in enumerate(LOCATIONS):
        for layer in layers:
            module = f"lora_unet_{compvis if i % 2 else diffusers}_{layer}"
            d_in, d_out = npd[JManager.torch_lora_key_to_path(module)].shape
            rank = 4 if i % 3 else 2
            sd[f"{module}.lora_down.weight"] = torch.from_numpy(rng.randn(rank, d_in).astype(np.float32) * 0.1)
            sd[f"{module}.lora_up.weight"] = torch.from_numpy(rng.randn(d_out, rank).astype(np.float32) * 0.1)
            sd[f"{module}.alpha"] = torch.tensor(float(rank) * (0.5 + 0.25 * (i % 3)))
    sd["lora_te_text_model_encoder_layers_0_self_attn_q_proj.lora_down.weight"] = torch.zeros(4, 8)
    sd["lora_te_text_model_encoder_layers_0_self_attn_q_proj.lora_up.weight"] = torch.zeros(8, 4)
    if path.suffix == ".safetensors":
        from safetensors.torch import save_file

        save_file(sd, str(path))
    else:
        torch.save(sd, str(path))
    return str(path)


def _assert_fused_equal(jm, tm, names):
    ref = tree_from_nnx(flat_params(jm), tm)
    params = dict(tm.named_parameters())
    for name in names:
        got = params[name].detach().numpy()
        assert rel_err(got, ref[name].numpy()) < TOL, name
    return ref


def test_fuse_scales_and_restore(models, tmp_path):
    jm, tm = models
    base = {k: v.detach().clone() for k, v in tm.named_parameters()}
    path_a = _lora_file(tmp_path / "a.pt", models, 0, LAYERS[:4] + LAYERS[-2:])
    path_b = _lora_file(tmp_path / "b.safetensors", models, 1, LAYERS[4:8])
    jmgr, tmgr = JManager(), TManager()
    with pytest.warns(UserWarning, match="skipped 1"):
        tpack_a, tpack_b = TManager.load_torch_lora(path_a), convert_lora(path_b)
        jmgr.load_pack_with("a", JManager.load_torch_lora(path_a))
        jmgr.load_pack_with("b", JManager.load_torch_lora(path_b))
    tmgr.load_pack_with("a", tpack_a)
    tmgr.load_pack_with("b", tpack_b)
    assert sorted(tpack_a.deltas) == sorted(lora_path_to_port(p) for p in jmgr._packs["a"].deltas)
    touched = sorted(set(tpack_a.deltas) | set(tmgr._packs["b"].deltas))
    try:
        jmgr.apply_lora(jm, "a")
        tmgr.apply_lora(tm, "a")
        ref = _assert_fused_equal(jm, tm, touched)
        moved = [n for n in tpack_a.deltas if not torch.equal(base[n], dict(tm.named_parameters())[n])]
        assert len(moved) == len(tpack_a.deltas) == 6 * len(LOCATIONS)
        # a pack applied alone leaves the other's layers at their base
        assert all(np.array_equal(ref[n].numpy(), base[n].numpy()) for n in tmgr._packs["b"].deltas)
        scales = {"a": 0.3, "b": -1.5}
        jmgr.set_scales(jm, scales)
        tmgr.set_scales(tm, scales)
        _assert_fused_equal(jm, tm, touched)
        assert tmgr._active == scales
    finally:
        jmgr.deactivate(jm)
        tmgr.deactivate(tm)
    for name, p in tm.named_parameters():
        assert torch.equal(p, base[name]), name
    assert SDLoRAMode("unet") is SDLoRAMode.UNET


def test_numpy_pack_through_the_bridge(models):
    """A JAX `LoRAPack` of numpy (in, rank) / (rank, out) arrays with alpha
    != rank: the bridge's deltas fuse to the JAX weights."""
    jm, tm = models
    npd = _jax_npd(jm)
    rng = np.random.RandomState(2)
    paths = [p for p in npd if p.endswith("kernel/value") and ("/to_" in p or "/ff/" in p)][::3]
    deltas = {p: (rng.randn(npd[p].shape[0], 3).astype(np.float32), rng.randn(3, npd[p].shape[1]).astype(np.float32))
              for p in paths}
    jmgr, tmgr = JManager(), TManager()
    jmgr.load_pack_with("p", JPack(deltas, rank=3, alpha=1.5))
    tmgr.load_pack_with("p", TPack(lora_deltas_from_nnx(deltas), rank=3, alpha=1.5))
    try:
        jmgr.apply_lora(jm, "p", scales={"p": 0.7})
        tmgr.apply_lora(tm, "p", scales={"p": 0.7})
        _assert_fused_equal(jm, tm, [lora_path_to_port(p) for p in paths])
    finally:
        jmgr.deactivate(jm)
        tmgr.deactivate(tm)


def test_create_and_api_methods(models):
    """`LoRAPack.create` targets the attention projections with a zero `up`;
    the API's LoRA methods fuse, survive a weight swap inside
    `load_context` (the delta lands on the new base) and clean up."""
    _, tm = models
    fresh = TPack.create(tm, rank=2, generator=torch.Generator().manual_seed(0))
    assert fresh.deltas and all(".attn" in n and n.endswith(("to_q.weight", "to_k.weight", "to_v.weight",
                                                               "to_out.weight")) for n in fresh.deltas)
    assert all(not up.any() and down.shape[0] == 2 for down, up in fresh.deltas.values())
    api = cflearn_torch.DiffusionAPI(tm, device="cpu")
    name = "unet.input_blocks.0.mods.1.blocks.0.attn1.to_q.weight"
    weight = dict(tm.named_parameters())[name]
    base = weight.detach().clone()
    down, up = torch.full((2, base.shape[1]), 0.1), torch.full((base.shape[0], 2), 0.1)
    api.load_sd_lora("t", pack=TPack({name: (down, up)}, rank=2, alpha=1.0))
    api.inject_sd_lora("t")
    delta = 0.5 * (up @ down)
    torch.testing.assert_close(weight.detach(), base + delta, rtol=1e-6, atol=1e-7)
    with api.load_context() as m:
        assert torch.equal(dict(m.named_parameters())[name], base)
        with torch.no_grad():
            dict(m.named_parameters())[name].fill_(1.0)
    torch.testing.assert_close(weight.detach(), torch.ones_like(base) + delta, rtol=1e-6, atol=1e-7)
    api.set_sd_lora_scales({"t": 2.0})
    torch.testing.assert_close(weight.detach(), torch.ones_like(base) + 2.0 * delta, rtol=1e-6, atol=1e-7)
    api.cleanup_sd_lora()
    assert torch.equal(weight.detach(), torch.ones_like(base))
    with torch.no_grad():
        weight.copy_(base)
