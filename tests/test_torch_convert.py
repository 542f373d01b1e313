"""The port's checkpoint converters (`cflearn_torch/zoo/convert.py`) held to
the JAX package's (`cflearn_tpu/zoo/convert.py`, `scripts/sd.py`) on the
CPU, at tiny widths: each JAX module is built abstractly and filled from
numpy (`fast_build`), its parameters inverted by the JAX package's
`invert_mapping` into an upstream-layout dict (open_clip's fused
`in_proj`, which that function cannot write, and the ControlNet by the
port's `invert`), and converted by both packages. The port's conversion
equals the JAX conversion carried across by `bridge.state_dict_from_nnx`,
tensor for tensor, bit for bit; coverage is strict on both sides (every
JAX leaf a target of the mapping, every port parameter filled and nothing
else, no upstream key left over). One forward a converter, the port module
loaded from its conversion against the JAX module: within 1e-4 of max|JAX|
(f32 summation order through a dozen layers).

Then the full-width manifests, with no module built in JAX: the JAX
package's `build_sd_mapping("v1")` / `("v2")` triplets against the port's
and a "meta"-built SD-1.5 and v2 (every key and name; v1's shapes from the
audited `sd_cflearn_mapping.json` inventory), and the cflearn layout.

The ControlNet converter is held to the JAX package's in
`tests/test_torch_pretrained_reference.py`, where the two depart."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import cflearn_torch
from _torch_bridge_common import rel_err  # (also: one intra-op thread; the fetch guard)
from _torch_convert_common import RRDB, UNET_V1, UNET_V2, VAE, VAE_MAP, dotted, holder_of, npd_of, unet_map
from _torch_cv_common import fast_build
from cflearn_torch.bridge import port_name, state_dict_from_nnx
from cflearn_torch.modules.common import build_module
from cflearn_torch.modules.cv.ae import AutoEncoderKL as TAutoEncoderKL
from cflearn_torch.modules.cv.classifier import RRDBNet as TRRDBNet
from cflearn_torch.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel as TCLIPText
from cflearn_torch.modules.multimodal.diffusion.unet import UNetDiffuser as TUNet
from cflearn_torch.zoo import common as TZ
from cflearn_torch.zoo import convert as TC
from cflearn_tpu.modules.cv.ae import AutoEncoderKL
from cflearn_tpu.modules.cv.classifier import RRDBNet
from cflearn_tpu.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel
from cflearn_tpu.modules.multimodal.diffusion.unet import UNetDiffuser
from cflearn_tpu.zoo import convert as JC

TOL = 1e-4


def _torch(upstream):
    return {k: torch.from_numpy(np.array(v)) for k, v in upstream.items()}


def _jax(fn, *args):
    return np.asarray(nnx.jit(fn)(*args))


# the converters' cases: (JAX module, port module, prefix, JAX mapping, port mapping, JAX inverts?)
CASES = {
    "unet": lambda: (fast_build(lambda: UNetDiffuser(rngs=nnx.Rngs(0), in_channels=4, out_channels=4, **UNET_V1)),
                     build_module(TUNet, device="cpu", in_channels=4, out_channels=4, **UNET_V1), "unet",
                     JC.build_unet_mapping(**unet_map(UNET_V1)), TC.build_unet_mapping(**unet_map(UNET_V1)), True),
    "unet_linear": lambda: (
        fast_build(lambda: UNetDiffuser(rngs=nnx.Rngs(1), in_channels=4, out_channels=4, **UNET_V2)),
        build_module(TUNet, device="cpu", in_channels=4, out_channels=4, **UNET_V2), "unet",
        JC.build_unet_mapping(**unet_map(UNET_V2)), TC.build_unet_mapping(**unet_map(UNET_V2)), True),
    "vae": lambda: (fast_build(lambda: AutoEncoderKL(rngs=nnx.Rngs(2), **VAE)),
                    build_module(TAutoEncoderKL, device="cpu", **VAE), "first_stage",
                    JC.build_vae_mapping(**VAE_MAP), TC.build_vae_mapping(**VAE_MAP), True),
    "clip_text": lambda: (fast_build(lambda: CLIPTextConditionModel(rngs=nnx.Rngs(3), latent_dim=32, num_layers=2, num_heads=2)),
                          build_module(TCLIPText, device="cpu", latent_dim=32, num_layers=2, num_heads=2),
                          "condition_model", JC.build_clip_text_mapping(num_layers=2),
                          TC.build_clip_text_mapping(num_layers=2), True),
    "open_clip_text": lambda: (
        fast_build(lambda: CLIPTextConditionModel(rngs=nnx.Rngs(4), latent_dim=32, num_layers=3, num_heads=2)),
        build_module(TCLIPText, device="cpu", latent_dim=32, num_layers=3, num_heads=2), "condition_model",
        JC.build_open_clip_text_mapping(num_layers=3), TC.build_open_clip_text_mapping(num_layers=3), False),
    "esrgan": lambda: (fast_build(lambda: RRDBNet(rngs=nnx.Rngs(5), **RRDB)), build_module(TRRDBNet, device="cpu", **RRDB),
                       "", JC.build_esrgan_mapping(num_blocks=2), TC.build_esrgan_mapping(num_blocks=2), True),
}


@pytest.fixture(scope="module")
def converted():
    """Each case: the JAX module, the port module loaded from the port's conversion, the JAX conversion bridged,
    the port's conversion, the upstream dict."""
    out = {}
    for name, make in CASES.items():
        jm, tm, prefix, jmap, tmap, jax_inverts = make()
        npd = npd_of(jm, f"{prefix}/" if prefix else "")
        holder = holder_of(prefix, tm)
        assert set(npd) == {o for _, o, _ in jmap}, name  # every JAX leaf is a target of the JAX mapping
        if jax_inverts:
            upstream = JC.invert_mapping(jmap, npd)
        else:  # fused q / k / v: written from the JAX leaves carried into the port's names
            upstream = {k: v.numpy() for k, v in TC.invert(tmap, state_dict_from_nnx(dotted(npd), holder)).items()}
        ref = state_dict_from_nnx(dotted(JC.apply_mapping(jmap, upstream, strict=True)), holder)
        got = TC.apply_mapping(tmap, _torch(upstream), strict=True)
        assert TC.unused_keys(tmap, upstream) == [], name
        TZ.load_into(holder, got, name)
        out[name] = (jm, tm, ref, got, upstream)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_converter_matches_the_bridged_jax_conversion(converted, name) -> None:
    _, tm, ref, got, upstream = converted[name]
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], ref[k]), k
    # the upstream layout: OIHW convs, (out, in) linears, the VAE attention's 1x1 convs
    if name == "vae":
        assert upstream["first_stage_model.encoder.mid.attn_1.q.weight"].shape[2:] == (1, 1)
    if name == "unet":
        assert upstream["model.diffusion_model.input_blocks.0.0.weight"].shape == (32, 4, 3, 3)


def inputs(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 8, 8, 4)).astype(np.float32), np.array([37]),
            rng.standard_normal((1, 5, 32)).astype(np.float32), rng.integers(0, 400, (1, 5)).astype(np.int64))


@pytest.mark.parametrize("name", sorted(CASES))
def test_converted_forward_matches_jax(converted, name) -> None:
    jm, tm, _, _, _ = converted[name]
    x, t, ctx, ids = inputs(8)
    with torch.no_grad():
        if name.startswith("unet"):
            got = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
            ref = _jax(lambda m, *a: m(*a), jm, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
        elif name == "vae":
            got = tm.decode(torch.from_numpy(x))
            ref = _jax(lambda m, a: m.decode(a), jm, jnp.asarray(x))
        elif name.endswith("clip_text"):
            got = tm(torch.from_numpy(ids))
            ref = _jax(lambda m, a: m(a), jm, jnp.asarray(ids.astype(np.int32)))
        else:
            img = np.random.default_rng(9).random((1, 8, 8, 3), dtype=np.float32)
            got = tm(torch.from_numpy(img))
            ref = _jax(lambda m, a: m(a), jm, jnp.asarray(img))
    assert got.shape == ref.shape and rel_err(got.numpy(), ref) < TOL


# ---------------------------------------------------------------- full-width manifests, no JAX module


def _sd_shapes():
    """v1's upstream shapes from the audited inventory: the renames, and the text tower's split q / k / v and
    squeezed position table."""
    table = TC.sd_cflearn_table()
    shapes = {orig: tuple(table["reference_shapes"][ck]) for ck, orig in table["renames"].items()}
    blocks = "condition_model.m.text_transformer.encoder.mixing_blocks"
    hf = "cond_stage_model.transformer.text_model"
    for i in range(table["special_fused_qkv_layers"]):
        d = table["reference_shapes"][f"{blocks}.{i}.token_mixing.net.in_w"][1]
        for n in "qkv":
            shapes[f"{hf}.encoder.layers.{i}.self_attn.{n}_proj.weight"] = (d, d)
            shapes[f"{hf}.encoder.layers.{i}.self_attn.{n}_proj.bias"] = (d,)
    pos = table["reference_shapes"]["condition_model.m.text_transformer.encoder.pos_encoding.pos_encoding"]
    shapes[f"{hf}.embeddings.position_embedding.weight"] = tuple(pos[1:])
    return shapes


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_full_width_sd_manifest(version) -> None:
    jmap, tmap = JC.build_sd_mapping(version), TC.build_sd_mapping(version)
    assert len(jmap) == len(tmap) == len({name for _, name, _ in tmap})
    kinds = {"linear": 2, "conv": 4, "conv1x1_to_linear": 4}
    for (jk, jo, jkind), (tk, to, tkind) in zip(jmap, tmap):
        assert jk == tk and jkind == tkind
        path = jo[: -len("/value")].replace("/", ".")
        ndim = 2 if jkind.startswith("linear") else kinds.get(jkind, 1)
        assert to == port_name(path, ndim)[0]
    m = cflearn_torch.zoo.load_sd(version, device="meta")
    params = {k: tuple(p.shape) for k, p in m.named_parameters()}
    assert {to for _, to, _ in tmap} == set(params)
    if version == "v1":
        shapes = _sd_shapes()
        assert set(shapes) == {tk for tk, _, _ in tmap}
        for tk, to, kind in tmap:
            assert tuple(TC._fwd(kind, torch.empty(shapes[tk], device="meta")).shape) == params[to], tk
    # the keys of the real file that no parameter takes are dropped only by name
    extra = {k: None for k in ("betas", "model_ema.decay", "cond_stage_model.transformer.text_model.embeddings.position_ids",
                               "cond_stage_model.model.logit_scale", "lvlb_weights")}
    drop = TC.DROPPED["sd_v2" if version == "v2" else "sd"]
    left = TC.unused_keys(tmap, extra, drop)
    assert left == (["cond_stage_model.model.logit_scale", "lvlb_weights"] if version == "v1" else
                    ["cond_stage_model.transformer.text_model.embeddings.position_ids", "lvlb_weights"])
    with pytest.raises(ValueError, match="lvlb_weights"):
        TC.convert_with(tmap, extra, drop)


def test_cflearn_layout_converts_as_jax_and_drops_only_by_name() -> None:
    table = TC.sd_cflearn_table()
    assert TC.build_sd_cflearn_renames() == table["renames"] == JC.build_sd_cflearn_renames()
    rng = np.random.default_rng(12)
    shapes = {k: tuple(min(s, 2) for s in v) for k, v in table["reference_shapes"].items()}
    blocks = "condition_model.m.text_transformer.encoder.mixing_blocks"
    pos = "condition_model.m.text_transformer.encoder.pos_encoding.pos_encoding"
    for i in range(table["special_fused_qkv_layers"]):
        shapes[f"{blocks}.{i}.token_mixing.net.in_w"] = (6, 2)
        shapes[f"{blocks}.{i}.token_mixing.net.qkv_bias"] = (6,)
    shapes[pos] = (1, 3, 2)
    cf = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    assert set(table["non_checkpoint_keys"]) <= set(cf)
    ref = JC.convert_sd_cflearn(cf, strict=True)
    got = TC.convert_sd_cflearn(_torch(cf))
    assert len(got) == len(ref) == len(TC.build_sd_mapping("v1"))
    for k, v in ref.items():
        path = k[: -len("/value")].replace("/", ".")
        name, perm = port_name(path, v.ndim)
        name = path if path.endswith("positional_embedding") else name
        want = np.transpose(v, perm) if perm and v.ndim > 1 else v
        assert np.array_equal(got[name].numpy(), want), k
    # a key the table does not list: JAX drops it, the port raises
    cf["condition_model.m.something_new"] = np.zeros(2, np.float32)
    assert len(JC.convert_sd_cflearn(cf)) == len(ref)
    with pytest.raises(ValueError, match="something_new"):
        TC.convert_sd_cflearn(_torch(cf))
