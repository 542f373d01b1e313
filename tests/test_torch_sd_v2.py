"""SD v2 / v2_v in the port against the JAX package, on the CPU.

The tiny v2 / v2_v model of `_torch_sd_v2_common.py` (linear projections,
`num_head_channels` 8, a 32-wide context, v-parameterization), its weights
bridged: the UNet forward, the text tower (clip skip, custom embeddings),
`predict_eps_from`, and the v target's p-loss and its gradients, held to
JAX in f32. Every sampler through both `DiffusionAPI`s on the same model:
`test_torch_sd_v2_samplers.py`.

The full-width checks build nothing on the CPU: the options each package's
`StableDiffusion` hands its `LDM` (both constructors recorded, not run),
the full v2 UNet's and text tower's parameters on "meta" against
`nnx.eval_shape` of the JAX modules (strict bridge: every leaf maps to one
port parameter of its shape), and the zoo's SD constructors recorded the same
way. Tolerances are stated at each test."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import cflearn_torch
import cflearn_torch.zoo.common as TZ
from _torch_bridge_common import flat_shapes, rel_err
from _torch_sd_v2_common import T, v_pair
from cflearn_torch.bridge import map_names, tree_from_nnx
from cflearn_torch.models.cv.diffusion import DDPMModel as TDDPMModel
from cflearn_torch.modules.multimodal.diffusion import ldm as TL
from cflearn_torch.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel as TCLIPText
from cflearn_torch.modules.multimodal.diffusion.unet import UNetDiffuser as TUNet
import cflearn_tpu.zoo.common as JZ
from cflearn_tpu.models.cv.diffusion import DDPMStep
from cflearn_tpu.modules.multimodal.diffusion import ldm as JL
from cflearn_tpu.modules.multimodal.diffusion import unet as JU
from cflearn_tpu.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel

B = 2
VERSIONS = ("v1", "v2", "v2_v", "v2_base", "v2_inpainting")


@pytest.fixture(scope="module")
def pair():
    return v_pair()


def _tokens(seed):
    ids = np.random.RandomState(seed).randint(1, 49000, (B, 77))
    ids[:, 0], ids[:, 12:] = 49406, 49407
    return ids


def test_v2_unet_blocks(pair):
    """v2's transformer: linear projections (the bridge's Dense -> Linear
    transpose reached them), heads = channels // num_head_channels."""
    _, tm = pair
    blocks = [m for m in tm.unet.modules() if type(m).__name__ == "SpatialTransformer"]
    assert blocks and all(b.use_linear and isinstance(b.proj_in, torch.nn.Linear) for b in blocks)
    heads = sorted({(b.proj_in.out_features, a.heads) for b in blocks for a in b.modules()
                    if type(a).__name__ == "CrossAttention"})
    assert heads == [(32, 4), (64, 8)]


def test_unet_forward_matches_jax(pair):
    """One v-prediction UNet call with a context: 1e-5 of the largest
    output (f32 sums in another order through two levels)."""
    jm, tm = pair
    rng = np.random.RandomState(0)
    x = rng.randn(B, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(B, 77, 32).astype(np.float32)
    t = np.array([3, 41])
    ref = np.asarray(nnx.jit(lambda m, *a: m.denoise(*a))(jm, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    with torch.no_grad():
        got = tm.denoise(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    assert rel_err(got, ref) < 1e-5


@pytest.mark.parametrize("clip_skip", [0, 1])
def test_text_tower_matches_jax(pair, clip_skip):
    """The three-layer tower (v2's structure at width 32: quick_gelu, the
    final LayerNorm) with clip skip 0 and 1: 1e-5 of the largest value."""
    jm, tm = pair
    assert tm.condition_model.encoder.blocks[0].mlp.activation == "quick_gelu"
    ids = _tokens(1)
    jm.condition_model.clip_skip = tm.condition_model.clip_skip = clip_skip
    try:
        ref = np.asarray(jm.get_cond(jnp.asarray(ids, jnp.int32)))
        with torch.no_grad():
            got = tm.get_cond(torch.from_numpy(ids)).numpy()
    finally:
        jm.condition_model.clip_skip = tm.condition_model.clip_skip = 0
    assert rel_err(got, ref) < 1e-5


def test_encode_with_custom_embeddings(pair):
    """Two token ids take custom embeddings (textual inversion): 1e-5; an
    empty dict is the plain tower on the table's embeddings."""
    jm, tm = pair
    ids = _tokens(2)
    ids[0, 3] = ids[1, 5] = ids[1, 6] = 1000
    ids[0, 7] = 2000
    rng = np.random.RandomState(3)
    custom = {1000: rng.randn(32).astype(np.float32), 2000: rng.randn(32).astype(np.float32)}
    ref = np.asarray(jm.condition_model.encode_with_custom_embeddings(
        jnp.asarray(ids, jnp.int32), {k: jnp.asarray(v) for k, v in custom.items()}))
    with torch.no_grad():
        got = tm.condition_model.encode_with_custom_embeddings(torch.from_numpy(ids), custom).numpy()
        plain = tm.condition_model.encode_with_custom_embeddings(torch.from_numpy(ids), {}).numpy()
        base = tm.get_cond(torch.from_numpy(ids)).numpy()
    assert rel_err(got, ref) < 1e-5
    assert rel_err(plain, base) < 1e-6 and rel_err(got, base) > 1e-3


def test_v_parameterization_buffers(pair):
    """`predict_eps_from` under v, `get_v`, and a v model's VLB weights
    (ones, the first set to the second): 1e-6."""
    jm, tm = pair
    rng = np.random.RandomState(4)
    x_t, out = (rng.randn(B, 8, 8, 4).astype(np.float32) for _ in range(2))
    t = np.array([0, 37])
    ref = np.asarray(jm.predict_eps_from(jnp.asarray(x_t), jnp.asarray(t), jnp.asarray(out)))
    got = tm.predict_eps_from(torch.from_numpy(x_t), torch.from_numpy(t), torch.from_numpy(out)).numpy()
    assert rel_err(got, ref) < 1e-6
    ref_v = np.asarray(jm.get_v(jnp.asarray(x_t), jnp.asarray(out), jnp.asarray(t)))
    assert rel_err(tm.get_v(torch.from_numpy(x_t), torch.from_numpy(out), torch.from_numpy(t)).numpy(), ref_v) < 1e-6
    np.testing.assert_allclose(tm.lvlb_weights.numpy(), np.asarray(jm.lvlb_weights[...]), rtol=1e-6)
    assert np.all(tm.lvlb_weights.numpy() == 1.0)


@pytest.mark.parametrize("elbo", [0.0, 0.5], ids=["simple", "with_vlb"])
def test_v_p_loss_matches_jax(pair, elbo):
    """The p-loss against the v target (and its VLB term at weight 0.5),
    on 64px images through the frozen first stage, the JAX step's draws fed
    to the port's: loss items 1e-5 relative, every
    trained gradient 1e-4 of its leaf's largest value (floored at 1% of the
    largest gradient)."""
    from types import SimpleNamespace

    jm, tm = pair
    rng = np.random.RandomState(5)
    x0 = rng.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32)
    ctx = rng.randn(B, 77, 32).astype(np.float32)
    rngs = nnx.clone(jm.rngs)
    t = np.array(jax.random.randint(rngs.default(), (B,), 0, T))
    noise = np.array(jax.random.normal(rngs.default(), (B, 8, 8, 4), jnp.float32))
    trained = nnx.All(nnx.Param, nnx.PathContains("unet"))
    gd, params, rest = nnx.split(jm, trained, ...)

    def loss_fn(p):
        step = DDPMStep("all")
        step.original_elbo_weight = elbo
        m = nnx.merge(gd, p, nnx.clone(rest))
        losses = step.loss_fn(SimpleNamespace(m=m), {"input": jnp.asarray(x0), "cond": jnp.asarray(ctx)}, {})
        return losses["loss"], losses

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = TDDPMModel(tm, original_elbo_weight=elbo)
    step = model.train_steps[0]
    assert step.original_elbo_weight == elbo
    got = step.loss_fn(model, {"input": torch.from_numpy(x0), "cond": torch.from_numpy(ctx)},
                       t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    assert set(got) == set(ref)
    for key, value in ref.items():
        assert abs(got[key].item() - float(value)) <= 1e-5 * abs(float(value)), key
    named = [(n, p) for n, p in model.params_filter("all") if n.startswith("m.unet.")]
    grads = torch.autograd.grad(got["loss"], [p for _, p in named])
    flat = {".".join(map(str, path)): np.asarray(v[...]) for path, v in nnx.to_flat_state(jgrads)}
    want = tree_from_nnx(flat, tm, [n[2:] for n, _ in named])
    floor = 1e-2 * max(float(w.abs().max()) for w in want.values())
    for (name, _), g in zip(named, grads):
        ref_g = want[name[2:]]
        assert float((g - ref_g).abs().max()) / max(float(ref_g.abs().max()), floor) < 1e-4, name


# full width: options, parameter shapes, the zoo


def _record_init(monkeypatch, cls):
    """Record the keyword arguments `cls.__init__` is called with, and skip it."""
    seen = []

    def init(self, **kwargs):
        seen.append(kwargs)

    monkeypatch.setattr(cls, "__init__", init)
    return seen


def _sd_options(monkeypatch, version, jax_side):
    mod = JL if jax_side else TL
    seen = _record_init(monkeypatch, mod.LDM)
    monkeypatch.setattr(mod, "CLIPTextConditionModel", lambda **kw: {k: v for k, v in kw.items() if k != "rngs"})
    inpainting = version.endswith("_inpainting")
    cls = mod.StableDiffusionInpainting if inpainting else mod.StableDiffusion
    kw = {"rngs": nnx.Rngs(0)} if jax_side else {}
    cls(version=version.replace("_inpainting", ""), **kw)
    (options,) = seen
    options.pop("rngs", None)
    options.setdefault("condition_type", "cross_attn")
    options["unet_config"] = {k: tuple(v) if isinstance(v, list) else v for k, v in options["unet_config"].items()}
    return options


@pytest.mark.parametrize("version", VERSIONS)
def test_sd_options_match_jax(version, monkeypatch):
    """What `StableDiffusion(version=...)` hands its `LDM` (the UNet config,
    the text tower's width, depth and heads, the parameterization, the first
    stage, the schedule) equals the JAX package's, both constructors
    recorded; `sd_unet_config` too."""
    assert TL.sd_unet_config(version) == JL.sd_unet_config(version)
    ref = _sd_options(monkeypatch, version, True)
    got = _sd_options(monkeypatch, version, False)
    assert got == ref
    want_v = "v" if version == "v2_v" else "eps"
    assert got["parameterization"] == want_v
    assert got["condition_model"]["latent_dim"] == (1024 if version.startswith("v2") else 768)


def _unet_v2():
    return JU.UNetDiffuser(rngs=nnx.Rngs(0), **JL.sd_unet_config("v2"))


def _count(shapes):
    return sum(int(np.prod(s)) for s in shapes.values())


def test_full_width_v2_parameters_match_jax():
    """The full v2 UNet (865,910,724 parameters) and the 1024-wide, 23-layer
    text tower, built on "meta", against `nnx.eval_shape` of the JAX
    modules: the strict bridge maps every JAX leaf to one port parameter of
    its shape, and the counts agree."""
    shapes = flat_shapes(nnx.eval_shape(_unet_v2))
    with torch.device("meta"):
        unet = TUNet(**TL.sd_unet_config("v2"))
    assert len(map_names(shapes, unet)) == len(shapes)
    assert _count(shapes) == sum(p.numel() for p in unet.parameters()) == 865_910_724
    tower = dict(latent_dim=1024, num_layers=23, num_heads=16)
    shapes = flat_shapes(nnx.eval_shape(lambda: CLIPTextConditionModel(rngs=nnx.Rngs(0), **tower)))
    with torch.device("meta"):
        text = TCLIPText(**tower)
    assert len(map_names(shapes, text)) == len(shapes)
    assert _count(shapes) == sum(p.numel() for p in text.parameters())
    heads = [a.heads for a in unet.modules() if type(a).__name__ == "CrossAttention"]
    assert sorted(set(heads)) == [5, 10, 20]
    model = cflearn_torch.build_sd("v2_v", device="meta")
    assert model.parameterization == "v" and model.condition_model.encoder.positional_embedding.shape == (77, 1024)


def test_sd_versions_and_tags():
    """`SDVersions` and `get_sd_tag` over every tag, None, "" and an unknown one."""
    names = {k: v for k, v in vars(JZ.SDVersions).items() if not k.startswith("_")}
    assert {k: v for k, v in vars(cflearn_torch.zoo.SDVersions).items() if not k.startswith("_")} == names
    for tag in list(names.values()) + [None, "", "v2_base", "v2_inpainting", "something"]:
        assert cflearn_torch.zoo.get_sd_tag(tag) == JZ.get_sd_tag(tag), tag


def _record_builds(monkeypatch):
    """The JAX zoo's SD classes and the port zoo's `build`, recorded: (class
    name, its keyword arguments) of each construction."""
    import cflearn_tpu.modules.multimodal.diffusion.ldm as jl
    import cflearn_tpu.modules.multimodal.diffusion.unet as ju

    seen = {"jax": [], "port": []}

    def recorder(name):
        return lambda **kw: seen["jax"].append((name, {k: v for k, v in kw.items() if k != "rngs"}))

    for mod, cls in ((jl, "StableDiffusion"), (jl, "StableDiffusionInpainting"), (ju, "ControlNet")):
        monkeypatch.setattr(mod, cls, recorder(cls))

    def build(cls, *, device=None, dtype=None, seed=0, **kw):
        seen["port"].append((cls.__name__, {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}))

    monkeypatch.setattr(TZ, "build", build)
    return seen


FACTORIES = [("load_sd", (v,)) for v in VERSIONS + ("v1.5", "v1_inpainting", "anime_guofeng", "dreamlike_v1")] + [
    ("load_control_net", ("canny",)), ("ldm_sd", ()), ("ldm_sd_v2", ()), ("ldm_sd_inpainting", ()),
]


@pytest.mark.parametrize("factory,args", FACTORIES, ids=[f"{b}{'_' + a[0] if a else ''}" for b, a in FACTORIES])
def test_zoo_sd_factories_match_jax(factory, args, monkeypatch):
    """Each zoo constructor builds the class the JAX one constructs, with
    the same arguments (both recorded, nothing built); `pretrained=True`
    raises, as no checkpoint is in the repository."""
    seen = _record_builds(monkeypatch)
    getattr(JZ, factory)(*args)
    getattr(cflearn_torch.zoo, factory)(*args, device="meta")
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 1
    with pytest.raises(ValueError, match="never downloaded"):
        getattr(cflearn_torch.zoo, factory)(*args, pretrained=True, device="meta")
    assert "pretrained" in inspect.signature(getattr(cflearn_torch.zoo, factory)).parameters


@pytest.mark.parametrize("version", ["v2", "v2_v", "v2_base", "v2_inpainting"])
def test_from_sd_v2_versions(version):
    """`DiffusionAPI.from_sd` builds through `load_sd` (on "meta" here):
    v2's 1024-wide context, the v-model only for v2_v, the 9-channel UNet
    for v2_inpainting."""
    api = cflearn_torch.DiffusionAPI.from_sd(version, device="meta")
    m = api.m
    assert m.version == version.replace("_inpainting", "")
    assert m.condition_model.encoder.positional_embedding.shape == (77, 1024)
    assert m.parameterization == ("v" if version == "v2_v" else "eps")
    assert m.unet.in_channels == (9 if version.endswith("_inpainting") else 4) and m.out_channels == 4
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())


def test_load_sd_v2_shares_the_checkpoint_entry_of_v2_v(monkeypatch):
    """Inside the reference: `load_sd("v2")` builds an eps model, yet it
    asks for the `sd_v2.1` checkpoint entry, as the v-model `v2_v` does
    (`cflearn_tpu/zoo/common.py:222-223`; the entries' loads recorded here,
    nothing built or read). The port mirrors the models: "v2" eps, "v2_v" v."""
    import cflearn_tpu.zoo.common as jzc

    class Asked(Exception):
        pass

    def load_states(entry, converter, *args):
        raise Asked(entry, converter)

    monkeypatch.setattr(jzc, "get_available", lambda: {"checkpoints": {"sd_v2.1": {}, "sd_v2_base": {}}})
    monkeypatch.setattr(jzc, "load_states", load_states)
    seen = _record_builds(monkeypatch)
    asked = {}
    for version in ("v2", "v2_v", "v2_base"):
        with pytest.raises(Asked) as info:
            jzc.load_sd(version, pretrained=True)
        asked[version] = info.value.args
    assert asked == {"v2": ("sd_v2.1", "sd_v2"), "v2_v": ("sd_v2.1", "sd_v2"), "v2_base": ("sd_v2_base", "sd_v2")}
    assert [kw["version"] for _, kw in seen["jax"]] == ["v2", "v2_v", "v2_base"]
    assert cflearn_torch.build_sd("v2", device="meta").parameterization == "eps"
    assert cflearn_torch.build_sd("v2_v", device="meta").parameterization == "v"


def test_sd_factories_need_the_card(monkeypatch):
    """`load_sd`, `load_control_net` and `from_sd` build on the CUDA card and
    raise without one, unless the caller names a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: cflearn_torch.zoo.load_sd("v2_v"), lambda: cflearn_torch.zoo.load_control_net("canny"),
                 lambda: cflearn_torch.DiffusionAPI.from_sd("v2_v")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert cflearn_torch.zoo.load_control_net("depth", device="meta").unet.in_channels == 4
