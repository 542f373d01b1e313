"""Loads that the JAX package leaves partial, silently, and the port's
strict loader refuses or completes, each shown on both sides at tiny
widths, through a test index of tiny entries in both packages (their caches
under `tmp_path`, every fetch refused):

- a leaf the file does not fill: JAX keeps its random value
  (`npd_to_tree(..., strict=False)`, `cflearn_tpu/zoo/common.py:201`,
  `:498`); the port raises and names it;
- a standalone CLIP or first stage: their converters' mappings name an SD
  checkpoint's text tower and first stage (`cond_stage_model...` ->
  `condition_model/encoder/...`, `first_stage_model...` -> `first_stage/...`,
  `cflearn_tpu/zoo/convert.py:258`, `:336-340`), which a standalone module
  does not hold: JAX loads nothing from an HF CLIP or a standalone VAE file;
  the port raises, naming the parameters and the keys;
- a Real-ESRGAN file's `params_ema`: JAX unwraps `state_dict` only
  (`convert.py:446-449`) and loads nothing; the port loads it;
- a first stage given by a generator name with `pretrained`: JAX ignores
  the flag (`modules/multimodal/diffusion/ldm.py:64-65`); the port raises;
- the ControlNet: the JAX converter (`scripts/sd.py:43-60`) places
  `input_hint_block.14` at a `hint_blocks/7` its module does not hold and
  takes no `middle_block_out`, so a JAX ControlNet keeps its `hint_out` and
  `mid_zero`; the port loads them. The two conversions agree on every other
  tensor (the JAX one at these widths through its own `build_unet_mapping`),
  and the port's ControlNet loaded from the file gives the JAX net's
  residuals within 1e-4 of max|JAX|."""

import functools
import urllib.request

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from flax import nnx

import cflearn_torch
import cflearn_tpu.zoo.common as JZ
from _torch_bridge_common import rel_err  # (also: one intra-op thread; the fetch guard)
from _torch_convert_common import RRDB, UNET_V1, VAE, VAE_MAP, dotted, holder_of, npd_of
from _torch_cv_common import fast_build
from cflearn_torch.bridge import port_name, state_dict_from_nnx
from cflearn_torch.modules.common import build_module
from cflearn_torch.modules.cv.ae import AutoEncoderKL as TAutoEncoderKL
from cflearn_torch.modules.cv.classifier import RRDBNet as TRRDBNet
from cflearn_torch.modules.multimodal.diffusion.unet import ControlNet as TControlNet
from cflearn_torch.parameters import OPT as TOPT
from cflearn_torch.toolkit import misc as TM
from cflearn_torch.zoo import common as TZ
from cflearn_torch.zoo import convert as TC
from cflearn_tpu.modules.cv.classifier import RRDBNet
from cflearn_tpu.modules.multimodal.diffusion import ldm as JL
from cflearn_tpu.modules.multimodal.diffusion.unet import ControlNet
from cflearn_tpu.parameters import OPT as JOPT
from cflearn_tpu.scripts import sd as JSD
from cflearn_tpu.toolkit import misc as JM
from cflearn_tpu.toolkit.tree import npd_to_tree
from cflearn_tpu.zoo import convert as JC

TOL = 1e-4
# the first-stage cases' autoencoder and LDM, smaller still: only their construction and loading run
SMALL_VAE = dict(img_size=16, inner_channels=32, z_channels=4, embedding_channels=4, channel_multipliers=(1, 2),
                 num_res_blocks=1)
SMALL_UNET = dict(start_channels=32, num_res_blocks=1, channel_multipliers=(1,), attention_downsample_rates=(1,),
                  num_heads=4, context_dim=32)


def inputs(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 8, 8, 4)).astype(np.float32), np.array([37]),
            rng.standard_normal((1, 5, 32)).astype(np.float32))


@pytest.fixture
def tiny_index(tmp_path, monkeypatch):
    """Both packages' caches under `tmp_path` and an index of tiny entries; fetches refused, retries not slept."""
    index = {"checkpoints": {
        "tiny_esr": {"url": "https://checkpoints.invalid/tiny_esr.pth", "converter": "esrgan"},
        "tiny_clip": {"url": "https://checkpoints.invalid/tiny_clip.bin", "converter": "clip_text"},
        "ae_kl_f8": {"url": "https://checkpoints.invalid/tiny_vae.ckpt", "converter": "vae"},
    }}
    monkeypatch.setattr(JZ, "get_available", lambda: index)
    monkeypatch.setattr(TZ, "get_available", lambda: index)
    monkeypatch.setattr(urllib.request, "urlretrieve", lambda url, *a, **k: (_ for _ in ()).throw(OSError(url)))
    TM._verified_downloads.clear()
    JM._verified_downloads.clear()
    with TOPT.opt_context({"cache_dir": str(tmp_path / "port")}), JOPT.opt_context({"cache_dir": str(tmp_path / "jax")}):
        folders = [TM.get_download_cache_dir(), JM.get_download_cache_dir()]

        def put(name, sd):
            for folder in folders:
                torch.save(sd, folder / name)

        yield put


def _same_as_fresh(jm, fresh) -> bool:
    a, b = npd_of(jm), npd_of(fresh)
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def _spy_loads(monkeypatch):
    """The JAX loads' counts of converted keys that name a leaf of the module loaded into."""
    seen = []
    load = JZ.npd_to_tree

    def spy(npd, template, **kwargs):
        leaves = {"/".join(str(getattr(k, "key", k)) for k in path) for path, _ in nnx.to_flat_state(template)}
        seen.append(sum(1 for k in npd if k[: -len("/value")] in leaves or k in leaves))
        return load(npd, template, **kwargs)

    monkeypatch.setattr(JZ, "npd_to_tree", spy)
    return seen


def test_a_leaf_the_file_leaves_unfilled(tiny_index, monkeypatch) -> None:
    tm = build_module(TRRDBNet, device="cpu", **RRDB)
    upstream = TC.invert(TC.build_esrgan_mapping(num_blocks=2), dict(tm.named_parameters()))
    tiny_index("tiny_esr.pth", {k: v.detach() for k, v in upstream.items() if k != "conv_last.bias"})
    jm = RRDBNet(rngs=nnx.Rngs(0), **RRDB)
    before = np.asarray(jm.conv_last.bias[...]).copy()
    seen = _spy_loads(monkeypatch)
    JZ.load_pretrained_weights(jm, "tiny_esr")
    assert seen == [len(upstream) - 1]  # every converted key names a leaf: the spy counts what lands
    assert np.array_equal(np.asarray(jm.conv_last.bias[...]), before)  # JAX: the random value stays, silently
    assert np.array_equal(np.asarray(jm.conv_first.bias[...]), upstream["conv_first.bias"].detach().numpy())
    with pytest.raises(ValueError, match=r"1 parameters the checkpoint leaves unfilled, e.g. \['conv_last.bias'\]"):
        TZ.load_pretrained_weights(build_module(TRRDBNet, device="cpu", **RRDB), "tiny_esr")


def test_real_esrgan_params_ema(tiny_index) -> None:
    tm = build_module(TRRDBNet, device="cpu", seed=3, **RRDB)
    upstream = {k: v.detach() for k, v in TC.invert(TC.build_esrgan_mapping(num_blocks=2), dict(tm.named_parameters())).items()}
    tiny_index("tiny_esr.pth", {"params_ema": upstream})
    jm = RRDBNet(rngs=nnx.Rngs(0), **RRDB)
    JZ.load_pretrained_weights(jm, "tiny_esr")
    assert _same_as_fresh(jm, RRDBNet(rngs=nnx.Rngs(0), **RRDB))  # JAX: nothing loads
    loaded = TZ.load_pretrained_weights(build_module(TRRDBNet, device="cpu", **RRDB), "tiny_esr")
    assert all(torch.equal(a, b) for a, b in zip(loaded.parameters(), tm.parameters()))


TINY_CLIP = dict(img_size=32, latent_dim=24, vision_latent_dim=32, vision_patch_size=8, vision_num_layers=2,
                 vision_num_heads=2, vocab_size=600, context_length=77, text_latent_dim=32, text_num_layers=2,
                 text_num_heads=2)


def test_standalone_clip_and_first_stage_load_nothing_in_jax(tiny_index, monkeypatch) -> None:
    """The `clip_text` and `vae` mappings name an SD checkpoint's text tower and first stage
    (`cond_stage_model...`, `first_stage_model...` -> `condition_model/encoder/...`, `first_stage/...`), which a
    standalone CLIP or first stage does not hold: given an HF CLIP file or a standalone VAE file, JAX loads
    nothing and keeps every random value; the port raises, naming the parameters and the keys."""
    rng = np.random.default_rng(13)
    hf = {f"text_model.encoder.layers.{i}.self_attn.q_proj.weight": torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32))
          for i in range(2)}
    hf["vision_model.embeddings.class_embedding"] = torch.zeros(32)
    tiny_index("tiny_clip.bin", hf)
    seen = _spy_loads(monkeypatch)
    # the JAX modules built abstractly and filled from numpy (`fast_build`): the loads are what is under test
    build = JZ.build_module
    monkeypatch.setattr(JZ, "build_module", lambda name, config, rngs: fast_build(
        lambda: build(name, config=config, rngs=nnx.Rngs(0))))
    JZ.load_module("multimodal/clip", pretrained=True, tag="tiny_clip", **TINY_CLIP)
    assert seen == [0]  # JAX: no converted key names a leaf of the module, so every random value stays
    with pytest.raises(ValueError, match="parameters the checkpoint leaves unfilled.*checkpoint keys that no parameter takes"):
        TZ.load_module("multimodal/clip", pretrained=True, tag="tiny_clip", device="cpu", **TINY_CLIP)
    # a first stage given by preset name with `pretrained`: the JAX LDM calls `load_module(first_stage,
    # pretrained=True, ...)` (`modules/multimodal/diffusion/ldm.py:67`), which loads nothing from a standalone
    # VAE file; the port's LDM loads the preset strictly when it is materialised, and raises
    vae = build_module(TAutoEncoderKL, device="cpu", **SMALL_VAE)
    standalone = {k[len("first_stage_model."):]: v.detach() for k, v in
                  TC.invert(TC.build_vae_mapping(**SMALL_VAE), dict(holder_of("first_stage", vae).named_parameters())).items()}
    tiny_index("tiny_vae.ckpt", {"state_dict": standalone})
    JZ.load_module("ae/kl.f8", pretrained=True, **SMALL_VAE)
    assert seen == [0, 0]
    kw = dict(img_size=4, in_channels=4, out_channels=4, num_timesteps=50, unet_config=SMALL_UNET,
              first_stage="ae/kl.f8", first_stage_config=dict(SMALL_VAE, pretrained=True))
    with pytest.raises(ValueError, match="'ae_kl_f8'.*leaves unfilled.*keys that no parameter takes"):
        cflearn_torch.build(cflearn_torch.LDM, device="cpu", **kw)


def test_a_generator_named_first_stage_with_pretrained() -> None:
    """JAX builds a first stage given by a `generators` name with random weights whatever `pretrained` says
    (`ldm.py:64-65`); the port raises. Given by preset name, the port loads it when `build_module` has
    materialised the model, and refuses "meta" and a direct construction."""
    kw = dict(img_size=4, in_channels=4, out_channels=4, num_timesteps=50, unet_config=SMALL_UNET,
              first_stage="ae_kl", first_stage_config=dict(SMALL_VAE, pretrained=True))
    jm = nnx.eval_shape(lambda: JL.LDM(rngs=nnx.Rngs(0), **kw))
    assert type(jm.first_stage).__name__ == "AutoEncoderKL"
    with pytest.raises(ValueError, match="names a generator, which has no checkpoint"):
        cflearn_torch.build(cflearn_torch.LDM, device="meta", **kw)
    with pytest.raises(ValueError, match="not 'meta'"):
        cflearn_torch.build(cflearn_torch.LDM, device="meta", **dict(kw, first_stage="ae/kl.f8"))
    # constructed directly on a real device, the LDM has no hook to load it in, and refuses
    with pytest.raises(ValueError, match="loads when `build_module` builds the LDM"):
        cflearn_torch.LDM(**dict(kw, first_stage="ae/kl.f8"))


def test_controlnet_converter_and_what_jax_leaves_unfilled(monkeypatch) -> None:
    cfg = dict(UNET_V1, in_channels=4)
    jc = fast_build(lambda: ControlNet(rngs=nnx.Rngs(6), hint_channels=3, **cfg))
    tc = build_module(TControlNet, device="cpu", hint_channels=3, **cfg)
    geometry = dict(num_res_blocks=1, channel_multipliers=(1, 2), attention_downsample_rates=(1,))
    tmap = TC.build_controlnet_mapping(**geometry)
    flat = {k: v for k, v in dotted(npd_of(jc)).items() if not k.startswith(("unet.output_blocks.", "unet.norm_out.",
                                                                              "unet.conv_out."))}
    original = state_dict_from_nnx(flat, tc)
    upstream = TC.invert(tmap, original)
    assert "control_model.input_hint_block.14.weight" in upstream and "control_model.middle_block_out.0.weight" in upstream
    got = TC.convert_controlnet_sd(upstream, **geometry)
    assert set(got) == set(original) and all(torch.equal(got[k], original[k]) for k in got)
    # the JAX converter on the same file, at these widths (its UNet mapping's geometry patched in)
    monkeypatch.setattr(JC, "build_unet_mapping", functools.partial(JC.build_unet_mapping, **geometry))
    ref = JSD.convert_controlnet_sd({k: v.numpy() for k, v in upstream.items()})
    stray = "hint_blocks/7/kernel/value"  # input_hint_block.14, which the JAX module does not hold
    assert stray in ref and not {"hint_out/kernel/value", "mid_zero/kernel/value"} & set(ref)
    for k, v in ref.items():
        if k.startswith("hint_blocks/7/"):
            continue
        name, perm = port_name(k[: -len("/value")].replace("/", "."), v.ndim)
        assert torch.equal(got[name], torch.from_numpy(np.ascontiguousarray(np.transpose(v, perm) if perm else v))), k
    fresh = fast_build(lambda: ControlNet(rngs=nnx.Rngs(6), hint_channels=3, **cfg), seed=1)
    before = npd_of(fresh)
    nnx.update(fresh, npd_to_tree(ref, nnx.state(fresh), strict=False))  # the JAX package's load
    kept = {k: v for k, v in npd_of(fresh).items() if k.startswith(("hint_out", "mid_zero"))}
    assert kept and all(np.array_equal(v, before[k]) for k, v in kept.items())  # JAX: the file's values never land
    assert torch.equal(got["hint_out.weight"], upstream["control_model.input_hint_block.14.weight"])
    assert torch.equal(got["mid_zero.weight"], upstream["control_model.middle_block_out.0.weight"])
    # the forward: the port ControlNet loaded from the file is the JAX net the file was written from
    TZ.load_into(tc, got, "controlnet")
    x, t, ctx = inputs(10)
    hint = np.random.default_rng(11).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        outs = tc(*map(torch.from_numpy, (x, hint, t, ctx)))
    refs = nnx.jit(lambda m, *a: m(*a))(jc, *map(jnp.asarray, (x, hint, t, ctx)))
    assert len(outs) == len(refs)
    assert all(rel_err(o.numpy(), np.asarray(r)) < TOL for o, r in zip(outs, refs))
