"""The VQ latent-diffusion family's modules in the port against the JAX
package's, in f32 on the CPU at narrow widths: the attentions of
`attentions.py` (`MultiHeadSpatialAttention`'s per-head interleaved qkv,
`Attention` with masks, biases and causality, `DecayedAttention`,
`LinearDepthWiseAttention`, the registry), the conv-free resampling
(`Downsample(use_conv=False)`, the resblock's `down` / `up`), the LDM UNets
(`use_spatial_transformer=False` with resblock or pooled resampling),
`Rescaler` and `make_condition_model`, the attention-free `AutoEncoderVQ`,
an `LDM` whose first stage is a zoo preset, and the `jax.image.resize`
mirror. Then the zoo: `parse_config` tag by tag, the three presets'
parameter counts at full width (built on "meta"), and the strict bridge on
tiny versions of each.

Each JAX module is built with `nnx.Rngs(0)`, its zero-initialised kernels
redrawn, its parameters carried across by `cflearn_torch.bridge`; both get
the same numpy inputs. Tolerance: 1e-5 of max|ref| (f32 summation order;
flash-eligible shapes run the Pallas kernel in interpret mode on the JAX
side and the plain version on the port's)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import cflearn_torch
from _torch_bridge_common import bridged, dezero, flat_params, flat_shapes, rel_err
from cflearn_torch import zoo as tzoo
from cflearn_torch.bridge import map_names
from cflearn_torch.modules.core import attentions as TAt
from cflearn_torch.modules.core import convs as TCv
from cflearn_torch.modules.cv.ae import AutoEncoderVQ as TAutoEncoderVQ
from cflearn_torch.modules.layers import nearest_indices, resize, resize_bilinear, resize_weights
from cflearn_torch.modules.multimodal.diffusion import cond_models as TCond
from cflearn_torch.modules.multimodal.diffusion.ddpm import make_condition_model as t_make_condition_model
from cflearn_torch.modules.multimodal.diffusion.unet import UNetDiffuser as TUNet
from cflearn_tpu import zoo as jzoo
from cflearn_tpu.modules.core import attentions as JAt
from cflearn_tpu.modules.core import convs as JCv
from cflearn_tpu.modules.cv.ae import AutoEncoderVQ
from cflearn_tpu.modules.multimodal.diffusion import cond_models as JCond
from cflearn_tpu.modules.multimodal.diffusion.ddpm import make_condition_model
from cflearn_tpu.modules.multimodal.diffusion.ldm import LDM
from cflearn_tpu.modules.multimodal.diffusion.unet import UNetDiffuser
from cflearn_tpu.ops import attention as A

TOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    # flash-eligible shapes (L >= 256) run the Pallas kernel in interpret mode
    monkeypatch.setattr(A, "_INTERPRET", True)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


def _check(got: torch.Tensor, ref, tol: float = TOL) -> None:
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    assert rel_err(got.detach().numpy(), ref) < tol


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---- attentions ----


@pytest.mark.parametrize(
    "kw,hw",
    [(dict(num_heads=1), 8), (dict(num_heads=4), 8), (dict(num_heads=4), 16), (dict(num_head_channels=16), 16)],
    ids=["1head_L64", "4heads_L64", "4heads_L256_flash", "head_channels_16_L256_flash"],
)
def test_multi_head_spatial_attention(kw, hw) -> None:
    """The qkv channels are interleaved per head: with more than one head a
    port that split [Q | K | V] would miss by the whole output."""
    jm = dezero(JAt.MultiHeadSpatialAttention(64, rngs=nnx.Rngs(0), **kw))
    tm = bridged(jm, TAt.MultiHeadSpatialAttention(64, **kw))
    x = _rand(1, 2, hw, hw, 64)
    _check(tm(_t(x)), jm(jnp.asarray(x)))
    heads = tm.num_heads
    if heads > 1:  # the other split disagrees: the layout test has teeth
        q, k, v = tm.to_qkv(tm.norm(_t(x)).reshape(2, hw * hw, 64)).chunk(3, dim=-1)
        wrong = TAt.sdp_attn(*(TAt._split_heads(t, heads) for t in (q, k, v)))
        wrong = _t(x) + tm.to_out(TAt._merge_heads(wrong)).reshape(2, hw, hw, 64)
        assert rel_err(wrong.detach().numpy(), np.asarray(jm(jnp.asarray(x)))) > 1e-2


@pytest.mark.parametrize("case", ["self", "self_in_proj", "cross", "mask", "bias", "causal"])
def test_attention(case) -> None:
    kw = dict(is_self_attention=case == "self_in_proj")
    if case == "cross":
        kw["kv_dim"] = 12
    jm = JAt.Attention(16, 2, rngs=nnx.Rngs(0), **kw)
    tm = bridged(jm, TAt.Attention(16, 2, **kw))
    q = _rand(1, 2, 10, 16)
    kv = _rand(2, 2, 7, 12) if case == "cross" else None
    call = {}
    if case == "mask":
        call["mask"] = np.random.RandomState(3).rand(2, 1, 10, 10) > 0.7  # True drops
    elif case == "bias":
        call["bias"] = _rand(4, 1, 2, 10, 10)
    elif case == "causal":
        call["causal"] = True
    ref = jm(jnp.asarray(q), None if kv is None else jnp.asarray(kv), None if kv is None else jnp.asarray(kv),
             **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in call.items()})
    got = tm(_t(q), None if kv is None else _t(kv), None if kv is None else _t(kv),
             **{k: _t(v) if isinstance(v, np.ndarray) else v for k, v in call.items()})
    _check(got, ref)


def test_decayed_attention() -> None:
    jm = JAt.DecayedAttention(16, 2, seq_len=10, rngs=nnx.Rngs(0))
    tm = TAt.DecayedAttention(16, 2, seq_len=10)
    np.testing.assert_array_equal(tm.decay_bias.numpy(), np.asarray(jm.decay_bias[...]))
    tm = bridged(jm, tm)
    q = _rand(5, 2, 10, 16)
    _check(tm(_t(q)), jm(jnp.asarray(q)))


def test_linear_depth_wise_attention() -> None:
    jm = JAt.LinearDepthWiseAttention(24, num_heads=2, head_dim=8, rngs=nnx.Rngs(0))
    tm = bridged(jm, TAt.LinearDepthWiseAttention(24, num_heads=2, head_dim=8))
    x = _rand(6, 2, 5, 7, 24)
    _check(tm(_t(x)), jm(jnp.asarray(x)))


def test_make_attention() -> None:
    assert sorted(TAt.attentions.all) == sorted(JAt.attentions.all) == ["basic", "cross", "decayed"]
    jm = JAt.make_attention("basic", 16, 4, rngs=nnx.Rngs(0))
    tm = TAt.make_attention("basic", 16, 4)
    assert isinstance(tm, TAt.Attention) and tm.num_heads == 4
    tm = bridged(jm, tm)
    q = _rand(7, 1, 9, 16)
    _check(tm(_t(q)), jm(jnp.asarray(q)))
    assert isinstance(TAt.make_attention("decayed", 16, 2, seq_len=9), TAt.DecayedAttention)
    with pytest.raises(ValueError):
        TAt.make_attention("missing", 16)


# ---- conv-free resampling ----


@pytest.mark.parametrize("hw", [(8, 8), (9, 7)])
def test_downsample_avg_pool(hw) -> None:
    jm = JCv.Downsample(16, use_conv=False, rngs=nnx.Rngs(0))
    tm = TCv.Downsample(16, use_conv=False)
    assert not list(tm.parameters())
    x = _rand(8, 2, *hw, 16)
    _check(tm(_t(x)), jm(jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["down", "up"])
def test_resblock_resampling(kind) -> None:
    kw = {kind: True}
    jm = dezero(JCv.ResidualBlockWithTimeEmbedding(64, 64, time_embed_dim=32, rngs=nnx.Rngs(0), **kw))
    tm = bridged(jm, TCv.ResidualBlockWithTimeEmbedding(64, 64, time_embed_dim=32, **kw))
    x, emb = _rand(9, 2, 8, 8, 64), _rand(10, 2, 32)
    got = tm(_t(x), _t(emb))
    assert tuple(got.shape) == ((2, 4, 4, 64) if kind == "down" else (2, 16, 16, 64))
    _check(got, jm(jnp.asarray(x), jnp.asarray(emb)))


# ---- the LDM UNets ----

LDM_UNET = dict(in_channels=6, out_channels=3, start_channels=32, num_res_blocks=1, channel_multipliers=(1, 2, 2),
                attention_downsample_rates=(2, 4), num_heads=4, use_spatial_transformer=False)


@pytest.mark.parametrize(
    "extra", [dict(resample_with_resblock=True), dict(resample_with_conv=False), dict(num_head_channels=16)],
    ids=["resblock_resampling", "pooled_resampling", "head_channels"],
)
def test_unet_without_spatial_transformer(extra) -> None:
    """32x32 latents: the 16x16 level's attention is flash-eligible (L = 256)."""
    cfg = dict(LDM_UNET, **extra)
    jm = dezero(UNetDiffuser(rngs=nnx.Rngs(0), **cfg))
    tm = bridged(jm, TUNet(**cfg))
    assert not any(isinstance(m, TAt.CrossAttention) for m in tm.modules())
    n_mhsa = sum(isinstance(m, TAt.MultiHeadSpatialAttention) for m in tm.modules())
    assert n_mhsa == 2 + 1 + 2 + 2  # input levels 1, 2; mid; output levels 2, 1
    x = _rand(11, 2, 32, 32, 6)
    t = np.array([3, 901])
    _check(tm(_t(x), torch.from_numpy(t)), jm(jnp.asarray(x), jnp.asarray(t, jnp.int32)))


# ---- condition models ----


@pytest.mark.parametrize(
    "cfg,hw",
    [(dict(in_channels=5, num_stages=2), (37, 23)), (dict(in_channels=5, out_channels=3, num_stages=2), (37, 23)),
     (dict(in_channels=4, out_channels=2, bias=True, method="bicubic"), (21, 30)),
     (dict(in_channels=4, num_stages=1, multiplier=0.75, method="nearest"), (19, 13))],
    ids=["no_mapper", "mapper", "bicubic_bias", "nearest"],
)
def test_rescaler(cfg, hw) -> None:
    """Odd sizes: 37 * 0.5 rounds half to even (18), 23 * 0.5 to 12."""
    jm = JCond.Rescaler(rngs=nnx.Rngs(0), **cfg)
    tm = TCond.Rescaler(**cfg)
    if cfg.get("out_channels"):
        tm = bridged(jm, tm)
    x = _rand(12, 2, *hw, cfg["in_channels"])
    _check(tm(_t(x)), jm(jnp.asarray(x)))


def test_make_condition_model() -> None:
    cfg = dict(num_stages=2, in_channels=8, out_channels=3)
    jm = make_condition_model("rescaler", cfg)
    tm = t_make_condition_model("rescaler", cfg)
    assert isinstance(tm, TCond.Rescaler) and TCond.SpatialRescaler is TCond.Rescaler
    tm = bridged(jm, tm)
    x = _rand(13, 1, 32, 32, 8)
    _check(tm(_t(x)), jm(jnp.asarray(x)))
    clip_kw = dict(latent_dim=32, num_layers=1, num_heads=2)
    assert isinstance(t_make_condition_model("clip_text", clip_kw), TCond.CLIPTextConditionModel)
    with pytest.raises(ValueError):
        t_make_condition_model("missing")


# ---- the first stage ----

VQ = dict(img_size=32, inner_channels=32, z_channels=3, embedding_channels=3, num_code=64, channel_multipliers=[1, 2],
          num_res_blocks=1)


@pytest.mark.parametrize("extra", [dict(attention_type="none"), dict(resample_with_conv=False)])
def test_autoencoder_vq_variants(extra) -> None:
    jm = AutoEncoderVQ(rngs=nnx.Rngs(0), **VQ, **extra)
    tm = bridged(jm, TAutoEncoderVQ(**VQ, **extra))
    if extra.get("attention_type") == "none":
        assert tm.encoder.mid_attn is None and tm.decoder.mid_attn is None
        assert not any(isinstance(m, TAt.SpatialAttention) for m in tm.modules())
    x = np.random.RandomState(14).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ref = jm.encode(jnp.asarray(x))
    got = tm.encode(_t(x))
    _check(tm.encoder(_t(x)), jm.encoder(jnp.asarray(x)))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    _check(tm.decode(got.z_q), jm.decode(ref.z_q))


def test_ldm_first_stage_from_zoo_preset() -> None:
    """`first_stage="ae/vq.f4"` builds the preset's `AutoEncoderVQ` (8192
    codes of 3) with `first_stage_config` over it."""
    fs_cfg = dict(img_size=32, inner_channels=32, num_res_blocks=1, channel_multipliers=[1, 2])
    kw = dict(img_size=16, in_channels=3, out_channels=3, num_timesteps=50, condition_type="concat",
              first_stage="ae/vq.f4", first_stage_config=fs_cfg, first_stage_scale_factor=1.0,
              unet_config=dict(LDM_UNET, in_channels=3, channel_multipliers=(1, 2), attention_downsample_rates=(2,)))
    jm = dezero(LDM(rngs=nnx.Rngs(0), **kw))
    tm = cflearn_torch.build(cflearn_torch.LDM, device="cpu", **kw)
    assert isinstance(tm.first_stage, TAutoEncoderVQ) and tm.first_stage.codebook.embedding.shape == (8192, 3)
    tm = bridged(jm, tm)
    x = np.random.RandomState(15).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    z_ref = jm.encode_first_stage(jnp.asarray(x))
    z = tm.encode_first_stage(_t(x))
    _check(z, z_ref)
    _check(tm.decode(z), jm.decode(z_ref))
    # the UNet on the q-sampled latents (codebook vectors alone sit near 0, where the GroupNorms amplify rounding)
    t, noise = np.array([37]), _rand(16, 1, 16, 16, 3)
    x_t = tm.q_sample(z, torch.from_numpy(t), _t(noise))
    _check(x_t, jm.q_sample(z_ref, jnp.asarray(t), jnp.asarray(noise)))
    _check(tm.denoise(x_t, torch.from_numpy(t)), jm.denoise(jnp.asarray(x_t.detach().numpy()), jnp.asarray(t)))
    with pytest.raises(ValueError, match="not 'meta'"):
        cflearn_torch.build(cflearn_torch.LDM, device="meta", **dict(kw, first_stage_config=dict(fs_cfg, pretrained=True)))


# ---- the jax.image.resize mirror ----

RESIZES = [((13, 17), (29, 9)), ((32, 32), (128, 128)), ((64, 48), (7, 31)), ((5, 5), (5, 11)), ((31, 20), (12, 45))]


@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("sizes", RESIZES, ids=lambda s: f"{s[0][0]}x{s[0][1]}_to_{s[1][0]}x{s[1][1]}")
def test_resize_matches_jax(sizes, method) -> None:
    """Nearest bit for bit. The linear and cubic weights are JAX's own
    (`compute_weight_mat`) to 1e-7; the resize is held to 1e-6 of max|ref|
    against the f64 product of those weights, and to 1e-6 plus JAX's own
    distance from that product against `jax.image.resize` (XLA's CPU einsum
    rounds a strong shrink's sums to a few 1e-6)."""
    from jax._src.image import scale as S

    (h, w), (oh, ow) = sizes
    x = _rand(16, 2, h, w, 3)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, oh, ow, 3), method))
    got = resize(_t(x), (oh, ow), method).numpy()
    if method == "nearest":
        np.testing.assert_array_equal(got, ref)
        return
    kernel = S._fill_triangle_kernel if method == "bilinear" else S._fill_keys_cubic_kernel
    exact = x.astype(np.float64)
    for axis, (m, n) in ((1, (h, oh)), (2, (w, ow))):
        if m == n:
            continue
        wj = np.asarray(S.compute_weight_mat(m, n, jnp.float32(n / m), jnp.float32(0.0), kernel, True))
        np.testing.assert_allclose(resize_weights(m, n, method), wj, atol=1e-7)
        exact = np.moveaxis(np.tensordot(exact, wj.astype(np.float64), axes=([axis], [0])), -1, axis)
    jax_drift = rel_err(ref, exact)
    assert rel_err(got, exact) < 1e-6
    assert rel_err(got, ref) < 1e-6 + jax_drift
    if method == "bilinear":  # the bilinear entry the API's crop helpers use
        np.testing.assert_array_equal(resize_bilinear(_t(x), oh, ow).numpy(), got)


def test_nearest_indices_are_jax_f32_arithmetic() -> None:
    for m, n in ((512, 64), (37, 23), (7, 300), (333, 111)):
        offsets = np.floor(((jnp.arange(n, dtype=jnp.float32) + 0.5) * m / n).astype(jnp.float32))
        np.testing.assert_array_equal(nearest_indices(m, n), np.asarray(offsets).astype(np.int64))


# ---- the zoo ----

PRESETS = {"ae/kl": ("f4", "f8", "f16"), "ae/vq": ("f4", "f8", "f4_no_attn"),
           "diffusion/ldm": ("vq", "sd", "sd_v2", "sd_v2_v", "sd_inpainting")}


@pytest.mark.parametrize("config", ["ae/kl", "ae/vq", "diffusion/ldm"] + [f"{k}.{t}" for k, ts in PRESETS.items() for t in ts])
def test_parse_config(config) -> None:
    assert tzoo.parse_config(config) == jzoo.parse_config(config)


def test_presets_are_the_port_own_copies() -> None:
    """The port reads its own JSON files, which hold the JAX package's presets byte for byte."""
    from pathlib import Path

    import cflearn_tpu.zoo.common as jcommon

    for rel in ("ae/kl.json", "ae/vq.json", "diffusion/ldm.json"):
        port = tzoo.CONFIGS_DIR / rel
        assert port.is_file() and "cflearn_torch" in port.parts
        assert port.read_bytes() == (Path(jcommon.CONFIGS_DIR) / rel).read_bytes()
        json.loads(port.read_text())
    with pytest.raises(ValueError, match="tag"):
        tzoo.parse_config("ae/vq.f32")
    with pytest.raises(ValueError, match="no zoo preset"):
        tzoo.parse_config("ae/none")


@pytest.mark.parametrize("name,count", [("ldm_inpainting", 440_465_313), ("ldm_semantic", 270_552_643),
                                           ("ldm_vq", 329_378_945)])
def test_full_width_parameter_counts(name, count) -> None:
    """The JAX constructors' counts at their defaults (first stage included,
    counted with `nnx.eval_shape`), the port's built on "meta"."""
    m = getattr(cflearn_torch, name)(device="meta")
    assert sum(p.numel() for p in m.parameters()) == count
    assert m.unet.in_channels == {"ldm_inpainting": 7, "ldm_semantic": 6, "ldm_vq": 3}[name]
    assert isinstance(m.first_stage, TAutoEncoderVQ)


@pytest.mark.parametrize("name", ["ae_kl_f4", "ae_kl_f8", "ae_kl_f16", "ae_vq_f4", "ae_vq_f4_no_attn", "ae_vq_f8"])
def test_ae_presets_bridge_one_to_one(name) -> None:
    """Each first-stage preset at full width: the bridge maps the JAX constructor's parameters (shapes only,
    `nnx.eval_shape`) one to one onto the port's (built on "meta")."""
    m = getattr(cflearn_torch, name)(device="meta")
    jm = nnx.eval_shape(lambda: getattr(jzoo, name)())
    assert len(map_names(flat_shapes(jm), m)) == len(list(m.parameters()))


TINY_FS = dict(img_size=64, inner_channels=32, num_res_blocks=1)
TINY_UNET = dict(start_channels=32, num_res_blocks=1, channel_multipliers=[1, 2], attention_downsample_rates=[2],
                 num_heads=4, use_spatial_transformer=False)
TINY = {
    "ldm_inpainting": dict(latent_size=16, first_stage_config=dict(TINY_FS, attention_type="none"),
                           unet_config=dict(TINY_UNET, resample_with_resblock=True)),
    "ldm_semantic": dict(latent_size=16, condition_config=dict(num_stages=2, in_channels=8, out_channels=3),
                         first_stage_config=TINY_FS, unet_config=TINY_UNET),
    "ldm_vq": dict(latent_size=16, latent_in_channels=6, condition_type="concat", first_stage_config=TINY_FS,
                   unet_config=dict(TINY_UNET, num_head_channels=16)),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_bridge_is_strict_both_ways(name) -> None:
    """Every JAX leaf has one port parameter of its shape and every port
    parameter one JAX leaf; a missing or an extra leaf raises."""
    jm = getattr(jzoo, name)(**TINY[name])
    tm = getattr(tzoo, name)(device="cpu", **TINY[name])
    flat = flat_params(jm)
    mapping = map_names({k: v.shape for k, v in flat.items()}, tm)
    assert len(mapping) == len(flat) == len(list(tm.parameters()))
    bridged(jm, tm)
    drop = sorted(flat)[len(flat) // 2]
    with pytest.raises(ValueError, match="no JAX leaf"):
        map_names({k: v.shape for k, v in flat.items() if k != drop}, tm)
    with pytest.raises(ValueError, match="no such port parameter"):
        map_names(dict({k: v.shape for k, v in flat.items()}, **{"extra.kernel": (3, 3)}), tm)


def test_pretrained_raises() -> None:
    """Pretrained weights load from the local cache onto a real device (`tests/test_torch_pretrained.py`):
    on "meta" every constructor refuses before it reads anything."""
    for fn in (tzoo.ldm_inpainting, tzoo.ldm_semantic, tzoo.ldm_vq, tzoo.ae_vq_f4, tzoo.ae_kl_f8):
        with pytest.raises(ValueError, match="not 'meta'"):
            fn(pretrained=True, device="meta")
