"""The port's CV building blocks and encoders against the JAX package's, on
the CPU at tiny sizes: the activation registry, the conv blocks of
`core/convs.py` (with `max_pool2d_with_indices` / `MaxUnpool2d`),
`core/high_level.py`, the mixers and `MixedStackedEncoder` of
`core/mixed_stacks.py`, the encoders ("vanilla" at 28 px, where XLA's SAME
padding of the 4x4 stride-2 convs turns asymmetric, "vanilla_1d", "vit",
"backbone" in each preset, "backbone_1d" over RepVGG-lite before and after
`switch_to_deploy` and over MixViT-lite), the image classifier "clf"
through `IDLModel.from_config` (a train step's loss and gradients), SIREN,
the bridge rules these modules add, and the ViT's attention routing.

Inputs come from numpy seeds; the JAX module's state (parameters, BatchNorm
statistics, fixed buffers) goes across through the bridge. f32 throughout:
the tolerances (relative to the reference's largest magnitude) cover
another summation order only, and are stated at each test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import cflearn_torch
import cflearn_tpu.models.common  # noqa: F401  (registers "common")
from _torch_bridge_common import rel_err
from _torch_cv_common import F32, both, fast_build, jax_state, jax_train_steps, jcall, pair, rand
from cflearn_torch.bridge import load_nnx_batch_stats, load_nnx_buffers, port_name, tree_from_nnx
from cflearn_torch.modules.core import activations as TA
from cflearn_torch.modules.core import convs as TC
from cflearn_torch.modules.core import high_level as TH
from cflearn_torch.modules.core import mixed_stacks as TMS
from cflearn_torch.modules.cv import classifier as TCl
from cflearn_torch.modules.cv import encoder as TE
from cflearn_torch.ops.attention import use_kernel
from cflearn_torch.optimizers import build_optimizer
from cflearn_torch.trainer import MultiScopeStep
from cflearn_tpu.modules.core import activations as JA
from cflearn_tpu.modules.core import convs as JC
from cflearn_tpu.modules.core import high_level as JH
from cflearn_tpu.modules.core import mixed_stacks as JMS
from cflearn_tpu.modules.cv import classifier as JCl
from cflearn_tpu.modules.cv import encoder as JE
from cflearn_tpu.schema import DLConfig as JDLConfig
from cflearn_tpu.schema.model import IDLModel as JIDLModel


# ---------------------------------------------------------------- activations


@pytest.mark.parametrize("name", sorted(set(JA.activations.all) - {"geglu"}))
def test_activation_registry_matches_jax(name) -> None:
    """Every registered activation but GEGLU (below), on values across
    (-4, 4) and near atanh's clip: 1e-6 relative (transcendentals of two
    libraries)."""
    x = np.concatenate([np.linspace(-4, 4, 40), [-0.9999999, 0.9999999, 0.5, -0.25]]).astype(np.float32)[None]
    kwargs = {"w": 30.0} if name == "sine" else {}
    ref = JA.build_activation(name, **kwargs)(jnp.asarray(x))
    got = TA.build_activation(name, **kwargs)(torch.from_numpy(x))
    assert got.shape == ref.shape
    assert rel_err(got.numpy(), ref) < 1e-6, name
    assert TA.build_activation(None)(torch.from_numpy(x)) is not None  # None is the identity, as in JAX


def test_geglu_and_registry_surface() -> None:
    jg = fast_build(lambda: JA.build_activation("geglu", in_dim=6, out_dim=4, rngs=nnx.Rngs(0)))
    tg = pair(jg, TA.build_activation("geglu", in_dim=6, out_dim=4))
    x = rand(1, 3, 6)
    got, ref = both(jg, tg, x)
    assert rel_err(got.numpy(), ref) < F32
    assert set(TA.activations.all) == set(JA.activations.all)
    assert isinstance(TA.build_activation("sine"), TA.Sine) and TA.build_activation("sine").w == 1.0


# ---------------------------------------------------------------- conv blocks


_CONV_BLOCKS = {
    # name: (JAX constructor, port constructor, input shape)
    "depthwise": (lambda r: JC.DepthWiseConv2d(6, rngs=r), lambda: TC.DepthWiseConv2d(6), (2, 7, 9, 6)),
    "interpolate_nearest": (lambda r: JC.Interpolate(2.0), lambda: TC.Interpolate(2.0), (2, 5, 6, 3)),
    "interpolate_bilinear": (lambda r: JC.Interpolate(0.5, "bilinear"), lambda: TC.Interpolate(0.5, "bilinear"), (2, 8, 10, 3)),
    "upsample_conv_bilinear": (
        lambda r: JC.UpsampleConv2d(4, 5, mode="bilinear", rngs=r), lambda: TC.UpsampleConv2d(4, 5, mode="bilinear"),
        (2, 5, 5, 4)),
    "se": (lambda r: JC.SEBlock(8, 3, rngs=r), lambda: TC.SEBlock(8, 3), (2, 5, 6, 8)),
    "eca": (lambda r: JC.ECABlock(5, rngs=r), lambda: TC.ECABlock(5), (2, 5, 6, 8)),
    "ca": (lambda r: JC.CABlock(16, 4, rngs=r), lambda: TC.CABlock(16, 4), (2, 5, 7, 16)),
    "res_down_sym": (
        lambda r: JC.ResDownsample(4, True, out_channels=6, rngs=r), lambda: TC.ResDownsample(4, True, out_channels=6),
        (2, 9, 8, 4)),
    "res_down_vae": (lambda r: JC.ResDownsample(4, True, padding=0, rngs=r), lambda: TC.ResDownsample(4, True, padding=0),
                     (2, 9, 8, 4)),
    "res_down_pool": (lambda r: JC.ResDownsample(4, False, rngs=r), lambda: TC.ResDownsample(4, False), (2, 9, 8, 4)),
    "res_up": (lambda r: JC.ResUpsample(4, True, out_channels=3, rngs=r), lambda: TC.ResUpsample(4, True, out_channels=3),
               (2, 4, 5, 4)),
    "res_up_plain": (lambda r: JC.ResUpsample(4, False, rngs=r), lambda: TC.ResUpsample(4, False), (2, 4, 5, 4)),
    "residual_v2": (lambda r: JC.ResidualBlockV2(8, 0.0, rngs=r), lambda: TC.ResidualBlockV2(8, 0.0), (2, 6, 6, 8)),
    "residual_v2_layer_norm": (
        lambda r: JC.ResidualBlockV2(8, 0.0, norm_type="layer_norm", rngs=r),
        lambda: TC.ResidualBlockV2(8, 0.0, norm_type="layer_norm"), (2, 6, 6, 8)),
}


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("case", sorted(_CONV_BLOCKS))
def test_conv_blocks_match_jax(case, training) -> None:
    """Each block of `core/convs.py` the slice adds, in eval and training
    mode (CABlock's and ResidualBlockV2's BatchNorms on batch statistics,
    their running statistics after the call too), on odd sizes: F32."""
    j_ctor, t_ctor, shape = _CONV_BLOCKS[case]
    jm = fast_build(lambda: j_ctor(nnx.Rngs(3)))
    tm = pair(jm, t_ctor())
    x = rand(4, *shape)
    got, ref = both(jm, tm, x, training=training)
    assert got.shape == ref.shape
    assert rel_err(got.numpy(), ref) < F32, case
    if training:
        stats = {k: v for k, v in jax_state(jm).items() if k.endswith(("mean", "var"))}
        buffers = {k.replace(".", "/"): v for k, v in tm.state_dict().items()}
        for k, v in stats.items():
            assert rel_err(buffers[k].numpy(), v) < 1e-6, k


def test_gaussian_blur_matches_jax() -> None:
    """`GaussianBlur3`: its fixed kernel (a buffer in the JAX layout) and
    the depthwise blur, SAME, constants kept: F32."""
    jm, tm = JC.GaussianBlur3(4), TC.GaussianBlur3(4)
    np.testing.assert_array_equal(tm.kernel.numpy(), np.asarray(jm.kernel[...]))
    got, ref = both(jm, tm, rand(4, 2, 6, 7, 4))
    assert rel_err(got.numpy(), ref) < F32
    assert torch.allclose(tm(torch.ones(1, 5, 5, 4))[:, 1:-1, 1:-1], torch.tensor(1.0))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_conv_nd_and_conv_blocks_lists(n) -> None:
    """`conv_nd` at rank n (stride 2, padding 1, the flax kernel layout
    through the bridge) and `get_conv_blocks` in both orders: F32."""
    jm = fast_build(lambda: JC.conv_nd(n, 3, 5, 3, stride=2, padding=1, rngs=nnx.Rngs(0)))
    tm = pair(jm, TC.conv_nd(n, 3, 5, 3, stride=2, padding=1))
    x = rand(5, 2, *([7] * n), 3)
    got, ref = both(jm, tm, x)
    assert got.shape == ref.shape and rel_err(got.numpy(), ref) < F32
    for pre in (False, True):
        jb = fast_build(lambda: JC.get_conv_blocks(4, 6, 3, 1, norm_type="batch_norm", activation="leaky_relu_0.2",
                                                   pre_activate=pre, rngs=nnx.Rngs(1)))
        tb = TC.get_conv_blocks(4, 6, 3, 1, norm_type="batch_norm", activation="leaky_relu_0.2", pre_activate=pre)
        assert [type(b).__name__ for b in tb] == (["BatchNorm", "Leaky_relu_0.2", "Conv2d"] if pre else
                                                 ["Conv2d", "BatchNorm", "Leaky_relu_0.2"])
        net_j, net_t = jnp.asarray(rand(6, 2, 5, 5, 4)), torch.from_numpy(rand(6, 2, 5, 5, 4))
        for j, t in zip(jb, tb):
            if list(t.parameters()):
                pair(j, t)
            net_j, net_t = j(net_j), t(net_t)
        assert rel_err(net_t.detach().numpy(), net_j) < F32


def test_max_pool_with_indices_and_unpool() -> None:
    """Distinct values: the same maxima and flat h * w indices as JAX, and
    `MaxUnpool2d` puts every maximum back where it came from (zeros
    elsewhere), at stride 2 and with overlapping windows (stride 1). With
    ties the port takes the first in row-major order, as JAX's strict `>`
    does on the CPU: a window of equal values points at its top-left pixel."""
    x = np.random.RandomState(7).permutation(2 * 6 * 8 * 3).astype(np.float32).reshape(2, 6, 8, 3)
    for k, s in ((2, None), (3, 1)):
        jv, ji = JC.max_pool2d_with_indices(jnp.asarray(x), k, s)
        tv, ti = TC.max_pool2d_with_indices(torch.from_numpy(x), k, s)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ti.dtype == torch.int32
        ref = JC.MaxUnpool2d(k, s)(jv, ji, (6, 8))
        got = TC.MaxUnpool2d(k, s)(tv, ti, (6, 8))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    kept = got.numpy() != 0
    np.testing.assert_array_equal(got.numpy()[kept], x[kept])
    ties = np.ones((1, 4, 4, 1), np.float32)
    jv, ji = JC.max_pool2d_with_indices(jnp.asarray(ties), 2)
    tv, ti = TC.max_pool2d_with_indices(torch.from_numpy(ties), 2)
    np.testing.assert_array_equal(ti.numpy()[0, ..., 0], [[0, 2], [8, 10]])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ---------------------------------------------------------------- high_level and the mixed stack


def test_high_level_blocks_match_jax() -> None:
    """`PreNorm`, `ChannelPadding` (global; a 2x2 map resized to the input;
    per class; 1-D), `VanillaPatchEmbed` and `OverlapPatchEmbed`: F32.
    A conditional `ChannelPadding` without labels raises on both sides."""
    x = rand(8, 2, 4, 4, 6)
    labels = np.array([2, 0], np.int32)
    cases = [
        (lambda r: JH.PreNorm(6, JA.build_activation("gelu"), rngs=r), lambda: TH.PreNorm(6, TA.build_activation("gelu")), (x,)),
        (lambda r: JH.ChannelPadding(6, 3, rngs=r), lambda: TH.ChannelPadding(6, 3), (x,)),
        (lambda r: JH.ChannelPadding(6, 3, 2, rngs=r), lambda: TH.ChannelPadding(6, 3, 2), (x,)),
        (lambda r: JH.ChannelPadding(6, 3, 4, num_classes=3, rngs=r), lambda: TH.ChannelPadding(6, 3, 4, num_classes=3),
         (x, labels)),
        (lambda r: JH.ChannelPadding(6, 3, is_1d=True, rngs=r), lambda: TH.ChannelPadding(6, 3, is_1d=True), (x[:, 0, 0],)),
        (lambda r: JH.VanillaPatchEmbed(8, 4, 3, 10, rngs=r), lambda: TH.VanillaPatchEmbed(8, 4, 3, 10),
         (rand(9, 2, 8, 8, 3),)),
        (lambda r: JH.OverlapPatchEmbed(9, 3, 2, 3, 10, rngs=r), lambda: TH.OverlapPatchEmbed(9, 3, 2, 3, 10),
         (rand(9, 2, 9, 9, 3),)),
    ]
    for j_ctor, t_ctor, args in cases:
        jm = fast_build(lambda: j_ctor(nnx.Rngs(2)))
        got, ref = both(jm, pair(jm, t_ctor()), *args)
        assert got.shape == ref.shape and rel_err(got.numpy(), ref) < F32, type(jm).__name__
    with pytest.raises(ValueError, match="labels"):
        TH.ChannelPadding(6, 3, num_classes=3)(torch.from_numpy(x))


@pytest.mark.parametrize("pooling", ["head_token", "mean", "tokens"])
def test_mixed_stacked_encoder_matches_jax(pooling) -> None:
    """Two attention blocks (6 heads over 4 x 12 = 48: head dim 8), with a
    head token and positional table, or mean-pooled, or every token; the
    "mix_ff" channel mixer in the last case: F32."""
    kw = dict(token_mixing_type="attention", token_mixing_config={"num_heads": 6}, num_layers=2)
    if pooling == "head_token":
        kw.update(use_head_token=True, use_positional_encoding=True)
    if pooling == "tokens":
        kw.update(head_pooler=None, channel_mixing_type="mix_ff")
    jm = fast_build(lambda: JMS.MixedStackedEncoder(12, 9, rngs=nnx.Rngs(4), **kw))
    tm = pair(jm, TMS.MixedStackedEncoder(12, 9, **kw))
    got, ref = both(jm, tm, rand(10, 2, 9, 12))
    assert got.shape == ref.shape and rel_err(got.numpy(), ref) < F32
    if pooling == "head_token":
        tokens, ref_tokens = both(jm, tm, rand(10, 2, 9, 12), return_tokens=True)
        assert tokens.shape == (2, 10, 12) and rel_err(tokens.numpy(), ref_tokens) < F32
    # the pipelined layout (`pp_block`: the blocks stacked on a leading axis) bridges and computes the same
    jm_pp = fast_build(
        lambda: JMS.MixedStackedEncoder(12, 9, rngs=nnx.Rngs(4), pipeline_parallel=True, **kw),
        constants=lambda path: np.zeros((), np.float32),  # the pipeline's objective, `pp_aux`
    )
    tm_pp = pair(jm_pp, TMS.MixedStackedEncoder(12, 9, pipeline_parallel=True, **kw))
    got, ref = both(jm_pp, tm_pp, rand(10, 2, 9, 12))
    assert got.shape == ref.shape and rel_err(got.numpy(), ref) < F32


def test_channel_mixers_match_jax() -> None:
    """The "ff" mixer with GELU and with GEGLU, "mix_ff", the positional
    table (added to fewer tokens than it holds) and the attention mixer: F32."""
    x = rand(11, 2, 7, 8)
    cases = [
        (lambda r: JMS.FeedForward(8, 16, rngs=r), lambda: TMS.FeedForward(8, 16)),
        (lambda r: JMS.FeedForward(8, 16, activation="geglu", rngs=r), lambda: TMS.FeedForward(8, 16, activation="geglu")),
        (lambda r: JMS.MixFeedForward(8, 16, rngs=r), lambda: TMS.MixFeedForward(8, 16)),
        (lambda r: JMS.PositionalEncoding(8, 9, rngs=r), lambda: TMS.PositionalEncoding(8, 9)),
        (lambda r: JMS.AttentionTokenMixer(8, 7, 16, num_heads=2, rngs=r), lambda: TMS.AttentionTokenMixer(8, 7, 16, num_heads=2)),
    ]
    for j_ctor, t_ctor in cases:
        jm = fast_build(lambda: j_ctor(nnx.Rngs(5)))
        got, ref = both(jm, pair(jm, t_ctor()), x)
        assert rel_err(got.numpy(), ref) < F32, type(jm).__name__
    # the registries hold what the JAX package's hold (the tabular slice added the rest of the mixers)
    assert set(TMS.token_mixers.all) == set(JMS.token_mixers.all)
    assert set(TMS.channel_mixers.all) == set(JMS.channel_mixers.all)


# ---------------------------------------------------------------- encoders


@pytest.mark.parametrize("training", [False, True])
def test_vanilla_encoders_at_28px(training) -> None:
    """"vanilla" with three 4x4 stride-2 convs at 28 px: 28 -> 14 -> 7 -> 4,
    the last padded (1, 2) by XLA's SAME, and "vanilla_1d" at 16 px, in eval
    and training mode: F32."""
    jm = fast_build(lambda: JE.VanillaEncoder(img_size=28, in_channels=1, latent_channels=16, num_downsample=3, rngs=nnx.Rngs(0)))
    tm = pair(jm, TE.VanillaEncoder(img_size=28, in_channels=1, latent_channels=16, num_downsample=3))
    got, ref = both(jm, tm, rand(12, 2, 28, 28, 1), training=training)
    assert got.shape == ref.shape == (2, 4, 4, 16)
    assert rel_err(got.numpy(), ref) < F32
    assert tm.blocks[4]._pads((7, 7), (4, 4), "SAME") == [(1, 2), (1, 2)]
    jm = fast_build(lambda: JE.VanillaEncoder1D(img_size=16, latent_dim=8, num_downsample=2, rngs=nnx.Rngs(1)))
    tm = pair(jm, TE.VanillaEncoder1D(img_size=16, latent_dim=8, num_downsample=2))
    got, ref = both(jm, tm, rand(13, 2, 16, 16, 3), training=training)
    assert got.shape == ref.shape == (2, 8) and rel_err(got.numpy(), ref) < F32


def test_vit_encoder_matches_jax() -> None:
    """"vit" at 16 px, 4 px patches, width 12, 3 heads (head dim 16: the
    mixer projects to 4 x 12), two layers: the head token's row and every
    token: F32."""
    kw = dict(img_size=16, patch_size=4, in_channels=3, latent_dim=12, num_layers=2, num_heads=3)
    jm = fast_build(lambda: JE.ViTEncoder(**kw, rngs=nnx.Rngs(2)))
    tm = pair(jm, TE.ViTEncoder(**kw))
    assert tm.encoder.blocks[0].token_mixer.net.head_dim == 16
    x = rand(14, 2, 16, 16, 3)
    got, ref = both(jm, tm, x)
    assert got.shape == (2, 12) and rel_err(got.numpy(), ref) < F32
    got, ref = both(jm, tm, x, return_tokens=True)
    assert got.shape == (2, 17, 12) and rel_err(got.numpy(), ref) < F32


@pytest.mark.parametrize("preset", ["simple", "vgg16", "mobilenet"])
def test_backbone_encoder_presets(preset) -> None:
    """"backbone" in each preset at 16 px (vgg16 cut to two stages), every
    stage's map in training mode (the MobileNet stages' BatchNorms on batch
    statistics): F32."""
    kw = dict(in_channels=3, latent_channels=64, num_stages=2 if preset == "vgg16" else 3)
    jm = fast_build(lambda: JE.BackboneEncoder(preset, **kw, rngs=nnx.Rngs(3)))
    tm = pair(jm, TE.BackboneEncoder(preset, **kw))
    assert tm.latent_channels == jm.latent_channels
    got, ref = both(jm, tm, rand(15, 2, 16, 16, 3), training=True, return_stages=True)
    assert len(got) == len(ref) == kw["num_stages"]
    for g, r in zip(got, ref):
        assert g.shape == r.shape and rel_err(g.numpy(), r) < F32


def test_rep_vgg_backbone_before_and_after_deploy() -> None:
    """"backbone_1d" over RepVGG-lite at 32 px with running statistics away
    from (0, 1): the three-branch form in eval mode against JAX (F32); then
    the port's `switch_to_deploy`: only fused convs (and the squeeze-excites)
    left, the output the three-branch one (the fusion is exact up to
    rounding: 1e-4 across 21 blocks). The JAX fusion itself, bridged into a
    deployed port block, is held in `test_bridge_rules_of_the_cv_modules`."""
    jm = fast_build(lambda: JE.BackboneEncoder1D("rep_vgg_lite", rngs=nnx.Rngs(4)))
    tm = pair(jm, TE.BackboneEncoder1D("rep_vgg_lite"))
    assert tm.latent_dim == jm.latent_dim == 1280
    x = rand(16, 2, 32, 32, 3)
    got, ref = both(jm, tm, x)
    assert got.shape == (2, 1280) and rel_err(got.numpy(), ref) < F32
    tm.net.core.switch_to_deploy()
    assert all(".conv_fused." in k or ".post_se." in k for k in tm.state_dict())
    with torch.no_grad():
        fused = tm(torch.from_numpy(x))
    assert rel_err(fused.numpy(), ref) < 1e-4


def test_mix_vit_backbone_matches_jax() -> None:
    """"backbone_1d" over MixViT-lite at 32 px (overlapping patches at
    stride 4 then 2, spatial-reduction attention by 8, 4, 2, 1), and
    `Backbone`'s stage outputs: F32."""
    jm = fast_build(lambda: JE.BackboneEncoder1D("mix_vit_lite", rngs=nnx.Rngs(6)))
    tm = pair(jm, TE.BackboneEncoder1D("mix_vit_lite"))
    x = rand(17, 2, 32, 32, 3)
    got, ref = both(jm, tm, x)
    assert got.shape == (2, 256) and rel_err(got.numpy(), ref) < F32
    stages, ref_stages = both(jm.net, tm.net, x)
    assert set(stages) == set(ref_stages) == {"stage1", "stage2", "stage3", "stage4", "latent"}
    for k in stages:
        assert rel_err(stages[k].numpy(), ref_stages[k]) < F32, k
    with pytest.raises(ValueError, match="not recognized"):
        TE.Backbone("nope")


# ---------------------------------------------------------------- "clf", SIREN


def _clf_step(module_config: dict):
    """One "clf" train step ("cross_entropy") through the JAX model's loss
    and `nnx.grad`, and through the port's `MultiScopeStep`."""
    config = dict(model="common", module_name="clf", module_config=module_config, loss_name="cross_entropy")
    jm = fast_build(lambda: JIDLModel.from_config(JDLConfig(**config)))
    tm = cflearn_torch.IDLModel.from_config(cflearn_torch.DLConfig(**config), device="cpu")
    assert tm.num_params == jm.num_params
    tm.load_state_dict(jm.state_dict())
    size, c = module_config["img_size"], module_config["in_channels"]
    x = rand(18, 3, size, size, c)
    y = np.array([[0], [2], [1]], np.int64)
    (losses, flat), = jax_train_steps(jm, {"input": x, "labels": y}, 0.1).values()
    step = MultiScopeStep(tm, {"all": build_optimizer("sgd", 0.1)})
    got = step.step({"input": torch.from_numpy(x), "labels": torch.from_numpy(y)})
    return losses["loss"], float(got["loss"]), tree_from_nnx(flat, tm), step.steps["all"].grads


@pytest.mark.parametrize("encoder", ["vanilla_1d", "vit"])
def test_clf_from_config_train_step_matches_jax(encoder) -> None:
    """"clf" built by `IDLModel.from_config` (the JAX parameter count), its
    JAX state through the bridge, one train step: the loss (1e-5) and every
    gradient leaf within 1e-4 of the largest gradient of the model."""
    module_config = dict(img_size=16, in_channels=3, num_classes=3, encoder=encoder, latent_dim=12)
    if encoder == "vit":
        module_config["encoder_config"] = dict(patch_size=4, num_layers=2, num_heads=3)
    ref_loss, loss, ref_grads, grads = _clf_step(module_config)
    assert abs(loss - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    scale = max(g.abs().max().item() for g in ref_grads.values())
    assert set(grads) == set(ref_grads)
    for name, ref in ref_grads.items():
        assert (grads[name] - ref).abs().max().item() <= 1e-4 * scale, name


def test_clf_with_backbone_encoders_raises_as_in_jax() -> None:
    """Inside the reference: `ImageClassifier` passes `img_size` to every
    encoder, which "backbone" does not take, and a "backbone_1d" config's
    preset `name` collides with the registry's own argument. Neither side
    builds such a classifier; the encoders alone are held above."""
    for encoder, config in (("backbone", {}), ("backbone_1d", {"name": "rep_vgg_lite"})):
        kw = dict(img_size=16, in_channels=3, num_classes=3, encoder=encoder, encoder_config=config)
        with pytest.raises(TypeError):
            JCl.ImageClassifier(**kw, rngs=nnx.Rngs(0))
        with pytest.raises(TypeError):
            TCl.ImageClassifier(**kw)


def test_siren_matches_jax() -> None:
    """`ImgSiren` on its own 8 x 8 grid (linspace in two libraries: 1e-5),
    `to_image`, `Siren` on given coordinates, `make_grid`,
    `img_siren_head`."""
    jm = fast_build(lambda: JCl.ImgSiren(img_size=8, latent_dim=16, num_layers=3, rngs=nnx.Rngs(7)))
    tm = pair(jm, TCl.ImgSiren(img_size=8, latent_dim=16, num_layers=3))
    ref = jm()
    with torch.no_grad():
        got = tm()
    assert got.shape == (1, 64, 3) and rel_err(got.numpy(), ref) < 1e-5
    assert rel_err(tm.to_image(got).numpy(), jm.to_image(ref)) < 1e-5
    js = fast_build(lambda: JCl.Siren(in_dim=3, out_dim=2, latent_dim=8, num_layers=2, rngs=nnx.Rngs(8)))
    ts = pair(js, TCl.Siren(in_dim=3, out_dim=2, latent_dim=8, num_layers=2))
    coords = np.asarray(JCl.make_grid(4, 3))
    assert rel_err(TCl.make_grid(4, 3).numpy(), coords) < 1e-7
    got, ref = both(js, ts, coords)
    assert rel_err(got.numpy(), ref) < 1e-5
    head = TCl.img_siren_head(4, 2)(torch.zeros(1, 16, 2))
    assert head.shape == (1, 4, 4, 2)


# ---------------------------------------------------------------- the bridge and the routing


def _rule_embedding() -> None:
    """`nnx.Embed.embedding` -> `weight`: the same lookups."""
    assert port_name("m.label_embed.embedding", 2) == ("m.label_embed.weight", None)
    jm = fast_build(lambda: nnx.Embed(5, 4, rngs=nnx.Rngs(0)))
    tm = pair(jm, cflearn_torch.modules.layers.Embed(5, 4))
    idx = np.array([3, 0, 4])
    np.testing.assert_array_equal(tm(torch.from_numpy(idx)).detach().numpy(), np.asarray(jcall(jm, idx)))


def _rule_top_level_params() -> None:
    """A ViT's `head_token` and the positional table's `pos_encoding` keep their JAX names and layouts;
    a 1-D conv's kernel (k, in, out) turns to (out, in, k)."""
    assert port_name("encoder.head_token", 3) == ("encoder.head_token", None)
    assert port_name("encoder.pos_encoding.pos_encoding", 3) == ("encoder.pos_encoding.pos_encoding", None)
    assert port_name("conv.kernel", 3) == ("conv.weight", (2, 1, 0))
    kw = dict(img_size=8, patch_size=4, latent_dim=8, num_layers=1, num_heads=2)
    jm = fast_build(lambda: JE.ViTEncoder(**kw, rngs=nnx.Rngs(1)))
    tm = pair(jm, TE.ViTEncoder(**kw))
    np.testing.assert_array_equal(tm.encoder.head_token.detach().numpy(), np.asarray(jm.encoder.head_token[...]))
    np.testing.assert_array_equal(tm.encoder.pos_encoding.pos_encoding.detach().numpy(),
                                  np.asarray(jm.encoder.pos_encoding.pos_encoding[...]))


def _rule_mask_variables() -> None:
    """`nnx.Variable` leaves (PixelCNN's masks, `GaussianBlur3`'s kernel) go to the buffers of the same
    paths in the JAX layout, by `load_nnx_buffers`, which refuses a leaf without a buffer of its shape."""
    tm = TCl.PixelCNN(num_codes=2, img_size=4, latent_channels=4, num_layers=2, channel_padding=None)
    variables = {}
    for i, kind in enumerate("AB"):  # the masks of PixelCNN's first ("A") and later ("B") layers
        jm = JCl._MaskedConv(1, 1, kind, rngs=nnx.Rngs(1))
        (path, mask), = [(p, v) for p, v in nnx.to_flat_state(nnx.state(jm)) if type(v) is nnx.Variable]
        assert path == ("mask",)
        variables[f"convs.{i}.mask"] = np.asarray(mask[...])
    for k in variables:
        dict(tm.named_buffers())[k].zero_()
    load_nnx_buffers(tm, variables)
    np.testing.assert_array_equal(tm.convs[0].mask.numpy(), variables["convs.0.mask"])
    np.testing.assert_array_equal(tm.convs[1].mask.numpy(), variables["convs.1.mask"])
    assert float(tm.convs[0].mask.sum()) == 24 and float(tm.convs[1].mask.sum()) == 25
    with pytest.raises(ValueError, match="without a buffer"):
        load_nnx_buffers(tm, {"convs.0.mask": np.zeros((3, 3, 1, 1), np.float32)})
    blur = JC.GaussianBlur3(3)
    tb = TC.GaussianBlur3(3)
    tb.kernel.zero_()
    load_nnx_buffers(tb, {"kernel": np.asarray(blur.kernel[...])})
    np.testing.assert_array_equal(tb.kernel.numpy(), np.asarray(blur.kernel[...]))


def _rule_batch_stats() -> None:
    """BatchNorm's running statistics by `load_nnx_batch_stats`, strict over the module's BatchNorms."""
    jm = fast_build(lambda: JE.VanillaEncoder(img_size=8, latent_channels=16, num_downsample=2, rngs=nnx.Rngs(2)))
    tm = TE.VanillaEncoder(img_size=8, latent_channels=16, num_downsample=2)
    stats = {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(nnx.state(jm, nnx.BatchStat))}
    assert set(stats) == {"blocks.1.mean", "blocks.1.var", "blocks.3.mean", "blocks.3.var"}
    load_nnx_batch_stats(tm, stats)
    np.testing.assert_array_equal(tm.blocks[3].var.numpy(), stats["blocks.3.var"])
    with pytest.raises(ValueError, match="differ"):
        load_nnx_batch_stats(tm, {k: v for k, v in stats.items() if k != "blocks.3.var"})


def _rule_fused_rep_vgg() -> None:
    """A RepVGG block after `switch_to_deploy` holds its fused conv (and squeeze-excite) alone: the JAX
    block's fusion goes into a deployed port block strictly, and matches the port's own fusion (1e-6 of
    each tensor) and output (F32)."""
    jm = fast_build(lambda: JE.RepVGGBlock(6, 6, rngs=nnx.Rngs(2)))  # with its identity branch
    tm = pair(jm, TE.RepVGGBlock(6, 6))
    jm.switch_to_deploy()
    deployed = TE.RepVGGBlock(6, 6)
    deployed.switch_to_deploy()
    pair(jm, deployed)
    tm.switch_to_deploy()
    for name, value in tm.state_dict().items():
        assert rel_err(value.numpy(), deployed.state_dict()[name].numpy()) < 1e-6, name
    got, ref = both(jm, deployed, rand(3, 2, 5, 5, 6))
    assert rel_err(got.numpy(), ref) < F32


_BRIDGE_RULES = {"embedding": _rule_embedding, "top_level_params": _rule_top_level_params,
                 "mask_variables": _rule_mask_variables, "batch_stats": _rule_batch_stats,
                 "fused_rep_vgg": _rule_fused_rep_vgg}


@pytest.mark.parametrize("rule", sorted(_BRIDGE_RULES))
def test_bridge_rules_of_the_cv_modules(rule) -> None:
    """One case a bridge rule the CV modules add (each case's docstring says which)."""
    _BRIDGE_RULES[rule]()


@pytest.mark.parametrize("img_size, routed", [(224, False), (384, True)])
def test_vit_s16_attention_routing(img_size, routed) -> None:
    """ViT-S/16 ("clf" with `encoder="vit"`, latent 384, 6 heads of 256):
    197 tokens at 224 px stay on the library path (kv < 256), 577 at 384 px
    go to the flash kernel. Shapes only, on "meta"."""
    config = cflearn_torch.DLConfig(model="common", module_name="clf", loss_name="cross_entropy", module_config=dict(
        img_size=img_size, in_channels=3, num_classes=1000, encoder="vit", latent_dim=384))
    model = cflearn_torch.IDLModel.from_config(config, device="meta")
    attn = model.m.encoder.encoder.blocks[0].token_mixer.net
    tokens = (img_size // 16) ** 2 + 1
    q = torch.empty(64, attn.num_heads, tokens, attn.head_dim, device="meta")
    assert (attn.num_heads, attn.head_dim, len(model.m.encoder.encoder.blocks)) == (6, 256, 12)
    assert use_kernel(q, q) is routed


def test_vit_head_dim_mirrors_the_jax_package() -> None:
    """Inside the reference: the JAX package's attention mixer hands
    `Attention` embed_dim = the stack's latent width (4 x in_dim), so
    ViT-S/16's six heads are 4 x 384 / 6 = 256 wide and its q / k / v
    projection maps 384 -> 3 x 1536; carefree-learn's mixer leaves the
    embedding at the input width (six heads of 64). The port mirrors the
    JAX package."""
    jm = nnx.eval_shape(lambda: JMS.AttentionTokenMixer(384, 577, 1536, num_heads=6, rngs=nnx.Rngs(0)))
    tm = TMS.AttentionTokenMixer(384, 577, 1536, num_heads=6)
    assert jm.net.head_dim == tm.net.head_dim == 256
    assert tuple(jm.net.in_proj.kernel.get_value().shape) == (384, 4608)
    assert tuple(tm.net.in_proj.weight.shape) == (4608, 384) and tuple(tm.net.out_proj.weight.shape) == (384, 1536)


def test_build_module_initialises_buffers() -> None:
    """`build_module` constructs on "meta" and materialises with `to_empty`,
    which leaves buffers uninitialised: every module with a buffer resets
    it (`reset_buffers`, run by `init_parameters`). BatchNorm's running
    statistics come out (0, 1), PixelCNN's masks and `GaussianBlur3`'s
    kernel as constructed, `DecayedAttention`'s bias as computed."""
    from cflearn_torch.modules.common import build_module
    from cflearn_torch.modules.core.attentions import DecayedAttention, np_decay_log_bias

    vae = build_module("vae", config={"img_size": 16, "latent_dim": 8, "num_downsample": 2}, device="cpu")
    stats = [b for n, b in vae.named_buffers() if n.endswith((".mean", ".var"))]
    assert stats and all(torch.equal(b, torch.zeros_like(b) if i % 2 == 0 else torch.ones_like(b))
                         for i, b in enumerate(stats))
    cnn = build_module("pixel_cnn", config={"num_codes": 4, "img_size": 4, "latent_channels": 8, "num_layers": 2},
                       device="cpu")
    assert torch.equal(cnn.convs[1].mask, TCl.PixelCNN(num_codes=4, img_size=4, latent_channels=8, num_layers=2).convs[1].mask)
    blur = build_module(TC.GaussianBlur3, config={"in_channels": 2}, device="cpu")
    assert torch.equal(blur.kernel, TC.GaussianBlur3(2).kernel)
    attn = build_module(DecayedAttention, config={"input_dim": 8, "num_heads": 2, "seq_len": 5}, device="cpu")
    np.testing.assert_array_equal(attn.decay_bias.numpy(), np_decay_log_bias(5, 2))


def test_encoder_decoder_and_latent_resolution() -> None:
    """`EncoderDecoder` builds both halves by name with the JAX parameter
    shapes (on "meta" against `nnx.eval_shape`); `get_latent_resolution`
    reads the size of an encoder's `encode` on an image of the given size:
    4 for three 4x4 stride-2 convs at 28 px, as JAX's abstract trace."""
    from cflearn_torch.bridge import map_names
    from cflearn_torch.modules.cv import common as TCC
    from cflearn_tpu.modules.cv import common as JCC

    kw = dict(encoder_config={"latent_channels": 16, "num_downsample": 3, "in_channels": 1},
              decoder_config={"latent_channels": 16, "num_upsample": 3, "out_channels": 1})
    jm = nnx.eval_shape(lambda: JCC.EncoderDecoder(**kw, rngs=nnx.Rngs(0)))
    with torch.device("meta"):
        tm = TCC.EncoderDecoder(**kw)
    shapes = {".".join(map(str, p)): tuple(v.get_value().shape) for p, v in nnx.to_flat_state(nnx.state(jm, nnx.Param))}
    assert len(map_names(shapes, tm)) == len(list(tm.parameters()))

    class JEnc(JCC.IEncoder):
        def __init__(self):
            self.in_channels = 1
            self.net = JE.VanillaEncoder(in_channels=1, latent_channels=16, num_downsample=3, rngs=nnx.Rngs(0))

        def __call__(self, x):
            return self.net(x)

    class TEnc(TCC.IEncoder):
        def __init__(self):
            super().__init__()
            self.in_channels = 1
            self.net = TE.VanillaEncoder(in_channels=1, latent_channels=16, num_downsample=3)

        def forward(self, x):
            return self.net(x)

    jenc = fast_build(JEnc)
    jenc.eval()  # JAX traces it abstractly, where a BatchNorm in training mode may not update its statistics
    assert TCC.get_latent_resolution(TEnc().train(), 28) == JCC.get_latent_resolution(jenc, 28) == 4
