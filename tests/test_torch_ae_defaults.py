"""The autoencoder-training pieces of the JAX package's defaults against the
port, on the CPU at a tiny size: the VQ codebook and `AutoEncoderVQ`, LPIPS
(random weights, bridged, and loaded from local torch files), the multi-scale
discriminator, and the `core` loss with the perceptual term and the adaptive
adversarial weight, for `ae_kl` and `ae_vq`.

The JAX models are built without LPIPS and given a random one: with
`use_perceptual=True` the JAX model would try to download the pretrained
weights. All f32; each tolerance is stated where it is used."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import cflearn_torch
from _torch_bridge_common import empty_cache, flat_params, rel_err
from cflearn_torch.bridge import load_nnx_batch_stats, load_nnx_buffers, load_nnx_params, tree_from_nnx
from cflearn_torch.losses.lpips import LPIPS as TLPIPS
from cflearn_torch.losses.lpips import LPIPSLoss, load_lpips
from cflearn_torch.models.cv.ae import AEModel, AEVQModel
from cflearn_torch.modules.cv.ae import AutoEncoderVQ as TAutoEncoderVQ
from cflearn_torch.modules.cv.common import VQCodebook as TVQCodebook
from cflearn_torch.modules.cv.common import discriminators as t_discriminators
from cflearn_torch.modules.cv.common import generators as t_generators
from cflearn_torch.modules.cv.gan import MultiScaleDiscriminator as TMultiScale
from cflearn_torch.modules.layers import resize_bilinear
from cflearn_tpu.losses import lpips as JL
from cflearn_tpu.modules.cv.ae import AutoEncoderVQ as JAutoEncoderVQ
from cflearn_tpu.modules.cv.common import VQCodebook as JVQCodebook
from cflearn_tpu.modules.cv.gan import MultiScaleDiscriminator as JMultiScale
from cflearn_tpu.schema import DLConfig
from cflearn_tpu.schema.model import IDLModel

SIZE = 32
AE_CONFIG = dict(
    img_size=SIZE, in_channels=3, inner_channels=32, z_channels=4, embedding_channels=4,
    channel_multipliers=[1, 2], num_res_blocks=1,
)


@pytest.fixture(autouse=True)
def no_download(monkeypatch):
    """Nothing here may reach the network: the JAX package's downloader raises."""
    import cflearn_tpu.toolkit.misc as misc

    def refuse(*args, **kwargs):
        raise IOError("no downloads in the tests")

    monkeypatch.setattr(misc, "download", refuse)


def _variables(module: nnx.Module, kind) -> dict:
    return {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(nnx.state(module, kind))}


def _images(seed: int, size: int = SIZE, batch: int = 2) -> np.ndarray:
    return np.random.RandomState(seed).uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)


# ---------------------------------------------------------------- VQ


def test_vq_codebook_matches_jax() -> None:
    """Indices equal; z_q, both losses, and the gradients (the straight-through
    one to z, the codebook loss's to the codes) to f32 rounding: 1e-5."""
    jc = JVQCodebook(64, 4, rngs=nnx.Rngs(0))
    # codes of the inputs' scale, so that many codes are taken
    jc.embedding[...] = jnp.asarray(np.random.RandomState(1).randn(64, 4).astype(np.float32))
    tc = TVQCodebook(64, 4)
    load_nnx_params(tc, flat_params(jc))
    assert tc.embedding.shape == (64, 4) and torch.equal(tc.embedding.detach(), torch.from_numpy(np.asarray(jc.embedding[...])))
    z = np.random.RandomState(2).randn(2, 5, 7, 4).astype(np.float32)
    w = np.random.RandomState(3).randn(2, 5, 7, 4).astype(np.float32)
    ref = jc(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_()
    got = tc(zt)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    assert got.indices.shape == (2, 5, 7) and len(np.unique(got.indices.numpy())) > 20
    assert rel_err(got.z_q.detach().numpy(), ref.z_q) < 1e-6
    for name in ("codebook_loss", "commitment_loss"):
        assert abs(float(getattr(got, name)) - float(getattr(ref, name))) <= 1e-5 * float(getattr(ref, name)), name

    def f(z_, emb):
        c = JVQCodebook(64, 4, rngs=nnx.Rngs(0))
        c.embedding[...] = emb
        out = c(z_)
        return jnp.sum(out.z_q * jnp.asarray(w)) + out.codebook_loss + 0.25 * out.commitment_loss

    gz, ge = jax.grad(f, argnums=(0, 1))(jnp.asarray(z), jc.embedding[...])
    loss = (got.z_q * torch.from_numpy(w)).sum() + got.codebook_loss + 0.25 * got.commitment_loss
    tz, te = torch.autograd.grad(loss, [zt, tc.embedding])
    assert rel_err(tz.numpy(), gz) < 1e-5 and rel_err(te.numpy(), ge) < 1e-5
    # straight through: without the loss terms, z's gradient is w itself
    (only,) = torch.autograd.grad((tc(zt).z_q * torch.from_numpy(w)).sum(), zt)
    torch.testing.assert_close(only, torch.from_numpy(w))
    np.testing.assert_array_equal(tc.lookup(got.indices).detach().numpy(), np.asarray(jc.lookup(ref.indices)))


@pytest.fixture(scope="module")
def vq_pair():
    jm = JAutoEncoderVQ(**AE_CONFIG, num_code=32, rngs=nnx.Rngs(0))
    jm.codebook.embedding[...] = jnp.asarray(np.random.RandomState(4).randn(32, 4).astype(np.float32) * 0.3)
    tm = TAutoEncoderVQ(**AE_CONFIG, num_code=32)
    load_nnx_params(tm, flat_params(jm))
    return jm, tm.eval()


def test_autoencoder_vq_matches_jax(vq_pair) -> None:
    """encode (indices equal, z_q), decode and the forward's four outputs:
    f32 convs and norms in another order, 1e-5 of the largest value."""
    jm, tm = vq_pair
    assert t_generators.get("ae_vq") is TAutoEncoderVQ and t_generators.has("ae_kl")
    x = _images(5)
    ref = jm(jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        enc = tm.encode(torch.from_numpy(x))
    assert set(got) == set(ref) == {"predictions", "codebook_loss", "commitment_loss", "indices"}
    np.testing.assert_array_equal(got["indices"].numpy(), np.asarray(ref["indices"]))
    assert got["indices"].shape == (2, SIZE // 2, SIZE // 2) and len(np.unique(got["indices"].numpy())) > 3
    assert rel_err(got["predictions"].numpy(), ref["predictions"]) < 1e-5
    for name in ("codebook_loss", "commitment_loss"):
        assert rel_err(got[name].numpy(), ref[name]) < 1e-5, name
    assert rel_err(enc.z_q.numpy(), jm.encode(jnp.asarray(x)).z_q) < 1e-5
    assert tm.encoder.conv_out.out_channels == 4  # no double z
    with torch.no_grad():
        assert rel_err(tm.decode(enc.z_q, apply_tanh=True).numpy(), jm.decode(jm.encode(jnp.asarray(x)).z_q, apply_tanh=True)) < 1e-5


# ---------------------------------------------------------------- LPIPS


@pytest.fixture(scope="module")
def lpips_pair():
    jl = JL.LPIPS(rngs=nnx.Rngs(0))
    tl = TLPIPS()
    load_nnx_params(tl, flat_params(jl))
    load_nnx_buffers(tl, _variables(jl, nnx.Not(nnx.Param)))
    return jl, tl


@pytest.mark.parametrize("size", [32, 20], ids=["32px", "20px_resized"])
def test_lpips_and_its_gradient_match_jax(lpips_pair, size) -> None:
    """The distance per sample and its gradient to the first image. Below
    32px both sides upsample bilinearly first. f32 through 13 convs and back:
    1e-5 of the largest value (measured 6e-7 and 5e-6)."""
    jl, tl = lpips_pair
    assert sorted(dict(tl.named_buffers())) == ["scale", "shift"]
    x, y = _images(6, size), _images(7, size)
    ref = jl(jnp.asarray(x), jnp.asarray(y))
    ref_grad = jax.grad(lambda a: jnp.sum(jl(a, jnp.asarray(y))))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tl(xt, torch.from_numpy(y))
    (grad,) = torch.autograd.grad(got.sum(), xt)
    assert got.shape == (2,) and rel_err(got.detach().numpy(), ref) < 1e-5
    assert rel_err(grad.numpy(), ref_grad) < 1e-5


def test_lpips_runs_the_tower_in_f32_from_bf16(lpips_pair) -> None:
    """The JAX compute cast makes the weights bf16 and leaves `shift` /
    `scale` f32: a bf16 image minus `shift` is f32 and every conv promotes
    its bf16 weight to f32. The port does the same (F.conv2d would refuse an
    f32 input against a bf16 weight)."""
    _, tl = lpips_pair
    bf = TLPIPS()
    bf.load_state_dict(tl.state_dict())
    for p in bf.parameters():
        p.data = p.data.bfloat16()
    assert bf.shift.dtype == torch.float32
    x, y = torch.from_numpy(_images(8)).bfloat16(), torch.from_numpy(_images(9))
    out = bf(x, y)
    assert out.dtype == torch.float32
    # the same as the f32 tower on the bf16-rounded weights and image
    ref = TLPIPS()
    ref.load_state_dict({k: v.float() for k, v in bf.state_dict().items()})
    torch.testing.assert_close(out, ref(x.float(), y), rtol=1e-5, atol=1e-7)


def test_load_lpips_from_local_files_matches_jax(tmp_path, monkeypatch) -> None:
    """torchvision's VGG16 keys and both lin-head key forms, read natively:
    the same distances as the JAX package's `load_lpips` on the same files.
    Without the files, from an empty download cache, `pretrained=True`
    raises, naming the path where a file goes, and "auto" warns."""
    rng = np.random.RandomState(10)
    vgg = {}
    ch = 3
    for ti, co in zip(JL._VGG16_TORCH_CONV_IDS, [c for c in JL.VGG16Features.cfg if c != "M"]):
        vgg[f"features.{ti}.weight"] = torch.from_numpy(rng.randn(co, ch, 3, 3).astype(np.float32) * (2.0 / (9 * ch)) ** 0.5)
        vgg[f"features.{ti}.bias"] = torch.from_numpy(rng.randn(co).astype(np.float32) * 0.1)
        ch = co
    for i in range(31, 36):  # torchvision's classifier and other keys are ignored
        vgg[f"classifier.{i}.weight"] = torch.zeros(2)
    torch.save(vgg, tmp_path / "vgg16.pth")
    for form in ("mappings", "lin"):
        lins = {}
        for i, c in enumerate(TLPIPS.feature_channels):
            key = f"mappings.{i}.net.1.weight" if form == "mappings" else f"lin{i}.model.1.weight"
            lins[key] = torch.from_numpy(np.abs(rng.randn(1, c, 1, 1)).astype(np.float32) * 0.1)
        torch.save(lins, tmp_path / f"lpips_{form}.pt")
        jl = JL.load_lpips(str(tmp_path / f"lpips_{form}.pt"), str(tmp_path / "vgg16.pth"))
        tl = load_lpips(tmp_path / f"lpips_{form}.pt", tmp_path / "vgg16.pth")
        x, y = _images(11), _images(12)
        ref = jl(jnp.asarray(x), jnp.asarray(y))
        with torch.no_grad():
            got = tl(torch.from_numpy(x), torch.from_numpy(y))
        assert float(ref.min()) > 0 and rel_err(got.numpy(), ref) < 1e-5, form
    with empty_cache(tmp_path / "cache", monkeypatch) as folder:
        with pytest.raises(OSError, match=f"put the file at {folder / 'vgg16-397923af.pth'}"):
            load_lpips(pretrained=True)
        with pytest.raises(OSError):
            LPIPSLoss(pretrained=True)
        with pytest.warns(UserWarning, match="random weights"):
            auto = LPIPSLoss()
    assert isinstance(auto.net, TLPIPS)
    loss = LPIPSLoss(pretrained=True, lpips_ckpt=tmp_path / "lpips_lin.pt", vgg_ckpt=tmp_path / "vgg16.pth")
    with torch.no_grad():
        per = loss.net(torch.from_numpy(x), torch.from_numpy(y))
        assert float(loss(torch.from_numpy(x), torch.from_numpy(y))) == pytest.approx(float(per.mean()))
    assert torch.equal(loss.net.lins[0].weight, tl.lins[0].weight)


# ---------------------------------------------------------------- multi-scale discriminator


@pytest.mark.parametrize("hw", [(32, 32), (33, 47)], ids=["32x32", "33x47"])
def test_multi_scale_discriminator_matches_jax(hw) -> None:
    """Three PatchGANs on halved images (eval mode: the running statistics).
    The halving is `jax.image.resize` bilinear, which antialiases: 1e-6 of
    the largest value (f32 resampling sums); PyTorch's default bilinear
    (no antialias) misses by the image's own scale."""
    jm = JMultiScale(in_channels=3, num_scales=3, num_layers=2, start_channels=8, rngs=nnx.Rngs(1))
    tm = t_discriminators.build("multi_scale", in_channels=3, num_scales=3, num_layers=2, start_channels=8)
    assert isinstance(tm, TMultiScale)
    load_nnx_params(tm, flat_params(jm))
    jm.eval()
    tm.eval()
    x = np.random.RandomState(2).randn(2, *hw, 3).astype(np.float32)
    ref = jm(jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        assert rel_err(g.numpy(), r) < 1e-5
    h, w = hw[0] // 2, hw[1] // 2
    half = jax.image.resize(jnp.asarray(x), (2, h, w, 3), "bilinear")
    assert rel_err(resize_bilinear(torch.from_numpy(x), h, w).numpy(), half) < 1e-6
    plain = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(h, w), mode="bilinear")
    assert rel_err(plain.permute(0, 2, 3, 1).numpy(), half) > 0.1


# ---------------------------------------------------------------- the core loss at the JAX defaults


def _jax_model(name: str, config: dict):
    """The JAX model of `config`, built without LPIPS and given a random one."""
    jm = IDLModel.from_config(
        DLConfig(model=name, module_name=name, module_config=dict(config, use_perceptual=False), workspace="/nonexistent")
    )
    jm.perceptual = JL.LPIPS(rngs=nnx.Rngs(5))
    jm.set_mode(True)
    return jm


@pytest.mark.parametrize("name,adaptive", [("ae_kl", True), ("ae_kl", False), ("ae_vq", True)])
def test_core_loss_with_perceptual_and_adaptive_weight_matches_jax(name, adaptive) -> None:
    """`AEGeneratorStep.loss_fn` of the `core` scope with LPIPS, both scopes
    live (the adversarial term on), and the adaptive weight: every loss item
    (1e-5 relative) and every gradient of the trained parameters, against
    `nnx.value_and_grad` of the JAX step's loss. Per leaf 1e-3 of the leaf's
    largest gradient, floored at 1% of the largest of all (measured 2.9e-4:
    f32 sums in another order through the encoder, the decoder and the
    13-conv tower, whose gradient at the reconstruction the adaptive weight
    reads). The discriminator's BatchNorm statistics move once, in train mode."""
    extra = {"num_code": 32} if name == "ae_vq" else {}
    config = dict(AE_CONFIG, d_loss_start_step=0, use_adaptive_weight=adaptive, **extra)
    jm = _jax_model(name, config)
    if name == "ae_vq":
        # codes of the latents' scale: the default U(+-1/32) codes all but erase z, and a near-constant
        # reconstruction makes the discriminator's batch variance E[x^2] - E[x]^2 cancel in f32 (both
        # frameworks' gradients at the reconstruction then differ by 3% from each other)
        jm.m.codebook.embedding[...] = jnp.asarray(np.random.RandomState(3).randn(32, 4).astype(np.float32))
    params0, stats0 = flat_params(jm), _variables(jm, nnx.BatchStat)
    x = _images(13)
    jstep = jm.train_steps[0]
    jstep.step_actives = {"core": True, "discriminator": True}

    def loss_fn(m):
        fwd = m.m(jnp.asarray(x), sample=False) if name == "ae_kl" else m.m(jnp.asarray(x))
        losses = jstep.loss_fn(m, {"input": jnp.asarray(x)}, fwd)
        return losses["loss"], losses

    diff = nnx.DiffState(0, jm.params_filter("core"))
    (_, ref), grads = nnx.value_and_grad(loss_fn, argnums=diff, has_aux=True)(jm)
    stats1 = _variables(jm, nnx.BatchStat)
    with pytest.warns(UserWarning, match="LPIPS pretrained weights unavailable"):
        tm = (AEModel if name == "ae_kl" else AEVQModel)(dict(config, use_perceptual=True))
    load_nnx_params(tm, params0)
    load_nnx_batch_stats(tm, stats0)
    load_nnx_buffers(tm, {f"perceptual.{k}": v for k, v in _variables(jm.perceptual, nnx.Not(nnx.Param)).items()})
    tstep = tm.train_steps[0]
    tstep.step_actives = {"core": True, "discriminator": True}
    fwd = tm.run({"input": torch.from_numpy(x)}, training=True, **({"sample": False} if name == "ae_kl" else {}))
    got = tstep.loss_fn(tm, {"input": torch.from_numpy(x)}, fwd)
    assert set(got) == set(ref) == {"loss", "l1", "perceptual", "g", "kl" if name == "ae_kl" else "vq"}
    for key, value in ref.items():
        assert abs(float(got[key]) - float(value)) <= 1e-5 * abs(float(value)), key
    assert (tstep.adaptive_weight is not None) == adaptive
    named = tm.params_filter("core")
    values = torch.autograd.grad(got["loss"], [p for _, p in named])
    flat_grads = {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(grads)}
    want = tree_from_nnx(flat_grads, tm, [n for n, _ in named])
    assert set(want) == {n for n, _ in named} and not [n for n in want if n.startswith("perceptual.")]
    floor = 1e-2 * max(float(w.abs().max()) for w in want.values())
    for (n, _), g in zip(named, values):
        err = float((g - want[n]).abs().max()) / max(float(want[n].abs().max()), floor)
        assert err < 1e-3, (n, err)
    buffers = dict(tm.named_buffers())
    for key, value in stats1.items():
        assert rel_err(buffers[key].numpy(), value) < 1e-5, key
        assert rel_err(stats0[key], value) > 1e-4, key  # the step's own discriminator call moved them


def test_ae_vq_model_and_entry_point() -> None:
    """`build_ae(model="ae_vq")` through `train_autoencoder`: the `vq` item,
    the codebook moving, LPIPS frozen (its parameters are in no scope and
    bit for bit unchanged), indices of the forward within the codebook."""
    config = dict(AE_CONFIG, img_size=16, num_code=16, d_loss_start_step=0, use_adaptive_weight=True)
    with pytest.raises(ValueError, match="not one of"):
        cflearn_torch.build_ae(config, model="ae_gan", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        model = cflearn_torch.build_ae(config, model="ae_vq", device="cpu")
    assert isinstance(model, AEVQModel) and isinstance(model.m, TAutoEncoderVQ)
    codes = model.m.codebook.embedding.detach().clone()
    lpips = {n: p.detach().clone() for n, p in model.named_parameters() if n.startswith("perceptual.")}
    images = _images(14, 16)
    out = cflearn_torch.train_autoencoder(model, images, num_steps=2, device="cpu")
    names = {"core_loss", "core_l1", "core_perceptual", "core_vq", "core_g", "discriminator_loss", "discriminator_d"}
    for losses in out["losses"]:
        assert set(losses) == names and all(torch.isfinite(v) for v in losses.values())
    assert not torch.equal(model.m.codebook.embedding.detach(), codes)
    assert lpips and all(torch.equal(p.detach(), lpips[n]) for n, p in model.named_parameters() if n in lpips)
    assert float(out["steps"]["core"].train_step.adaptive_weight) >= 0.0
    with torch.no_grad():
        indices = model.run({"input": torch.from_numpy(images)})["indices"]
    assert int(indices.min()) >= 0 and int(indices.max()) < 16
