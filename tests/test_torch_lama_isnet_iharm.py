"""The port's LaMa, ISNet and iharm nets against the JAX package's, on the
CPU, built small: each net carried across by the bridge (its batch
statistics too) and run on the same seeded input; each loaded from a seeded
state dict in the upstream layout through the zoo's converter against the
JAX package's `convert_*` into its own net, through the APIs (`inpaint`,
`segment`, `run`); the strict load refusing a missing and an extra key; and
the transposed convolutions' bridge both ways.

Tolerances: a net's f32 output and `segment`'s map, 1e-4 x max|JAX|
(`_torch_annotator_common.TOL`: summation order through up to 60 layers and
LaMa's FFTs); `inpaint`'s composite likewise; `run`'s uint8 image, one
level on at most 0.1% of the values (a value near a level truncates to
either side); the conv-transpose bridge bit for bit on the weights and
1e-5 x max|JAX| on the outputs."""

import numpy as np
import pytest
import torch
from flax import nnx

from _torch_annotator_common import TOL, as_numpy, image, npd, port, rel, save, uint8_close
from _torch_cv_common import fast_build
from cflearn_torch import bridge as B
from cflearn_torch.api.cv import third_party as TP
from cflearn_torch.api.cv.third_party import iharm as TI
from cflearn_tpu.api.cv import third_party as JP
from cflearn_tpu.api.cv.third_party import iharm as JI
from cflearn_tpu.api.cv.third_party import lama as JL
from cflearn_tpu.toolkit.tree import npd_to_tree

LAMA = dict(ngf=8, n_blocks=2)
ISNET = dict(scale=16)
IHARM = dict(width=4, ocr_width=8, ch=8, depth=7, small=True)  # `small`: HRNet's shallower stages

# one jitted forward: a copy of a net (the same graph) reuses its program
_FORWARD = nnx.jit(lambda m, *xs: m(*xs))


def jax_api(cls, jn, convert, sd, **attrs):
    """The JAX API `cls` as its constructor leaves it given a checkpoint:
    `convert(sd)` loaded into its net (here a copy of `jn`, which costs no
    new build) by `nnx.update` over `npd_to_tree(..., strict=False)`; the
    net called through `_FORWARD`."""
    net = nnx.clone(jn)
    nnx.update(net, npd_to_tree(convert(sd), nnx.state(net), strict=False))
    api = object.__new__(cls)
    api.m = lambda *xs: _FORWARD(net, *xs)
    for k, v in attrs.items():
        setattr(api, k, v)
    return api


def _run(net, *arrays):
    with torch.no_grad():
        out = net(*(torch.from_numpy(a) for a in arrays))
    return [o.numpy() for o in out] if isinstance(out, list) else out.numpy()


def _upstream(shapes, seed):
    """Seeded values for an upstream-layout state dict of `shapes`: BatchNorm
    scales and variances in [0.5, 1.5), the rest N(0, 0.1^2)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, shape in shapes.items():
        if k.endswith("running_var") or (k.endswith(".weight") and len(shape) == 1):
            sd[k] = rng.rand(*shape).astype(np.float32) + 0.5
        else:
            sd[k] = (rng.randn(*shape) * 0.1).astype(np.float32)
    return sd


def _lama_upstream(params):
    """The shapes of big-lama's `generator.model.{i}` state dict for the JAX
    net of `params` (the layout `convert_lama` reads), seeded."""
    shapes = {}

    def conv(prefix, ours, bias=False):
        kh, kw, i, o = params[f"{ours}/kernel/value"].shape
        shapes[f"{prefix}.weight"] = (o, i, kh, kw)
        if bias:
            shapes[f"{prefix}.bias"] = (o,)

    def bn(prefix, ours):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.{leaf}"] = params[f"{ours}/scale/value"].shape

    def ffc(prefix, ours):
        for name in ("convl2l", "convl2g", "convg2l"):
            if f"{ours}/ffc/{name}/kernel/value" in params:
                conv(f"{prefix}.ffc.{name}", f"{ours}/ffc/{name}")
        if f"{ours}/ffc/convg2g/conv1/kernel/value" in params:
            st, so = f"{prefix}.ffc.convg2g", f"{ours}/ffc/convg2g"
            conv(f"{st}.conv1.0", f"{so}/conv1")
            bn(f"{st}.conv1.1", f"{so}/bn1")
            conv(f"{st}.fu.conv_layer", f"{so}/fu/conv")
            bn(f"{st}.fu.bn", f"{so}/fu/bn")
            conv(f"{st}.conv2", f"{so}/conv2")
        for side in ("bn_l", "bn_g"):
            if f"{ours}/{side}/scale/value" in params:
                bn(f"{prefix}.{side}", f"{ours}/{side}")

    ffc("model.1", "stem")
    for i in range(3):
        ffc(f"model.{2 + i}", f"downs/{i}")
    n = LAMA["n_blocks"]
    for bi in range(n):
        for c in ("conv1", "conv2"):
            ffc(f"model.{5 + bi}.{c}", f"blocks/{bi}/{c}")
    base = 5 + n + 1
    for i in range(3):
        kh, kw, ci, co = params[f"ups/{i}/conv/kernel/value"].shape
        shapes[f"model.{base + 3 * i}.weight"] = (ci, co, kh, kw)
        shapes[f"model.{base + 3 * i}.bias"] = (co,)
        bn(f"model.{base + 3 * i + 1}", f"ups/{i}/bn")
    conv(f"model.{base + 10}", "head", bias=True)
    return {f"generator.{k}": v for k, v in _upstream(shapes, 40).items()}


def _native_upstream(net, seed):
    """A seeded state dict in the upstream layout of a port net that keeps
    upstream's names (ISNet, iharm), without `num_batches_tracked`."""
    return _upstream({k: tuple(v.shape) for k, v in net.state_dict().items()
                      if not k.endswith("num_batches_tracked")}, seed)


@pytest.fixture(scope="module")
def lama():
    jn = fast_build(lambda: JP.LaMaGenerator(rngs=nnx.Rngs(0), **LAMA), seed=30)
    params = npd(jn, batch_stats=True)
    return jn, params, port(lambda: TP.LaMaGenerator(**LAMA), B.lama_state_dict(params))


@pytest.fixture(scope="module")
def isnet():
    jn = fast_build(lambda: JP.ISNetDIS(rngs=nnx.Rngs(0), **ISNET), seed=31)
    params = npd(jn, batch_stats=True)
    return jn, params, port(lambda: TP.ISNetDIS(**ISNET), B.isnet_state_dict(params))


@pytest.fixture(scope="module")
def iharm():
    jn = fast_build(lambda: JP.HRNetIHModel(rngs=nnx.Rngs(0), **IHARM), seed=32)
    params = npd(jn, batch_stats=True)
    return jn, params, port(lambda: TP.HRNetIHModel(**IHARM), B.iharm_state_dict(params))


def test_lama_matches_jax(lama) -> None:
    jn, params, tn = lama
    assert (tn.blocks[0].conv1.ffc.in_g, tn.blocks[0].conv1.ffc.in_l) == (48, 16)  # int(64 * 0.75) global
    rng = np.random.RandomState(33)
    img = rng.rand(1, 40, 48, 3).astype(np.float32)
    mask = (rng.rand(1, 40, 48, 1) > 0.6).astype(np.float32)
    ref = np.asarray(_FORWARD(jn, img, mask))
    got = _run(tn, img, mask)
    assert got.shape == ref.shape == (1, 40, 48, 3) and rel(got, ref) < TOL


def test_isnet_matches_jax(isnet) -> None:
    jn, params, tn = isnet
    assert set(JP.convert_isnet(as_numpy(tn.state_dict()))) == set(params)
    # 72 -> 36, 18, 9, 5, 3, 2: ceil pools on odd sides; `segment`'s shape below, which reuses the JAX program
    x = np.random.RandomState(34).uniform(-0.5, 0.5, (1, 72, 72, 3)).astype(np.float32)
    ref = [np.asarray(r) for r in _FORWARD(jn, x)]
    got = _run(tn, x)
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (1, 72, 72, 1) and rel(g, r) < TOL


def test_iharm_matches_jax(iharm) -> None:
    jn, params, tn = iharm
    back = JI.convert_iharm(as_numpy(tn.state_dict()))
    assert set(back) == set(params) and all(np.array_equal(back[k], params[k]) for k in params)
    rng = np.random.RandomState(35)
    # the encoder's 7 halvings need 256 or more; `run`'s padded shape below, which reuses the JAX program
    x = rng.randn(1, 384, 256, 3).astype(np.float32)
    mask = np.zeros((1, 384, 256, 1), np.float32)
    mask[:, 60:300, 50:180] = 1.0
    ref = np.asarray(_FORWARD(jn, x, mask))
    got = _run(tn, x, mask)
    assert got.shape == ref.shape == (1, 384, 256, 3) and rel(got, ref) < TOL


def test_lama_converter_and_inpaint_match_jax(lama, tmp_path) -> None:
    jn, params, _ = lama
    sd = _lama_upstream(params)
    assert set(JL.convert_lama(sd)) == set(params)
    ckpt = save(tmp_path, "big-lama.pth", sd)
    japi = jax_api(JL.LaMaAPI, jn, JL.convert_lama, sd)
    tapi = TP.LaMaAPI(ckpt, device="cpu", **LAMA)
    rng = np.random.RandomState(36)
    img = (rng.rand(43, 50, 3) * 255).astype(np.uint8)  # padded to 48 x 56
    mask = np.zeros((43, 50), np.uint8)
    mask[10:25, 12:40] = 255
    ref, got = japi.inpaint(img, mask), tapi.inpaint(img, mask)
    assert got.shape == ref.shape == (43, 50, 3) and rel(got, ref) < TOL
    np.testing.assert_array_equal(got[mask == 0], img[mask == 0] / np.float32(255.0))
    # the same file as a training checkpoint's state dict, other nets beside the generator
    whole = {**sd, "discriminator.model.0.weight": np.zeros((2, 2), np.float32)}
    loaded = TP.load_lama(state_dict=whole, device="cpu", **LAMA)
    assert all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(), tapi.m.state_dict().values()))


def test_isnet_converter_and_segment_match_jax(isnet, tmp_path) -> None:
    jn, _, tn = isnet
    sd = _native_upstream(tn, 41)
    ckpt = save(tmp_path, "isnet.pth", sd)
    japi, tapi = jax_api(JP.ISNetAPI, jn, JP.convert_isnet, sd), TP.ISNetAPI(ckpt, device="cpu", **ISNET)
    img = image(37, 96, 80)  # resized down to 72 (antialiased), the map back up
    ref, got = japi.segment(img, infer_size=72), tapi.segment(img, infer_size=72)
    assert got.shape == ref.shape == (96, 80) and got.min() == 0.0 and rel(got, ref) < TOL


def test_iharm_converter_and_run_match_jax(iharm, tmp_path) -> None:
    jn, params, tn = iharm
    sd = _native_upstream(tn, 42)
    assert set(JP.convert_iharm(sd)) == set(params)
    ckpt = save(tmp_path, "hrnet32_idih256.pth", sd)
    japi = jax_api(JP.ImageHarmonizationAPI, jn, JP.convert_iharm, sd, size_divisor=128)
    # both APIs as their constructors leave them, around a net built small (neither API takes `small`)
    tapi = object.__new__(TP.ImageHarmonizationAPI)
    tapi.m, tapi.device, tapi.size_divisor = TP.load_iharm(ckpt, device="cpu", **IHARM), torch.device("cpu"), 128
    img = image(38, 296, 200)  # padded to 384 x 256, centred
    mask = np.zeros((296, 200), np.float32)
    mask[80:190, 60:150] = 1.0
    ref, got = japi.run(img, mask), tapi.run(img, mask)
    assert len(np.unique(ref)) > 100
    uint8_close(got, ref)


@pytest.mark.parametrize("net", ["lama", "isnet", "iharm"])
def test_strict_load_refuses_a_missing_and_an_extra_key(net, lama, isnet, iharm) -> None:
    load = {"lama": TP.load_lama, "isnet": TP.load_isnet, "iharm": TP.load_iharm}[net]
    kwargs = {"lama": LAMA, "isnet": ISNET, "iharm": IHARM}[net]
    if net == "lama":
        sd = _lama_upstream(lama[1])
    else:
        sd = _native_upstream((isnet if net == "isnet" else iharm)[2], 43)
    load(state_dict=sd, device="cpu", **kwargs)
    first = sorted(sd)[0]
    with pytest.raises(ValueError, match="leaves unfilled"):
        load(state_dict={k: v for k, v in sd.items() if k != first}, device="cpu", **kwargs)
    stray = "generator.model.99.weight" if net == "lama" else "stray.weight"
    with pytest.raises(ValueError, match="no parameter"):
        load(state_dict={**sd, stray: np.zeros(1, np.float32)}, device="cpu", **kwargs)
    # through the zoo's converter by name, as a preset with that converter loads
    from cflearn_torch.zoo.common import convert_checkpoint

    states, unused = convert_checkpoint(net, sd)
    assert not unused and set(states) <= set(load(state_dict=sd, device="cpu", **kwargs).state_dict())


@pytest.mark.parametrize("p", [0, 1])
def test_iharm_conv_transpose_bridge_both_ways(p) -> None:
    rng = np.random.RandomState(44 + p)
    w = rng.randn(3, 6, 4, 4).astype(np.float32) * 0.2  # torch's (in, out, kh, kw)
    b = rng.randn(6).astype(np.float32) * 0.1
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    # torch -> JAX (the JAX converter) -> torch (the bridge): the same weight
    kernel = JI.convert_iharm({"model.decoder.deconv_blocks.0.block.0.weight": w})[
        "model/decoder/deconv_blocks/0/block/0/kernel/value"]
    assert np.array_equal(B.conv_transpose_weight(kernel).numpy(), w)
    # JAX -> torch: the port's layer on the bridged weight computes the JAX layer's output
    jm = JI.TorchConvTranspose(3, 6, 4, 2, p, rngs=nnx.Rngs(0))
    jm.kernel[...] = kernel
    jm.bias[...] = b
    tm = TI.TorchConvTranspose(3, 6, 4, 2, p)
    tm.load_state_dict({"weight": B.conv_transpose_weight(np.asarray(jm.kernel[...])), "bias": torch.from_numpy(b)})
    ref = np.asarray(jm(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 10 - 2 * p + 2, 14 - 2 * p + 2, 6) and rel(got, ref) < 1e-5


def test_lama_up_block_bridge_both_ways() -> None:
    rng = np.random.RandomState(46)
    w = rng.randn(4, 5, 3, 3).astype(np.float32) * 0.2
    b = rng.randn(5).astype(np.float32) * 0.1
    kernel = np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[::-1, ::-1])  # `convert_lama`'s rule for the upsamples
    assert np.array_equal(B.conv_transpose_weight(kernel).numpy(), w)
    jm = JL._UpBlock(4, 5, rngs=nnx.Rngs(0))
    jm.conv.kernel[...] = kernel
    jm.conv.bias[...] = b
    tm = TP.lama._UpBlock(4, 5).eval()
    tm.conv.load_state_dict({"weight": B.conv_transpose_weight(kernel), "bias": torch.from_numpy(b)})
    x = rng.randn(1, 6, 7, 4).astype(np.float32)
    ref = np.asarray(jm.conv(x))
    with torch.no_grad():
        got = tm.conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (1, 12, 14, 5) and rel(got, ref) < 1e-5
