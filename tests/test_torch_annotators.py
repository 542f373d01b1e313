"""The port's depth annotator (MiDaS DPT) and the annotator registry against
the JAX package's, on the CPU.

DPT: `dpt_tiny` on a 64 x 96 image, and `dpt_base`'s widths at depth 4 on a
64² image (depth 4, the fewest blocks with DPT's four taps; the 24 x 24
position grid shrinks to 4 x 4), carried across by the bridge
(`cflearn_torch.bridge.dpt_state_dict`, which is `convert_midas` inverted:
`convert_midas` of its output gives the JAX parameters back exactly, and
the JAX tests' own inverse gives the same upstream layout) and loaded from
an upstream-layout checkpoint file with every key covered. `dpt_hybrid` is
not built on either side. `resize_align_corners` at its edge cases: 4e-6
on values up to about 3 (a few f32 ulps: the JAX package builds its
weights from the scale, torch from the index ratio). The depth annotator,
canny, the sobel and blur fallbacks, `detect_normal`'s host step and
`MiDaSAPI`; `pretrained=True` without a checkpoint raising. Tolerances:
`_torch_annotator_common.py`; host steps on identical inputs bit for bit."""

import numpy as np
import pytest
import torch
from flax import nnx

from _torch_annotator_common import TOL, as_numpy, image, jitted, npd, port, rel, run, save, uint8_close
from _torch_bridge_common import empty_cache
from _torch_cv_common import fast_build
from test_annotator_nets import _invert_midas_npd
from cflearn_torch import bridge as B
from cflearn_torch.api.cv import annotator as TA
from cflearn_torch.api.cv.third_party import midas as TM
from cflearn_torch.api.cv.third_party import wrappers as TW
from cflearn_torch.zoo.common import get_available
from cflearn_tpu.api.cv import annotator as JA
from cflearn_tpu.api.cv.third_party import midas as JM
from cflearn_tpu.api.cv.third_party import wrappers as JW

DPT_BASE_DEPTH4 = dict(dim=768, depth=4, heads=12, hooks=(0, 1, 2, 3), reassemble=(96, 192, 384, 768))


def _dpt(ctor, seed, lift):
    """A seeded JAX DPT whose depth head passes its whole map: the filled nets' last conv sits below 0 almost
    everywhere (dpt_tiny: [-5.9, 0.08]; dpt_base at depth 4: [-11.6, -1.0]), which the non-negative ReLU
    would zero, so its bias is lifted by `lift`."""
    jn = fast_build(ctor, seed=seed)
    jn.head_conv3.bias[...] = jn.head_conv3.bias[...] + lift
    return jn


@pytest.fixture(scope="module")
def dpt_tiny():
    jn = _dpt(lambda: JM.DPTDepth("dpt_tiny", features=16, rngs=nnx.Rngs(0)), 1, 6.5)
    params = npd(jn)
    return jn, params, port(lambda: TM.DPTDepth("dpt_tiny"), B.dpt_state_dict(params))


@pytest.mark.parametrize("variant", ["dpt_tiny", "dpt_base_depth4"])
def test_dpt_matches_jax(variant, dpt_tiny, monkeypatch, tmp_path) -> None:
    if variant == "dpt_tiny":
        (jn, params, tn), model_type, shape = dpt_tiny, "dpt_tiny", (2, 64, 96, 3)
    else:
        monkeypatch.setitem(JM._CONFIGS, "dpt_base", DPT_BASE_DEPTH4)
        monkeypatch.setitem(TM._CONFIGS, "dpt_base", DPT_BASE_DEPTH4)
        jn = _dpt(lambda: JM.DPTDepth("dpt_base", rngs=nnx.Rngs(0)), 2, 12.0)
        params = npd(jn)
        tn, model_type, shape = port(lambda: TM.DPTDepth("dpt_base"), B.dpt_state_dict(params)), "dpt_base", (1, 64, 64, 3)
    sd = as_numpy(tn.state_dict())
    back = JM.convert_midas(sd)
    assert set(back) == set(params) and all(np.array_equal(back[k], params[k]) for k in params)
    upstream = _invert_midas_npd(params)
    assert set(upstream) == set(sd) and all(np.array_equal(upstream[k], sd[k]) for k in sd)
    x = np.random.RandomState(3).uniform(-1, 1, shape).astype(np.float32)
    ref = np.asarray(jitted(jn)(x))
    got = run(tn, x)
    assert got.shape == ref.shape == shape[:3] and (ref > 0).mean() > 0.99 and rel(got, ref) < TOL
    if variant != "dpt_tiny":
        return
    # an upstream file, with the ViT's final norm and head (which DPT never runs) beside the rest, loads strictly
    width = sd["pretrained.model.cls_token"].shape[-1]
    upstream["pretrained.model.norm.weight"] = np.ones(width, np.float32)
    upstream["pretrained.model.head.weight"] = np.zeros((10, width), np.float32)
    loaded = TM.load_midas(save(tmp_path, "dpt.pt", upstream), model_type=model_type, device="cpu")
    assert np.array_equal(run(loaded, x), got)
    with pytest.raises(RuntimeError, match="Missing key"):
        TM.load_midas(state_dict={k: v for k, v in upstream.items() if "blocks.0.attn" not in k},
                      model_type=model_type, device="cpu")


def test_dpt_hybrid_is_not_built_on_either_side() -> None:
    """The JAX package builds no ViT-hybrid DPT (`_CONFIGS` has no entry): both raise KeyError."""
    with pytest.raises(KeyError):
        JM.DPTDepth("dpt_hybrid", rngs=nnx.Rngs(0))
    with pytest.raises(KeyError):
        TM.load_midas(None, model_type="dpt_hybrid", device="cpu")


@pytest.mark.parametrize("hw_in,hw_out", [((2, 3), (5, 7)), ((1, 4), (2, 8)), ((4, 1), (8, 2)), ((4, 4), (1, 1)),
                                          ((5, 6), (1, 12)), ((4, 6), (4, 6))])
def test_resize_align_corners_edge_cases(hw_in, hw_out) -> None:
    """torch's align_corners=True, and JAX's half-pixel fallback where a side is one pixel, in or out."""
    x = np.random.RandomState(4).randn(2, *hw_in, 3).astype(np.float32)
    ref = np.asarray(JM.resize_align_corners(x, hw_out))
    got = TM.nhwc(TM.resize_align_corners(TM.nchw(torch.from_numpy(x)), hw_out)).numpy()
    assert got.shape == ref.shape and np.abs(got - ref).max() < 4e-6


def test_depth_annotate_matches_jax(dpt_tiny, tmp_path) -> None:
    """Edge-padded to 64 x 96, cropped back, min-max normalised per image."""
    jn, _, tn = dpt_tiny
    ja = JA.Annotator.make("depth", {})
    ja._net = jitted(jn)
    ta = TA.Annotator.make("depth", {"ckpt": save(tmp_path, "dpt.pt", tn.state_dict()), "model_type": "dpt_tiny",
                                     "device": "cpu"})
    img = image(17, 56, 80)
    uint8_close(ta.annotate(img), ja.annotate(img))
    uint8_close(ta.annotate(np.stack([img, img[::-1]])), ja.annotate(np.stack([img, img[::-1]])))


def test_host_annotators_bit_for_bit() -> None:
    """canny, the sobel softedge and the blur depth proxy: the reference's behaviour without a checkpoint."""
    img = image(22, 64, 48)
    for name, kw in (("canny", {}), ("canny", {"low_threshold": 50, "high_threshold": 120}), ("softedge", {}),
                     ("depth", {})):
        got = TA.Annotator.make(name, {}).annotate(img, **kw)
        assert np.array_equal(got, JA.Annotator.make(name, {}).annotate(img, **kw)), name
    floats = img.astype(np.float32) / 255.0
    assert np.array_equal(TA.Annotator.make("canny", {}).annotate(floats), JA.Annotator.make("canny", {}).annotate(floats))


def test_detect_normal_host_step_bit_for_bit(monkeypatch) -> None:
    depth = np.random.RandomState(23).rand(1, 40, 56).astype(np.float32) * 5
    apis = []
    for W, A in ((TW, TA), (JW, JA)):
        api = W.MiDaSAPI.__new__(W.MiDaSAPI)
        api._annotator = A.DepthAnnotator()
        monkeypatch.setattr(api._annotator, "raw_depth", lambda batch: depth.copy(), raising=False)
        apis.append(api)
    img = image(24, 40, 56)
    assert np.array_equal(apis[0].detect_normal(img), apis[1].detect_normal(img))
    assert np.array_equal(apis[0].detect_normal(img, a=3.0, bg_th=0.3), apis[1].detect_normal(img, a=3.0, bg_th=0.3))


def test_midas_api(dpt_tiny, tmp_path) -> None:
    """`MiDaSAPI` on the CPU: the depth annotator's output, normals, `to` moving and casting the net."""
    _, _, tn = dpt_tiny
    img = image(26, 64, 64)
    ckpt = save(tmp_path, "dpt.pt", tn.state_dict())
    midas = TW.MiDaSAPI("cpu", ckpt=ckpt, model_type="dpt_tiny")
    depth = TA.Annotator.make("depth", {"ckpt": ckpt, "model_type": "dpt_tiny", "device": "cpu"})
    assert np.array_equal(midas.detect_depth(img), depth.annotate(img)[..., 0])
    assert midas.detect_normal(img).shape == (64, 64, 3)
    midas.to("cpu", use_half=True)
    assert next(midas.model.parameters()).dtype == torch.float16
    midas.to("cpu")
    assert next(midas.model.parameters()).dtype == torch.float32


@pytest.mark.parametrize("name,kw,tag", [("depth", {}, "midas_dpt_large"), ("softedge", {}, "hed"),
                                         ("pose", {}, "body_pose"), ("mlsd", {}, "mlsd"),
                                         ("depth", {"model_type": "dpt_hybrid"}, "midas_dpt_hybrid")])
def test_pretrained_without_ckpt_raises(name, kw, tag, tmp_path, monkeypatch) -> None:
    """`pretrained=True` alone takes the index entry's file from the download cache: from an empty one it
    raises, naming the path where the file goes."""
    file = get_available()["checkpoints"][tag]["url"].split("/")[-1]
    with empty_cache(tmp_path, monkeypatch) as folder:
        with pytest.raises(OSError, match=f"put the file at {folder / file}"):
            TA.Annotator.make(name, dict(kw, pretrained=True))


def test_registry_and_nets_needing_a_checkpoint() -> None:
    img = image(25, 32, 32)
    for name in ("pose", "pidi", "mlsd"):
        with pytest.raises(ValueError, match="checkpoint"):
            TA.Annotator.make(name, {}).annotate(img)
    assert sorted(TA.Annotator.d) == sorted(JA.Annotator.d)
    assert vars(TA.ControlNetHints).keys() - {"__doc__"} == vars(JA.ControlNetHints).keys() - {"__doc__"}
