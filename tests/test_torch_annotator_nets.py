"""The port's HED and PiDiNet annotators against the JAX package's, on the
CPU, at full width: the nets carried across by the bridge (the JAX
`convert_*` inverted: `convert_hed` of its output gives the JAX parameters
back exactly) and loaded from upstream-layout checkpoint files (PiDiNet's
with raw pixel-difference weights, which both sides fold), their
`annotate`, and the `HedAPI` / `PiDiAPI` wrappers. Tolerances:
`_torch_annotator_common.py`."""

import numpy as np
import pytest
from flax import nnx

from _torch_annotator_common import TOL, as_numpy, image, jitted, npd, port, rel, run, save, uint8_close
from _torch_cv_common import fast_build
from cflearn_torch import bridge as B
from cflearn_torch.api.cv import annotator as TA
from cflearn_torch.api.cv import third_party as TP
from cflearn_tpu.api.cv import annotator as JA
from cflearn_tpu.api.cv import third_party as JP
from cflearn_tpu.toolkit.tree import npd_to_tree


@pytest.fixture(scope="module")
def hed():
    jn = fast_build(lambda: JP.HED(rngs=nnx.Rngs(0)), seed=5)
    jn.norm[...] = np.random.RandomState(5).uniform(100, 150, (1, 1, 1, 3)).astype(np.float32)
    params = npd(jn)
    return jn, params, port(TP.HED, B.hed_state_dict(params))


def test_hed_matches_jax(hed, tmp_path) -> None:
    jn, params, tn = hed
    sd = as_numpy(tn.state_dict())
    back = JP.convert_hed(sd)
    assert set(back) == set(params) and all(np.array_equal(back[k], params[k]) for k in params)
    x = np.random.RandomState(6).uniform(0, 255, (1, 48, 64, 3)).astype(np.float32)
    ref = np.asarray(jitted(jn)(x))
    got = run(tn, x)
    assert got.shape == ref.shape == (1, 48, 64, 1) and rel(got, ref) < TOL
    assert np.array_equal(run(TP.load_hed(save(tmp_path, "hed.pth", sd), device="cpu"), x), got)


def test_softedge_annotate_and_hed_api(hed, tmp_path) -> None:
    jn, _, tn = hed
    img = image(18, 48, 64)
    ja = JA.Annotator.make("softedge", {})
    ja._hed = jitted(jn)
    ckpt = save(tmp_path, "hed.pth", tn.state_dict())
    ta = TA.Annotator.make("softedge", {"hed_ckpt": ckpt, "device": "cpu"})
    uint8_close(ta.annotate(img), ja.annotate(img))
    api = TP.HedAPI("cpu", ckpt=ckpt)
    assert np.array_equal(api(img), ta.annotate(img)[..., 0])


def _pidi_raw(tn, seed):
    """An upstream `table5_pidinet.pth` state dict with raw (unfolded) 3x3 pixel-difference weights, under a
    DataParallel prefix."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in tn.state_dict().items():
        shape = (v.shape[0], v.shape[1], 3, 3) if k.endswith("conv1.weight") and v.shape[-1] == 5 else tuple(v.shape)
        fan = max(1, int(np.prod(shape[1:]))) if len(shape) > 1 else 1
        sd[f"module.{k}"] = (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def pidi():
    jn = fast_build(lambda: JP.PiDiNet(rngs=nnx.Rngs(0)), seed=7)
    params = npd(jn)
    return jn, params, port(TP.PiDiNet, B.pidi_state_dict(params))


def test_pidi_matches_jax(pidi, tmp_path) -> None:
    """The bridge from the JAX net, and a raw upstream checkpoint folded by both sides."""
    jn, params, tn = pidi
    x = np.random.RandomState(8).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jitted(jn)(x))
    got = run(tn, x)
    assert got.shape == ref.shape == (1, 64, 64) and rel(got, ref) < TOL
    raw = _pidi_raw(tn, 9)
    folded = JP.convert_pidi(raw)
    assert set(folded) == set(params)
    jr = fast_build(lambda: JP.PiDiNet(rngs=nnx.Rngs(0)), seed=7)
    nnx.update(jr, npd_to_tree(folded, nnx.state(jr), strict=False))
    tr = TP.load_pidi(save(tmp_path, "pidi.pth", raw), device="cpu")
    assert rel(run(tr, x), np.asarray(jitted(jr)(x))) < TOL


def test_pidi_annotate_and_api(pidi, tmp_path) -> None:
    jn, _, tn = pidi
    img = image(19, 48, 64)
    ja = JA.Annotator.make("pidi", {})
    ja._net = jitted(jn)
    ta = TA.Annotator.make("pidi", {"device": "cpu"})
    ta._net = tn
    uint8_close(ta.annotate(img), ja.annotate(img))
    uint8_close(ta.annotate(img, threshold=0.5), ja.annotate(img, threshold=0.5))
    api = TP.PiDiAPI("cpu")
    api._annotator._net = api.model = tn
    assert np.array_equal(api(img, threshold=0.5), ta.annotate(img, threshold=0.5)[..., 0])
