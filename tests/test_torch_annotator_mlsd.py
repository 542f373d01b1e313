"""The port's M-LSD annotator against the JAX package's, on the CPU, at full
width: the net carried across by the bridge (`convert_mlsd` inverted: it
gives the JAX parameters and batch statistics back exactly from its
output; the JAX tests' own inverse gives the same upstream layout), loaded
from an upstream-layout checkpoint file (without `num_batches_tracked`),
`annotate`, `MLSDDetector` and `decode_lines`. Tolerances:
`_torch_annotator_common.py`; the hint is a 1-pixel line drawing, where a
segment's end truncated to the other side of a pixel moves a whole line
pixel, so it is held to differ on at most 0.1% of the pixels;
`decode_lines` on identical inputs bit for bit."""

import numpy as np
import pytest
from flax import nnx

from _torch_annotator_common import TOL, as_numpy, image, jitted, npd, port, rel, run, same_state, save, uint8_close
from _torch_cv_common import fast_build
from test_annotator_nets import _invert_mlsd_npd
from cflearn_torch import bridge as B
from cflearn_torch.api.cv import annotator as TA
from cflearn_torch.api.cv import third_party as TP
from cflearn_tpu.api.cv import annotator as JA
from cflearn_tpu.api.cv import third_party as JP
from cflearn_tpu.api.cv.third_party.mlsd import decode_lines as jax_decode_lines


@pytest.fixture(scope="module")
def mlsd():
    jn = fast_build(lambda: JP.MLSD(rngs=nnx.Rngs(0)), seed=10)
    params = npd(jn, batch_stats=True)
    return jn, params, port(TP.MLSD, B.mlsd_state_dict(params))


def test_mlsd_matches_jax(mlsd, tmp_path) -> None:
    jn, params, tn = mlsd
    sd = as_numpy(tn.state_dict())
    back = JP.convert_mlsd(sd)
    assert set(back) == set(params) and all(np.array_equal(back[k], params[k]) for k in params)
    upstream = _invert_mlsd_npd(params)
    assert set(upstream) == {k for k in sd if not k.endswith("num_batches_tracked")}
    assert all(np.array_equal(upstream[k], sd[k]) for k in upstream)
    x = np.random.RandomState(11).uniform(-1, 1, (1, 64, 64, 4)).astype(np.float32)
    ref = np.asarray(jitted(jn)(x))
    got = run(tn, x)
    assert got.shape == ref.shape == (1, 32, 32, 9) and rel(got, ref) < TOL
    # the upstream file without `num_batches_tracked` loads strictly too
    loaded = TP.load_mlsd(save(tmp_path, "mlsd.pth", upstream), device="cpu")
    assert same_state(loaded, tn) and np.array_equal(run(loaded, x), got)


def test_mlsd_annotate_and_decode_match_jax(mlsd, tmp_path) -> None:
    jn, _, tn = mlsd
    ja = JA.Annotator.make("mlsd", {})
    ja._net = jitted(jn)
    ckpt = save(tmp_path, "mlsd.pth", tn.state_dict())
    ta = TA.Annotator.make("mlsd", {"ckpt": ckpt, "device": "cpu"})
    img = image(20, 96, 128)
    got, ref = ta.annotate(img), ja.annotate(img)
    assert ref.max() == 255
    uint8_close(got, ref, max_level=255)
    assert np.array_equal(TP.MLSDDetector("cpu", ckpt=ckpt)(img), got)
    tp_map = np.random.RandomState(21).randn(32, 32, 9).astype(np.float32) * 3
    for kw in ({"dist_thr": 2.0}, {"score_thr": 0.5, "dist_thr": 4.0}):
        got, ref = TP.decode_lines(tp_map, **kw), jax_decode_lines(tp_map, **kw)
        assert len(ref) and np.array_equal(got, ref)
