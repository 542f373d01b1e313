"""The port's OpenPose body net and the pose annotator against the JAX
package's, on the CPU, at full width: the net carried across by the bridge
(`convert_openpose` inverted: it gives the JAX parameters back exactly from
its output), the hosted checkpoint's flat caffe names and the numeric
Sequential names loaded as the JAX `_lookup` reads them (a tensor placed
nowhere raising), `annotate` and `OpenposeDetector`. The hand net and the
host helpers: `test_torch_annotator_openpose_hand.py`. Tolerances:
`_torch_annotator_common.py`; the rendered hints bit for bit."""

import numpy as np
import pytest
from flax import nnx

from _torch_annotator_common import image, jitted, npd, openpose_matches_jax, port, same_state
from _torch_cv_common import fast_build
from cflearn_torch import bridge as B
from cflearn_torch.api.cv import annotator as TA
from cflearn_torch.api.cv import third_party as TP
from cflearn_torch.api.cv.third_party import openpose as TO
from cflearn_tpu.api.cv import annotator as JA
from cflearn_tpu.api.cv import third_party as JP


@pytest.fixture(scope="module")
def body():
    jn = fast_build(lambda: JP.OpenPoseBody(rngs=nnx.Rngs(0)), seed=12)
    params = npd(jn)
    return jn, params, port(TP.OpenPoseBody, B.openpose_state_dict(params))


def test_openpose_body_matches_jax(body, tmp_path) -> None:
    openpose_matches_jax(body, JP.convert_openpose, TP.load_openpose, tmp_path, file_route=False)


def test_openpose_numeric_sequential_names(body) -> None:
    """The numeric Sequential layout: `model0.0.weight`, the stem's convs between ReLUs and pools."""
    _, _, tn = body
    ids = {"conv1_1": 0, "conv1_2": 2, "conv2_1": 5, "conv3_1": 10, "conv4_1": 19, "conv4_4_CPM": 25}
    assert {k: TO._STEM_IDS["model0"][k] for k in ids} == ids
    sd = {}
    for k, v in tn.state_dict().items():
        module, layer, leaf = k.split(".")
        index = TO._STEM_IDS["model0"][layer] if module == "model0" else 2 * list(
            dict(getattr(tn, module).named_children())).index(layer)
        sd[f"{module}.{index}.{leaf}"] = v
    assert same_state(TP.load_openpose(state_dict=sd, device="cpu"), tn)


def test_pose_annotate_and_detector(body, monkeypatch) -> None:
    jn, _, tn = body
    img = image(18, 48, 64)
    ja = JA.Annotator.make("pose", {})
    ja._net = jitted(jn)
    ta = TA.Annotator.make("pose", {"device": "cpu"})
    ta._net = tn
    assert np.array_equal(ta.annotate(img), ja.annotate(img))
    monkeypatch.setattr(TO, "load_openpose", lambda ckpt, device=None: tn)  # the bridged net, not a fresh one
    det = TP.OpenposeDetector("cpu")
    assert det.body_estimation is tn and det._hand_estimation is None and np.array_equal(det(img), ta.annotate(img))
    with pytest.raises(ValueError, match="hand_ckpt"):
        _ = det.hand_estimation
