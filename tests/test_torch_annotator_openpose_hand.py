"""The port's OpenPose hand net and the pose host helpers against the JAX
package's, on the CPU, at full width: the net carried across by the bridge
(`convert_hand` inverted: it gives the JAX parameters back exactly from its
output) and loaded from a file of the flat caffe names, `detect_hand_peaks`,
and `render_keypoints`, `extract_keypoints`, `hand_boxes_from_keypoints`,
`draw_handpose` on identical inputs (bit for bit). Tolerances:
`_torch_annotator_common.py`."""

import numpy as np
import pytest
from flax import nnx

from _torch_annotator_common import image, npd, openpose_matches_jax, port
from _torch_cv_common import fast_build
from cflearn_torch import bridge as B
from cflearn_torch.api.cv import third_party as TP
from cflearn_tpu.api.cv import third_party as JP


@pytest.fixture(scope="module")
def hand():
    jn = fast_build(lambda: JP.OpenPoseHand(rngs=nnx.Rngs(0)), seed=13)
    params = npd(jn)
    return jn, params, port(TP.OpenPoseHand, B.hand_state_dict(params))


def test_openpose_hand_matches_jax(hand, tmp_path) -> None:
    openpose_matches_jax(hand, JP.convert_hand, TP.load_hand, tmp_path, file_route=True)


def test_openpose_host_helpers_bit_for_bit() -> None:
    rng = np.random.RandomState(15)
    heat = rng.rand(2, 16, 12, 19).astype(np.float32) * 0.3
    assert np.array_equal(TP.render_keypoints(heat, (128, 96)), JP.render_keypoints(heat, (128, 96)))
    assert TP.extract_keypoints(heat, (128, 96)) == JP.extract_keypoints(heat, (128, 96))
    kp = {2: (40.0, 30.0), 3: (50.0, 60.0), 4: (60.0, 90.0), 5: (20.0, 30.0), 6: (15.0, 60.0), 7: (10.0, 90.0)}
    boxes = TP.hand_boxes_from_keypoints(kp, (128, 96))
    assert boxes and boxes == JP.hand_boxes_from_keypoints(kp, (128, 96))
    peaks = [rng.randint(0, 60, (21, 2)) for _ in range(2)]
    peaks[0][3] = 0
    canvas = rng.randint(0, 255, (64, 64, 3)).astype(np.uint8)
    assert np.array_equal(TP.draw_handpose(canvas.copy(), peaks), JP.draw_handpose(canvas.copy(), peaks))


def test_hand_peaks_match_jax(hand) -> None:
    jn, _, tn = hand
    crop = image(16, 48, 40)
    assert np.array_equal(TP.detect_hand_peaks(tn, crop, boxsize=64), JP.detect_hand_peaks(jn, crop, boxsize=64))
