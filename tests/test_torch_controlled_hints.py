"""`ControlledDiffusionAPI.get_hint_of` -> `sample_with_control` against the
JAX API, on the CPU: the tiny LDM of `__graft_entry__.py`
(`_torch_api_common.py`) with a ControlNet of its widths (filled from
numpy), and the depth annotator on a `dpt_tiny` checkpoint prepared by
`prepare_annotator` (the JAX annotator's net under `nnx.jit`). The hints
within one level on at most 0.1% of the values; then both sides sample from
the JAX hint, the draws fed from the JAX side, the latents and images to
`_torch_api_common.py`'s tolerances. Per-call kwargs reach `annotate`."""

import jax
import numpy as np
import pytest
from flax import nnx

from _torch_annotator_common import jitted, npd, port, save, uint8_close
from _torch_api_common import UNET, catch_latents, check, feed, image, ldm_pair, normal
from _torch_bridge_common import flat_params
from _torch_cv_common import fast_build
import cflearn_torch
from cflearn_torch import bridge as B
from cflearn_torch.api.cv.third_party import midas as TM
from cflearn_torch.bridge import control_net_params, load_nnx_params
from cflearn_tpu.api.multimodal import diffusion as JA
from cflearn_tpu.api.cv.third_party import midas as JM
from cflearn_tpu.modules.multimodal.diffusion.unet import ControlNet

KW = dict(size=(64, 64), num_steps=2, guidance_scale=5.0, seed=5)


@pytest.fixture(scope="module")
def plain():
    return ldm_pair(4, 0)


@pytest.fixture()
def caught(monkeypatch):
    return catch_latents(monkeypatch)


def test_get_hint_of_drives_sample_with_control(plain, caught, monkeypatch, tmp_path) -> None:
    jm, tm = plain
    jc = fast_build(lambda: ControlNet(hint_channels=3, in_channels=4, rngs=nnx.Rngs(1), **UNET), seed=11)
    tc = cflearn_torch.build(cflearn_torch.ControlNet, device="cpu", hint_channels=3, in_channels=4, **UNET)
    load_nnx_params(tc, control_net_params(flat_params(jc))).eval()
    jd = fast_build(lambda: JM.DPTDepth("dpt_tiny", features=16, rngs=nnx.Rngs(0)), seed=1)
    jd.head_conv3.bias[...] = jd.head_conv3.bias[...] + 6.5  # the whole map above the head's ReLU
    ckpt = save(tmp_path, "dpt.pt", port(lambda: TM.DPTDepth("dpt_tiny"), B.dpt_state_dict(npd(jd))).state_dict())
    japi, tapi = JA.ControlledDiffusionAPI(jm), cflearn_torch.ControlledDiffusionAPI(tm, device="cpu")
    japi.prepare_control("depth", jc)
    tapi.prepare_control("depth", tc)
    japi.prepare_annotator("depth")
    japi.annotators["depth"]._net = jitted(jd)
    tapi.prepare_annotator("depth", ckpt=ckpt, model_type="dpt_tiny", device="cpu")
    tapi.prepare_annotators()  # the prepared one is kept
    assert tapi.annotators["depth"]._net is not None
    img = image(3)[0]
    hint_j, hint_t = japi.get_hint_of("depth", img), tapi.get_hint_of("depth", img)
    uint8_close(hint_t, hint_j)
    kw = dict(cond="a red cube", negative_prompt="blurry", **KW)
    ref = japi.sample_with_control(1, {"depth": hint_j}, **kw)
    feed(monkeypatch, [normal(jax.random.PRNGKey(KW["seed"]), (1, 8, 8, 4))])
    got = tapi.sample_with_control(1, {"depth": hint_j}, **kw)
    check(got, ref, caught)
    # per-call kwargs go to `annotate`
    assert np.array_equal(tapi.get_hint_of("canny", img, low_threshold=10), japi.get_hint_of("canny", img, low_threshold=10))
