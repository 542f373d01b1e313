"""`DiffusionAPI.compile` and `ControlledDiffusionAPI.prepare_annotators`,
on the CPU, on the port's tiny LDM of `__graft_entry__.py`'s widths
(`_torch_api_common.py`, torch's own initial parameters).

`compile` on the CPU captures nothing and leaves txt2img's output as it
was, bit for bit; every switch at which the JAX package clears its compiled
programs drops the captured calls; a style reference cannot be compiled.
The graph path itself runs here with a stand-in for the CUDA graph that
keeps a graph's contract (static inputs copied in, static outputs
overwritten by each call): txt2img through it is the eager one bit for bit
with DeepCache (the shallow call reading the full call's static feature in
place) and with the multistep samplers (which keep past outputs, so each
output is copied out of its static tensor). `prepare_annotators` skips a
control named by no annotator, where the JAX package raises (`ValueError`
from its registry, which its `except KeyError` does not catch)."""

import numpy as np
import pytest
import torch

from _torch_api_common import CLIP, FIRST_STAGE, UNET, image
import cflearn_torch
from cflearn_torch.api.multimodal import diffusion as TA
from cflearn_torch.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel as TCLIPText
from cflearn_tpu.api.multimodal import diffusion as JA

KW = dict(size=(64, 64), num_steps=4, guidance_scale=5.0, seed=5)


@pytest.fixture(scope="module")
def tm():
    return cflearn_torch.build(
        cflearn_torch.LDM, device="cpu", img_size=8, in_channels=4, out_channels=4, num_timesteps=50,
        condition_model=TCLIPText(**CLIP), unet_config=UNET, first_stage_config=FIRST_STAGE,
    ).eval()


def test_prepare_annotators_skips_controls_without_one(tm) -> None:
    tapi = cflearn_torch.ControlledDiffusionAPI(tm, device="cpu")
    tapi.controls.update(canny=None, my_edges=None)
    tapi.prepare_annotators()
    assert sorted(tapi.annotators) == ["canny"]
    japi = JA.ControlledDiffusionAPI.__new__(JA.ControlledDiffusionAPI)  # the method reads these two only
    japi.controls, japi.annotators = {"canny": None, "my_edges": None}, {}
    with pytest.raises(ValueError, match="not registered"):
        japi.prepare_annotators()


def test_compile_on_the_cpu_changes_nothing(tm) -> None:
    api = cflearn_torch.DiffusionAPI(tm, device="cpu")
    before = api.txt2img("a red cube", **KW)
    api.compile(num_samples=1, size=(60, 64), num_steps=4)
    assert api._compiled == {(1, (64, 64))} and api._graphs == {} and api.graph_launches() == {}
    assert np.array_equal(api.txt2img("a red cube", **KW), before)


def test_invalidation_points_drop_the_captures(tm, monkeypatch) -> None:
    """Where the JAX package clears `_jit_cache`, the port drops its captured UNet calls."""
    api = cflearn_torch.ControlledDiffusionAPI(tm, device="cpu")
    name = "unet.conv_in.bias"
    api.prepare_sd({"alt": {name: dict(tm.named_parameters())[name].detach().numpy().copy()}})
    monkeypatch.setattr(api.lora_manager, "apply_lora", lambda *a, **k: None)
    monkeypatch.setattr(api.lora_manager, "set_scales", lambda *a, **k: None)
    monkeypatch.setattr(api.lora_manager, "deactivate", lambda *a, **k: None)
    switches = {
        "switch_sampler": lambda: api.switch_sampler("ddim"), "switch_circular": lambda: api.switch_circular(False),
        "set_tome_ratio": lambda: api.set_tome_ratio(0.0), "set_deepcache": lambda: api.set_deepcache(None),
        "setup_hooks": lambda: api.setup_hooks(), "inject_sd_lora": lambda: api.inject_sd_lora("x"),
        "set_sd_lora_scales": lambda: api.set_sd_lora_scales({"x": 1.0}), "cleanup_sd_lora": api.cleanup_sd_lora,
        "switch_sd": lambda: api.switch_sd("alt"), "switch_control": lambda: api.switch_control(),
        "load_context": lambda: _enter_and_leave(api.load_context()),
    }
    for what, switch in switches.items():
        api._graphs["sentinel"] = object()
        api._graph_pool = object()
        switch()
        assert api._graphs == {} and api._graph_pool is None, what
    api.compile(num_samples=1, size=(64, 64))
    api.setup_hooks(style_reference_image=image(4)[0])
    assert api._compiled == set()  # a style reference forgets the compiled buckets
    with pytest.raises(NotImplementedError, match="style reference"):
        api.compile(num_samples=1, size=(64, 64))


def _enter_and_leave(context) -> None:
    with context:
        pass


class _StandInGraph:
    """A CUDA graph's contract on the CPU: `fn` "captured" on the static inputs, and each call copying its inputs
    into them and writing the results into the same static output tensors."""

    def __init__(self, fn, static_inputs, *, warmup=2, pool=None):
        self.fn, self.static_inputs, self.replays = fn, static_inputs, 0
        self.static_outputs = fn(**static_inputs)
        self.launches_per_replay = {}

    def __call__(self, **inputs):
        for k, v in inputs.items():
            if torch.is_tensor(v) and v is not self.static_inputs[k]:
                self.static_inputs[k].copy_(v)
        out = self.fn(**self.static_inputs)
        outs, static = (out, self.static_outputs) if isinstance(out, tuple) else ((out,), (self.static_outputs,))
        for o, s in zip(outs, static):
            if o is not s:
                s.copy_(o)
        self.replays += 1
        return self.static_outputs

    def launches(self):
        return {}


@pytest.mark.parametrize("sampler,deepcache", [("ddim", 2), ("plms", None), ("solver", None), ("k_dpmpp_2m", None)])
def test_graphed_txt2img_is_the_eager_one(tm, monkeypatch, sampler, deepcache) -> None:
    api = cflearn_torch.DiffusionAPI(tm, device="cpu")
    api.switch_sampler(sampler)
    api.set_deepcache(deepcache, cut=1)
    calls = []
    with monkeypatch.context() as m:
        m.setattr(tm, "denoise", lambda *a, _f=tm.denoise, **k: calls.append(1) or _f(*a, **k))
        eager = api.txt2img("a red cube", **KW)
    monkeypatch.setattr(TA, "CapturedCall", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(api, "_in_compiled_bucket", lambda rows, size: (rows, size) in api._compiled)
    api.compile(num_samples=1, size=(64, 64))
    graphed = [api.txt2img("a red cube", **KW) for _ in range(2)]
    assert all(np.array_equal(g, eager) for g in graphed)
    keys = list(api._graphs)
    assert len(keys) == (2 if deepcache else 1)  # the full pass and, with DeepCache, the shallow one
    n_calls = len(calls)
    calls = list(api._graphs.values())
    assert sum(c.replays for c in calls) == 2 * n_calls  # every UNet call of both loops replayed
    if deepcache:
        full, shallow = sorted(calls, key=lambda c: "deep_cache" in c.static_inputs)
        assert shallow.static_inputs["deep_cache"] is full.static_outputs[1]
    api.switch_sampler(sampler)
    assert api._graphs == {} and api._compiled == {(1, (64, 64))}
    with pytest.raises(NotImplementedError, match="UNet call alone"):
        TA._GraphedModel(api).denoise(torch.zeros(2, 8, 8, 4), torch.zeros(2), None, control_hint=[])
    api.set_deepcache(None)
