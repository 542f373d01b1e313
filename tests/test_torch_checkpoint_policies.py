"""The UNet's checkpoint policies: `use_checkpoint` given a
`jax.checkpoint_policies` name, in the port against the JAX package.

On the tiny UNet of `tests/test_torch_train_slice.py` (16x16 latents: three
self-attentions at L = 256 take the flash route, and fifteen GroupNorms sit
in checkpointed blocks):
- one finetune step under each direct name: the loss to 1e-5 and every
  gradient leaf to 1e-4 (of its largest entry, at least 1% of the largest
  gradient's) of the JAX step under the same name (XLA's attention on the
  JAX side, the flash plain version on the port's: f32 sums in another
  order), and bit for bit equal to the port's step without checkpointing
  (a recomputation repeats the same operations on the same values);
- the kernels each policy runs: the JAX step's `pallas_call`s (interpret
  mode, counted in its jaxpr) against the port's calls of the kernels'
  wrappers, with every GroupNorm sent through the card's route;
- the unknown name's error, and the six factory names: a UNet builds and
  runs without a gradient, and the first step with one raises `TypeError`,
  on both sides;
- `finetune_unet` passing the name through;
- the bytes one checkpointed block keeps for its backward (the outputs its
  policy keeps: what the selective checkpoint caches), ordered nothing <=
  dots without batch dimensions <= dots <= everything."""

import functools
import importlib
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.extend import core as jcore

from _torch_bridge_common import bridged, dezero
import cflearn_torch
from cflearn_torch.bridge import tree_from_nnx
from cflearn_torch.models.cv.diffusion import DDPMModel as TDDPMModel
from cflearn_torch.modules.multimodal.diffusion.ddpm import DDPM as TDDPM
from cflearn_torch.ops import attention as TA
from cflearn_torch.ops import group_norm as TG
from cflearn_torch.toolkit.misc import CHECKPOINT_POLICY_NAMES, resolve_checkpoint_policy
from cflearn_torch.trainer import make_train_step
from cflearn_tpu.modules.multimodal.diffusion.ddpm import DDPM
from cflearn_tpu.ops import attention as A

G = importlib.import_module("cflearn_tpu.ops.group_norm")

UNET = dict(
    start_channels=32, num_res_blocks=1, channel_multipliers=(1, 2),
    attention_downsample_rates=(1,), num_heads=4, context_dim=32,
)
B, SIZE, T, LR = 2, 16, 50, 1e-3
DIRECT = ("nothing_saveable", "dots_saveable", "checkpoint_dots", "dots_with_no_batch_dims_saveable",
          "checkpoint_dots_with_no_batch_dims", "everything_saveable")
FACTORIES = ("save_only_these_names", "save_any_names_but_these", "save_anything_except_these_names",
             "save_from_both_policies", "offload_dot_with_no_batch_dims", "save_and_offload_only_these_names")


@pytest.fixture(scope="module")
def pair():
    jm = DDPM(img_size=SIZE, num_timesteps=T, unet_config=UNET, rngs=nnx.Rngs(0))
    dezero(jm)
    tm = cflearn_torch.build(TDDPM, device="cpu", img_size=SIZE, num_timesteps=T, unet_config=UNET)
    rng = np.random.RandomState(3)
    data = (rng.randn(B, SIZE, SIZE, 4).astype(np.float32), rng.randn(B, SIZE, SIZE, 4).astype(np.float32),
            rng.randn(B, 7, 32).astype(np.float32), np.array([3, 41]))
    return jm, bridged(jm, tm), data


def _jax_loss_fn(jm, data, policy):
    x0, noise, cond, t = data
    jm.unet.use_checkpoint = policy
    gd, params, rest = nnx.split(jm, nnx.Param, ...)

    def loss_fn(p):
        m = nnx.merge(gd, p, rest)
        x_t = m.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
        out = m.denoise(x_t, jnp.asarray(t), jnp.asarray(cond))
        return jnp.mean(jnp.mean(jnp.square(out - jnp.asarray(noise)), axis=(1, 2, 3)))

    return loss_fn, params


@pytest.fixture(scope="module")
def jax_steps():
    return {}


def _jax_step(jm, data, steps, name):
    """loss and flat gradients of the JAX step under the policy `name`, once
    per name."""
    if name not in steps:
        loss_fn, params = _jax_loss_fn(jm, data, name)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        jm.unet.use_checkpoint = False
        steps[name] = float(loss), {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(grads)}
    return steps[name]


def _port_step(tm, data, use_checkpoint):
    x0, noise, cond, t = data
    tm.unet.use_checkpoint = use_checkpoint
    model = TDDPMModel(tm)
    step = make_train_step(model, optimizer="adamw", lr=LR, compute_dtype=None)
    before = {n: p.detach().clone() for n, p in model.params_filter("all")}
    try:
        losses = step.loss_and_grads(
            {"input": torch.from_numpy(x0), "cond": torch.from_numpy(cond)}, t=torch.from_numpy(t),
            noise=torch.from_numpy(noise),
        )
    finally:
        with torch.no_grad():
            for n, p in model.params_filter("all"):
                p.copy_(before[n])
        tm.unet.use_checkpoint = False
    return float(losses["loss"]), {n[len("m."):]: g for n, g in step.grads.items()}


@pytest.mark.parametrize("name", DIRECT)
def test_policy_step_matches_jax_and_the_unchecked_step(pair, jax_steps, name) -> None:
    jm, tm, data = pair
    # the JAX package's aliases are the same policy functions
    policy = getattr(jax.checkpoint_policies, name)
    canonical = next(n for n in DIRECT if getattr(jax.checkpoint_policies, n) is policy)
    ref_loss, ref_grads = _jax_step(jm, data, jax_steps, canonical)
    loss, grads = _port_step(tm, data, name)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    want = tree_from_nnx(ref_grads, tm)
    assert set(want) == set(grads)
    floor = 1e-2 * max(float(r.abs().max()) for r in want.values())
    for leaf, ref in want.items():
        err = float((grads[leaf] - ref).abs().max()) / max(float(ref.abs().max()), floor)
        assert err < 1e-4, leaf
    plain_loss, plain_grads = _port_step(tm, data, False)
    assert loss == plain_loss
    for leaf, g in plain_grads.items():
        torch.testing.assert_close(grads[leaf], g, rtol=0, atol=0, msg=leaf)


def _pallas_calls(jaxpr, counts):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            counts[eqn.params["jaxpr"].debug_info.func_src_info.split(" at ")[0]] += 1
        for value in eqn.params.values():
            for sub in value if isinstance(value, (list, tuple)) else [value]:
                if isinstance(sub, jcore.ClosedJaxpr):
                    _pallas_calls(sub.jaxpr, counts)
                elif isinstance(sub, jcore.Jaxpr):
                    _pallas_calls(sub, counts)
    return counts


@pytest.mark.parametrize("policy", [False, True, "nothing_saveable", "dots_saveable",
                                    "dots_with_no_batch_dims_saveable", "everything_saveable"])
def test_kernel_calls_per_policy_match_jax(pair, monkeypatch, policy) -> None:
    """Which kernels the step runs, and how often: a policy that keeps no
    kernel output runs each checkpointed block's flash forward and
    GroupNorms again in the backward; `everything_saveable` keeps them."""
    jm, tm, data = pair
    monkeypatch.setattr(A, "_INTERPRET", True)
    monkeypatch.setattr(G, "_INTERPRET", True)
    monkeypatch.setattr(G, "_GN_OPT_IN", True)
    loss_fn, params = _jax_loss_fn(jm, data, policy)
    try:
        ref = _pallas_calls(jax.make_jaxpr(jax.grad(loss_fn))(params).jaxpr, Counter())
    finally:
        jm.unet.use_checkpoint = False
    calls = Counter()
    for mod, name in ((TA, "flash_fwd_lse"), (TA, "flash_bwd_fused"), (TG, "group_norm_silu")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **kw: (calls.update([_n]), _fn(*a, **kw))[1])
    # every `gn_call` through the card's differentiable route (the UNet's norm_out is a plain
    # GroupNorm in the JAX module and takes the port's layer here)
    monkeypatch.setattr(TG, "module_call", lambda x, w, b, *, num_groups, eps, apply_silu=False:
                        TG.fused_group_norm(x, w, b, num_groups, eps, apply_silu))
    _port_step(tm, data, policy)
    assert dict(calls) == {"flash_fwd_lse": ref["_flash_fwd_kernel"], "flash_bwd_fused": ref["_flash_bwd_fused_kernel"],
                           "group_norm_silu": ref["_gn_silu_kernel"]}
    recomputed = policy not in (False, "everything_saveable")
    assert calls["flash_fwd_lse"] == (6 if recomputed else 3) and calls["group_norm_silu"] == (35 if recomputed else 20)


def test_unknown_name_raises_with_the_valid_names(pair) -> None:
    jm, _, _ = pair
    names = sorted(n for n in dir(jax.checkpoint_policies) if not n.startswith("_"))
    assert list(CHECKPOINT_POLICY_NAMES) == names
    with pytest.raises(ValueError) as ref:
        DDPM(img_size=SIZE, num_timesteps=T, unet_config=dict(UNET, use_checkpoint="dots_savable"), rngs=nnx.Rngs(0))
    with pytest.raises(ValueError) as got:
        cflearn_torch.build(TDDPM, device="meta", unet_config=dict(UNET, use_checkpoint="dots_savable"))
    assert str(got.value) == str(ref.value)
    tm = cflearn_torch.build(TDDPM, device="meta", unet_config=UNET)
    with pytest.raises(ValueError, match="unknown remat policy"):
        tm.unet.use_checkpoint = "everything"
    assert tm.unet.use_checkpoint is False


@pytest.mark.parametrize("name", FACTORIES)
def test_factory_names_fail_at_the_first_gradient_step(pair, name) -> None:
    jm, tm, data = pair
    loss_fn, params = _jax_loss_fn(jm, data, name)
    try:
        assert np.isfinite(float(loss_fn(params)))  # the forward alone never applies the policy
        with pytest.raises(TypeError, match=name):
            jax.grad(loss_fn)(params)
    finally:
        jm.unet.use_checkpoint = False
    x0, _, cond, t = data
    tm.unet.use_checkpoint = name
    try:
        with torch.no_grad():
            out = tm.denoise(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(cond))
        assert torch.isfinite(out).all()
        with pytest.raises(TypeError, match=name):
            _port_step(tm, data, name)
    finally:
        tm.unet.use_checkpoint = False


def test_finetune_unet_passes_the_name_through(pair) -> None:
    _, tm, data = pair
    x0, _, cond, _ = data
    model = TDDPMModel(tm)
    before = {n: p.detach().clone() for n, p in model.params_filter("all")}
    try:
        out = cflearn_torch.finetune_unet(model, x0, cond, compute_dtype=None, use_checkpoint="dots_saveable",
                                          device="cpu")
        assert out["model"].m.unet.use_checkpoint == "dots_saveable"
        assert torch.isfinite(out["losses"]).all()
        with pytest.raises(ValueError, match="unknown remat policy"):
            cflearn_torch.finetune_unet(model, x0, cond, use_checkpoint="dots", device="cpu")
    finally:
        with torch.no_grad():
            for n, p in model.params_filter("all"):
                p.copy_(before[n])
        tm.unet.use_checkpoint = False


def test_saved_bytes_of_a_checkpointed_block_follow_the_policies(pair) -> None:
    """Input block 0 (a resblock and a transformer at 16x16) under each
    policy: the bytes of the outputs the policy keeps."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    _, tm, data = pair
    unet = tm.unet
    x0, _, cond, t = data
    with torch.no_grad():
        net = unet.conv_in(torch.from_numpy(x0))
    emb = unet.time_embed(torch.from_numpy(t))
    saved = {}
    for name in ("nothing_saveable", "dots_with_no_batch_dims_saveable", "dots_saveable", "everything_saveable"):
        policy, kept = resolve_checkpoint_policy(name), []

        def counting(ctx, op, *args, _policy=policy, _kept=kept, **kwargs):
            decision = _policy(ctx, op, *args, **kwargs)
            if decision.name == "MUST_SAVE" and not ctx.is_recompute:
                outs = ctx.op_output if isinstance(ctx.op_output, (tuple, list)) else [ctx.op_output]
                _kept.extend(o.numel() * o.element_size() for o in outs if isinstance(o, torch.Tensor))
            return decision

        x = net.detach().requires_grad_()
        out = checkpoint(unet.input_blocks[0], x, emb.detach(), torch.from_numpy(cond), use_reentrant=False,
                         context_fn=functools.partial(create_selective_checkpoint_contexts, counting))
        out.square().sum().backward()
        saved[name] = sum(kept)
    order = [saved[n] for n in ("nothing_saveable", "dots_with_no_batch_dims_saveable", "dots_saveable",
                                "everything_saveable")]
    assert order == sorted(order) and order[0] == 0 < order[1] < order[2] < order[3], saved
