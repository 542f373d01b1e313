"""The port's training slice against the JAX package: the forward-process
pieces, the p-loss, EMA, the optimizers, and one UNet finetune step as a
whole (loss, every gradient leaf, every updated parameter).

The tiny UNet has 16x16 latents, so its self-attention reaches L = 256 and
takes the flash route: the Pallas forward-with-lse and backward kernels in
interpret mode on the JAX side, their plain versions on the port's CPU path.
Both sides get the same x0, t, noise and condition from numpy."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from _torch_bridge_common import bridged, dezero, flat_params
import cflearn_torch
from cflearn_torch import optimizers as TO
from cflearn_torch.bridge import jax_row_dims, tree_from_nnx
from cflearn_torch.models.cv.diffusion import DDPMModel as TDDPMModel
from cflearn_torch.models.cv.diffusion import DDPMStep as TDDPMStep
from cflearn_torch.modules.common import EMA as TEMA
from cflearn_torch.modules.layers import Conv as TConv
from cflearn_torch.modules.layers import LayerNorm as TLayerNorm
from cflearn_torch.modules.layers import Linear as TLinear
from cflearn_torch.modules.multimodal.diffusion.ddpm import DDPM as TDDPM
from cflearn_torch.ops import attention as TA
from cflearn_torch.trainer import make_train_step
from cflearn_tpu.models.cv.diffusion import DDPMStep
from cflearn_tpu.modules.common import EMA
from cflearn_tpu.modules.multimodal.diffusion.ddpm import DDPM
from cflearn_tpu.ops import attention as A
from cflearn_tpu.optimizers import _adamp_transform, build_optimizer

UNET = dict(
    start_channels=32, num_res_blocks=1, channel_multipliers=(1, 2),
    attention_downsample_rates=(1,), num_heads=4, context_dim=32,
)
B, SIZE, T = 2, 16, 50


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(A, "_INTERPRET", True)


def _pair(**kw):
    """A JAX DDPM and its bridged port counterpart (f32, CPU)."""
    jm = DDPM(img_size=SIZE, num_timesteps=T, unet_config=UNET, rngs=nnx.Rngs(0), **kw)
    dezero(jm)
    tm = cflearn_torch.build(TDDPM, device="cpu", img_size=SIZE, num_timesteps=T, unet_config=UNET, **kw)
    return jm, bridged(jm, tm)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x0 = rng.randn(B, SIZE, SIZE, 4).astype(np.float32)
    noise = rng.randn(B, SIZE, SIZE, 4).astype(np.float32)
    cond = rng.randn(B, 7, 32).astype(np.float32)
    t = np.array([3, 41])
    return x0, noise, cond, t


@pytest.mark.parametrize("parameterization", ["eps", "x0", "v"])
def test_forward_process_pieces_match(parameterization) -> None:
    jm, tm = _pair(parameterization=parameterization)
    x0, noise, _, t = _batch()
    jt, tt = jnp.asarray(t), torch.from_numpy(t)
    for name in ("lvlb_weights", "posterior_variance", "log_var"):
        np.testing.assert_array_equal(getattr(tm, name).detach().numpy(), np.asarray(getattr(jm, name)[...]), err_msg=name)
    # elementwise f32 arithmetic on equal buffers: equal to the last ulp or two
    np.testing.assert_allclose(
        tm.q_sample(torch.from_numpy(x0), tt, torch.from_numpy(noise)).numpy(),
        np.asarray(jm.q_sample(jnp.asarray(x0), jt, jnp.asarray(noise))), rtol=1e-6, atol=1e-7,
    )
    np.testing.assert_allclose(
        tm.get_v(torch.from_numpy(x0), torch.from_numpy(noise), tt).numpy(),
        np.asarray(jm.get_v(jnp.asarray(x0), jnp.asarray(noise), jt)), rtol=1e-6, atol=1e-7,
    )


@pytest.mark.parametrize(
    "parameterization,learn_log_var,elbo",
    [("eps", False, 0.0), ("eps", True, 0.5), ("x0", True, 0.0), ("x0", False, 0.5), ("v", False, 0.5), ("v", True, 0.0)],
)
def test_p_loss_matches(interpret, parameterization, learn_log_var, elbo) -> None:
    """`DDPMStep.loss_fn` against the JAX one. The JAX step draws t and the
    noise from the model's `nnx.Rngs`; a clone of those Rngs gives the same
    draws, which the port's step takes as arguments."""
    jm, tm = _pair(parameterization=parameterization, learn_log_var=learn_log_var, log_var_init=0.3)
    x0, _, cond, _ = _batch(1)
    rngs = nnx.clone(jm.rngs)
    t = np.array(jax.random.randint(rngs.default(), (B,), 0, T))
    noise = np.array(jax.random.normal(rngs.default(), x0.shape, jnp.float32))
    jstep = DDPMStep("all")
    jstep.l_simple_weight, jstep.original_elbo_weight = 0.7, elbo
    ref = jstep.loss_fn(SimpleNamespace(m=jm), {"input": jnp.asarray(x0), "cond": jnp.asarray(cond)}, {})
    tstep = TDDPMStep("all")
    tstep.l_simple_weight, tstep.original_elbo_weight = 0.7, elbo
    with torch.no_grad():
        got = tstep.loss_fn(
            TDDPMModel(tm), {"input": torch.from_numpy(x0), "cond": torch.from_numpy(cond)},
            t=torch.from_numpy(t), noise=torch.from_numpy(noise),
        )
    assert set(got) == set(ref)
    for key in ref:
        # a mean over B x 16 x 16 x 4 squared errors of an f32 UNet forward
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=2e-5, err_msg=key)


def test_p_loss_draws_from_the_generator() -> None:
    _, tm = _pair()
    x0, _, cond, _ = _batch(2)
    batch = {"input": torch.from_numpy(x0), "cond": torch.from_numpy(cond)}
    step, model = TDDPMStep("all"), TDDPMModel(tm)
    with torch.no_grad():
        a = step.loss_fn(model, batch, generator=torch.Generator().manual_seed(5))["loss"]
        b = step.loss_fn(model, batch, generator=torch.Generator().manual_seed(5))["loss"]
        c = step.loss_fn(model, batch, generator=torch.Generator().manual_seed(6))["loss"]
    assert a == b and a != c


def test_ema_update_matches() -> None:
    rng = np.random.RandomState(0)
    jlin = nnx.Linear(5, 3, rngs=nnx.Rngs(0))
    tlin = torch.nn.Linear(5, 3)
    with torch.no_grad():
        tlin.weight.copy_(torch.from_numpy(np.array(jlin.kernel[...]).T))
        tlin.bias.copy_(torch.from_numpy(np.array(jlin.bias[...])))
    jema, tema = EMA(0.95, jlin), TEMA(0.95, tlin)
    assert not list(tema.parameters())  # shadows are buffers: no optimizer sees them
    for _ in range(4):  # the warm-up decay (1 + n) / (10 + n) is below 0.95 for these n
        dk, db = rng.randn(5, 3).astype(np.float32), rng.randn(3).astype(np.float32)
        jlin.kernel[...] = jlin.kernel[...] + dk
        jlin.bias[...] = jlin.bias[...] + db
        with torch.no_grad():
            tlin.weight += torch.from_numpy(dk.T)
            tlin.bias += torch.from_numpy(db)
        jema.update(jlin)
        tema.update(tlin)
    assert int(tema.num_updates) == int(jema.num_updates[...]) == 4
    shadow = tema.shadow()
    np.testing.assert_allclose(shadow["weight"].numpy().T, np.asarray(jema.shadow["kernel"][...]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(shadow["bias"].numpy(), np.asarray(jema.shadow["bias"][...]), rtol=1e-6, atol=1e-7)
    stored = tema.store(tlin)
    tema.copy_to(tlin)
    torch.testing.assert_close(tlin.weight.detach(), shadow["weight"])
    tema.restore(tlin, stored)
    torch.testing.assert_close(tlin.bias.detach(), stored["bias"])


OPT_CASES = [
    ("sgd", dict(momentum=0.9, weight_decay=1e-2), 0.0),
    ("sgd", dict(momentum=0.9, nesterov=True), 0.0),
    ("adam", dict(weight_decay=1e-2), 0.0),
    ("adamw", dict(weight_decay=1e-2), 0.0),
    ("adamw", dict(weight_decay=1e-2), 0.5),  # clip by the global norm, then adamw
    ("rmsprop", dict(alpha=0.9, weight_decay=1e-2), 0.0),
    ("rmsprop", dict(momentum=0.9), 0.0),
    ("nadam", dict(betas=(0.8, 0.99)), 0.0),
    ("adamp", dict(weight_decay=1e-2, delta=0.5), 0.0),  # delta 0.5: the (4, 3) leaf's rows get projected
]


def _jax_tx(name, lr, config):
    """The JAX registry's optimizer; for `adamp` its transform followed by a
    descent step of lr. The registry's `adamp` chains the transform, which
    negates its step already, with `scale_by_learning_rate`, which negates it
    again: it climbs the loss (`test_jax_adamp_climbs`)."""
    if name == "adamp":
        return optax.chain(_adamp_transform(**config), optax.scale_by_learning_rate(lr, flip_sign=False))
    return build_optimizer(name, lr, **config)


@pytest.mark.parametrize("name,config,clip", OPT_CASES, ids=lambda v: str(v))
def test_optimizers_match_optax(name, config, clip) -> None:
    """Five steps on a small random tree, f32. The update rules are optax's
    written out; a few roundings per step fall in another order (optax
    divides by the bias correction where the port multiplies the step), and
    five steps add them up: 5e-6 relative, and 1e-6 (a few f32 ulps of the
    parameters, which are of order 1) for the entries near zero."""
    rng = np.random.RandomState(0)
    shapes = [(4, 3), (7,), (2, 3, 3, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * 3).astype(np.float32) for s in shapes] for _ in range(5)]
    tx = _jax_tx(name, 1e-2, config)
    if clip > 0:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    opt = TO.build_optimizer(name, 1e-2, **config)
    tp = [torch.from_numpy(p.copy()) for p in params]
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = [torch.from_numpy(x) for x in g]
        if clip > 0:
            tg = TO.clip_by_global_norm(tg, clip)
        opt.step(tp, tg)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-6, atol=1e-6)


# one module a case: its JAX leaves' shapes, and the port dimension of each weight's rows
ADAMP_BRIDGED = {
    "linear": (lambda: TLinear(8, 3), {"kernel": (8, 3), "bias": (3,)}, 1),
    "hwio_conv": (lambda: TConv(4, 5, (3, 3)), {"kernel": (3, 3, 4, 5), "bias": (5,)}, 2),
    "1d": (lambda: TLayerNorm(5), {"scale": (5,), "bias": (5,)}, 0),
}


def _adamp_through_the_bridge(case, dims):
    """Five AdamP steps (lr 1e-2, delta 0.5, weight decay 1e-2) on the case's JAX leaves against the port's on
    the same values carried through the bridge, with `dims` of each port parameter as its rows; both results in
    the port's layout."""
    make, shapes, _ = ADAMP_BRIDGED[case]
    net = torch.nn.Module()
    net.mod = make()
    rng = np.random.RandomState(3)
    params = {f"mod.{k}": rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*v.shape) * 3).astype(np.float32) for k, v in params.items()} for _ in range(5)]
    config = dict(weight_decay=1e-2, delta=0.5)
    tx = _jax_tx("adamp", 1e-2, config)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    names = [n for n, _ in net.named_parameters()]
    opt = TO.build_optimizer("adamp", 1e-2, **config)
    opt.rows = [TO.Rows(dims[n]) for n in names]
    tp = tree_from_nnx(params, net)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = tree_from_nnx(g, net)
        opt.step([tp[n] for n in names], [tg[n] for n in names])
    return tp, tree_from_nnx({k: np.asarray(v) for k, v in jp.items()}, net)


@pytest.mark.parametrize("case", sorted(ADAMP_BRIDGED))
def test_adamp_rows_are_the_jax_layouts(case) -> None:
    """AdamP projects the rows of the JAX layout's leading axis: a Linear's input axis and a conv's kh, which the
    bridge moves to port dimensions 1 and 2 (`jax_row_dims`). Held against `_adamp_transform` on the JAX leaves at
    `test_optimizers_match_optax`'s tolerance; a weight projected on the port's leading axis instead (its output
    axis) misses it."""
    make, _, weight_dim = ADAMP_BRIDGED[case]
    net = torch.nn.Module()
    net.mod = make()
    dims = jax_row_dims(net)
    assert dims == {"mod.weight": weight_dim, "mod.bias": 0}
    got, want = _adamp_through_the_bridge(case, dims)
    for n in got:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=5e-6, atol=1e-6, err_msg=n)
    if weight_dim:
        leading, _ = _adamp_through_the_bridge(case, dict.fromkeys(dims, 0))
        assert np.abs(leading["mod.weight"].numpy() - want["mod.weight"].numpy()).max() > 1e-4


def test_jax_adamp_climbs() -> None:
    """The reference's fault that `_jax_tx` corrects: on f(p) = |p|^2 the
    JAX registry's `adamp` raises f where `adam` lowers it; the port's
    `adamp` lowers it by the same steps."""
    p0 = np.full((4, 3), 2.0, np.float32)

    def run_jax(tx):
        p = jnp.asarray(p0)
        state = tx.init(p)
        for _ in range(3):
            updates, state = tx.update(2 * p, state, p)
            p = optax.apply_updates(p, updates)
        return float((p**2).sum())

    start = float((p0**2).sum())
    assert run_jax(build_optimizer("adamp", 0.1)) > start > run_jax(build_optimizer("adam", 0.1))
    opt, tp = TO.build_optimizer("adamp", 0.1), [torch.from_numpy(p0.copy())]
    for _ in range(3):
        opt.step(tp, [2 * tp[0]])
    assert float((tp[0] ** 2).sum()) == pytest.approx(run_jax(_jax_tx("adamp", 0.1, {})), rel=1e-5)


def test_optimizer_registry() -> None:
    assert set(TO.optimizer_dict) == {"sgd", "adam", "adamw", "rmsprop", "nadam", "adamp"}
    with pytest.raises(ValueError, match="not registered"):
        TO.build_optimizer("lamb", 1e-3)
    g = [torch.full((3,), 2.0), torch.full((4,), -2.0)]
    np.testing.assert_allclose(float(TO.global_norm(g)), np.sqrt(28.0), rtol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(TO.clip_by_global_norm(g, 100.0), g))  # below the limit: unchanged


# ---------------------------------------------------------------- the slice

LR = 1e-3


def _jax_step(jm, x0, noise, cond, t, bf16):
    """loss, gradients and AdamW-updated parameters of one eps-loss step."""
    gd, params, rest = nnx.split(jm, nnx.Param, ...)

    def loss_fn(p):
        if bf16:
            p = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), p)
        m = nnx.merge(gd, p, rest)
        x_t = m.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
        out = m.denoise(x_t, jnp.asarray(t), jnp.asarray(cond))
        per_sample = jnp.mean(jnp.square(out - jnp.asarray(noise)), axis=(1, 2, 3))
        return jnp.mean(per_sample).astype(jnp.float32)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)  # one program: eager dispatch is far slower
    tx = build_optimizer("adamw", LR)  # the JAX package's registry: weight decay 1e-2
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)

    def flat(tree):
        return {".".join(map(str, path)): np.asarray(v[...]) for path, v in nnx.to_flat_state(tree)}

    return float(loss), flat(grads), flat(new)


@pytest.fixture(scope="module")
def slice_pair():
    saved, A._INTERPRET = A._INTERPRET, True
    try:
        jm, tm = _pair()
        data = _batch(3)
        refs = {bf16: _jax_step(jm, *data, bf16) for bf16 in (False, True)}
    finally:
        A._INTERPRET = saved
    return jm, tm, data, refs


def _port_step(tm, data, compute_dtype, use_checkpoint=False):
    x0, noise, cond, t = data
    tm.unet.use_checkpoint = use_checkpoint
    model = TDDPMModel(tm)
    step = make_train_step(model, optimizer="adamw", lr=LR, compute_dtype=compute_dtype)
    batch = {"input": torch.from_numpy(x0), "cond": torch.from_numpy(cond)}
    before = {n: p.detach().clone() for n, p in model.params_filter("all")}
    try:
        losses = step.step(batch, t=torch.from_numpy(t), noise=torch.from_numpy(noise))
        after = {n: p.detach().clone() for n, p in model.params_filter("all")}
    finally:  # the model is shared between tests: put the parameters back
        with torch.no_grad():
            for n, p in model.params_filter("all"):
                p.copy_(before[n])
        tm.unet.use_checkpoint = False
    strip = len("m.")
    return float(losses["loss"]), {n[strip:]: g for n, g in step.grads.items()}, {n[strip:]: p for n, p in after.items()}


def _leaf_err(got, ref, floor) -> float:
    """max|got - ref| over the leaf's scale: its largest reference entry, but
    at least `floor`."""
    return float((got.float() - ref).abs().max()) / max(float(ref.abs().max()), floor)


def test_slice_uses_the_flash_route(slice_pair) -> None:
    _, tm, _, _ = slice_pair
    q = torch.empty((B, 4, SIZE * SIZE, 8), device="meta")
    assert TA.use_kernel(q, q)  # the level-0 self-attention: L = 256, 4 heads of 8


def test_train_step_f32_matches(slice_pair) -> None:
    jm, tm, data, refs = slice_pair
    ref_loss, ref_grads, ref_new = refs[False]
    loss, grads, new = _port_step(tm, data, None)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    want_g, want_p = tree_from_nnx(ref_grads, tm), tree_from_nnx(ref_new, tm)
    assert set(want_g) == set(grads) == set(new)
    floor = 1e-2 * max(float(r.abs().max()) for r in want_g.values())
    for name, ref in want_g.items():
        # f32 sums in another order, layer by layer, forward and backward: 1e-4
        # of the leaf's largest entry. Some leaves have a true gradient of zero
        # (a bias in front of a GroupNorm whose groups are single channels at
        # this width) and hold rounding noise only, ~1e-8 of the largest
        # gradient: those are held to 1e-4 of 1% of the largest gradient.
        assert _leaf_err(grads[name], ref, floor) < 1e-4, name
    old = dict(tm.named_parameters())
    gmax = floor / 1e-2
    for name, ref in want_p.items():
        before = old[name].detach()
        assert not torch.equal(new[name], before), name
        # AdamW's first step is lr * (g / (|g| + eps) + wd * p): no entry moves further
        moved = (new[name] - before).abs()
        assert bool((moved <= LR * (1.01 + 0.01 * before.abs())).all()), name
        # where |g| is far above eps = 1e-8 the step does not feel a gradient
        # difference of 1e-4 relative: those entries are held to 1% of one
        # step. Entries with |g| near eps (true zeros, holding rounding noise)
        # follow the noise's sign and are only bounded above.
        firm = want_g[name].abs() > 1e-5 * gmax
        assert bool(((new[name] - ref).abs()[firm] <= 1e-2 * LR).all()), name


def test_train_step_bf16_compute_matches(slice_pair) -> None:
    """bf16 compute, f32 masters. Both packages round every layer's output to
    bf16 (8 bits), at slightly different values, and the gradients pass back
    through ~20 such layers: the loss within 2 bf16 ulps, the whole gradient
    within 5% in the global norm, every leaf within 25% of its largest entry."""
    jm, tm, data, refs = slice_pair
    ref_loss, ref_grads, _ = refs[True]
    loss, grads, new = _port_step(tm, data, torch.bfloat16)
    assert abs(loss - ref_loss) <= 2.0**-7 * abs(ref_loss)
    want_g = tree_from_nnx(ref_grads, tm)
    num = sum(float((grads[n].float() - r).square().sum()) for n, r in want_g.items())
    den = sum(float(r.square().sum()) for r in want_g.values())
    assert (num / den) ** 0.5 < 5e-2
    floor = 1e-2 * max(float(r.abs().max()) for r in want_g.values())
    for name, ref in want_g.items():
        assert grads[name].dtype == torch.float32, name  # gradients come back to the f32 masters
        assert _leaf_err(grads[name], ref, floor) < 0.25, name
    # and it stays close to the f32 step: same loss within bf16 resolution
    assert abs(loss - refs[False][0]) <= 2.0**-6 * abs(refs[False][0])


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_checkpointing_gives_the_same_gradients(slice_pair, compute_dtype) -> None:
    _, tm, data, _ = slice_pair
    loss_a, grads_a, _ = _port_step(tm, data, compute_dtype, use_checkpoint=False)
    loss_b, grads_b, _ = _port_step(tm, data, compute_dtype, use_checkpoint=True)
    assert loss_a == loss_b
    for name, g in grads_a.items():
        # the recomputation repeats the same operations on the same values
        torch.testing.assert_close(grads_b[name], g, rtol=0, atol=0, msg=name)


def test_train_step_clips_by_the_global_norm(slice_pair) -> None:
    """Plain SGD at lr 1 moves the parameters by the clipped gradient: the
    step's global norm is the clip norm, its direction the gradient's."""
    _, tm, data, _ = slice_pair
    x0, noise, cond, t = data
    model = TDDPMModel(tm)
    step = make_train_step(model, optimizer="sgd", lr=1.0, clip_norm=1e-3)
    named = model.params_filter("all")
    before = [p.detach().clone() for _, p in named]
    try:
        step.step({"input": torch.from_numpy(x0), "cond": torch.from_numpy(cond)},
                  t=torch.from_numpy(t), noise=torch.from_numpy(noise))
        moved = [old - p.detach() for old, (_, p) in zip(before, named)]
    finally:
        with torch.no_grad():
            for old, (_, p) in zip(before, named):
                p.copy_(old)
    assert float(step.grad_norm) > 1e-3  # the clip engages
    np.testing.assert_allclose(float(TO.global_norm(moved)), 1e-3, rtol=1e-3)
    grads = list(step.grads.values())
    cos = sum(float((m * g).sum()) for m, g in zip(moved, grads)) / (1e-3 * float(step.grad_norm))
    assert cos > 0.999


def test_checkpoint_policy_strings_are_not_ported() -> None:
    """The policy names are ported now (`test_torch_checkpoint_policies.py`
    holds their steps against the JAX package's): a name builds, a name that
    is not a policy raises as in the JAX package."""
    tm = cflearn_torch.build(TDDPM, device="meta", unet_config=dict(UNET, use_checkpoint="dots_saveable"))
    assert tm.unet.use_checkpoint == "dots_saveable"
    with pytest.raises(ValueError, match="unknown remat policy"):
        cflearn_torch.build(TDDPM, device="meta", unet_config=dict(UNET, use_checkpoint="dots"))


def test_params_filter_and_post_step_update() -> None:
    _, tm = _pair()
    model = TDDPMModel(tm, ema_decay=0.9)
    names = [n for n, _ in model.params_filter("all")]
    assert names and all(n.startswith("m.unet.") for n in names)
    assert not [n for n, _ in model.named_parameters() if "ema" in n.split(".")]
    model.post_step_update()
    assert int(model.ema.num_updates) == 1
    # a frozen condition model and the first stage stay out of the trained set
    ldm = cflearn_torch.build(
        cflearn_torch.LDM, device="meta", img_size=8, unet_config=UNET,
        condition_model=torch.nn.Linear(3, 3),
        first_stage_config=dict(img_size=32, inner_channels=32, channel_multipliers=[1, 2], num_res_blocks=1),
    )
    trained = [n for n, _ in TDDPMModel(ldm).params_filter("all")]
    assert trained and not [n for n in trained if "first_stage" in n or "condition_model" in n]
    ldm.condition_learnable = True
    assert [n for n, _ in TDDPMModel(ldm).params_filter("all") if "condition_model" in n]


def test_finetune_unet_entry_point(monkeypatch) -> None:
    _, tm = _pair()
    x0, _, cond, _ = _batch(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cflearn_torch.finetune_unet(tm, x0, cond)
    out = cflearn_torch.finetune_unet(
        tm, x0, cond, num_steps=2, lr=1e-4, device="cpu", generator=torch.Generator().manual_seed(0)
    )
    assert out["losses"].shape == (2,) and torch.isfinite(out["losses"]).all()
    assert all(torch.isfinite(g).all() for g in out["step"].grads.values())
    assert float(out["step"].grad_norm) > 0


def test_bridge_carries_a_gradient_tree(slice_pair) -> None:
    jm, tm, _, refs = slice_pair
    grads = refs[False][1]
    tree = tree_from_nnx(grads, tm)
    assert set(tree) == {n for n, _ in tm.named_parameters()}
    k = "unet.conv_in.kernel"
    np.testing.assert_array_equal(tree["unet.conv_in.weight"].numpy(), grads[k].transpose(3, 2, 0, 1))
    # strict: a leaf outside the named subset raises, and so does a missing one
    with pytest.raises(ValueError, match="bridge errors"):
        tree_from_nnx(grads, tm, names=["unet.conv_in.weight"])
    with pytest.raises(ValueError, match="bridge errors"):
        tree_from_nnx({k: grads[k]}, tm)
    assert set(tree_from_nnx({k: grads[k]}, tm, names=["unet.conv_in.weight"])) == {"unet.conv_in.weight"}
    assert set(flat_params(jm)) == set(grads)
