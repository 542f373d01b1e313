"""The port's conv VJP, weight-gradient and GroupNorm(+SiLU) ops against the
JAX package's.

The JAX Pallas kernels run in interpret mode on the CPU (the module attribute
is patched, as the JAX kernel tests do); the port's CPU path is each kernel's
plain PyTorch version. Everything runs in f32 and is held to 1e-5 of the
reference's largest value: the tolerance covers another summation order only
(nine tap products against one transposed convolution; group sums of x and
x^2 against a two-pass variance)."""

import copy
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cflearn_torch.ops import conv as TC
from cflearn_torch.ops import group_norm as TG
from cflearn_tpu.ops import conv as C

# the package re-exports the function `group_norm` over its submodule's name
G = importlib.import_module("cflearn_tpu.ops.group_norm")

REL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(C, "_INTERPRET", True)
    monkeypatch.setattr(G, "_INTERPRET", True)


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _close(got, ref, rel=REL) -> None:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


def _to_port_weight(w_hwio: np.ndarray) -> torch.Tensor:
    """(3, 3, C, Co) -> the port kernels' (Co, 3, 3, C)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w_hwio, (3, 0, 1, 2))))


def _from_port_weight(w_ohwi: torch.Tensor) -> np.ndarray:
    return np.transpose(w_ohwi.detach().numpy(), (1, 2, 3, 0))


# ---------------------------------------------------------------- weight gradient


@pytest.mark.parametrize("shape,co", [((2, 8, 16, 128), 256), ((3, 6, 10, 64), 96)])
def test_wgrad_plain_matches_pallas_and_xla(interpret, shape, co) -> None:
    """H != W and C != Co, so that a wrong axis or a transposed tap shows."""
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    dy = rng.randn(*shape[:3], co).astype(np.float32)
    got = _from_port_weight(TC.conv3x3_wgrad(torch.from_numpy(x), torch.from_numpy(dy)))
    assert got.shape == (3, 3, shape[-1], co)
    _close(got, C._xla_conv3x3_wgrad(jnp.asarray(x), jnp.asarray(dy)))
    _close(got, C.conv3x3_wgrad_pallas(jnp.asarray(x), jnp.asarray(dy)))


def test_wgrad_plain_matches_torch_autograd() -> None:
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 5, 7, 16).astype(np.float32))
    dy = torch.from_numpy(rng.randn(2, 5, 7, 24).astype(np.float32))
    w = torch.zeros((24, 3, 3, 16), requires_grad=True)
    (ref,) = torch.autograd.grad(TC.conv3x3_plain(x, w), w, dy)
    _close(TC.conv3x3_wgrad_plain(x, dy).numpy(), ref.numpy())


def test_flip_weights_gives_the_input_gradient() -> None:
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 5, 7, 16).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.randn(24, 3, 3, 16).astype(np.float32) * 0.1)
    dy = torch.from_numpy(rng.randn(2, 5, 7, 24).astype(np.float32))
    (ref,) = torch.autograd.grad(TC.conv3x3_plain(x, w), x, dy)
    flipped = TC.flip_weights(w)
    assert tuple(flipped.shape) == (16, 3, 3, 24)
    _close(TC.conv3x3_plain(dy, flipped).numpy(), ref.numpy())
    # the JAX package's `_flip_weights`, carried into the port's layout
    w_hwio = jnp.asarray(_from_port_weight(w))
    np.testing.assert_array_equal(_from_port_weight(flipped), np.asarray(C._flip_weights(w_hwio)))


@pytest.mark.parametrize("with_bias", [True, False])
def test_conv_function_backward_matches_jax_grad(interpret, monkeypatch, with_bias) -> None:
    """`Conv3x3Function` (forward kernel, dx through the forward kernel with
    flipped weights, dw through the weight-gradient kernel, db) against
    `jax.grad` of the JAX `conv3x3` with both of its backward kernels forced
    on. On the CPU the port's kernel launcher is replaced by the plain
    forward; the function's own wiring is what runs."""
    monkeypatch.setattr(C, "_shape_wins", lambda *a: True)
    monkeypatch.setattr(C, "_wgrad_shape_wins", lambda *a: True)
    monkeypatch.setattr(TC, "_launch_conv3x3", TC.conv3x3_plain)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 16, 128).astype(np.float32)
    w = (rng.randn(3, 3, 128, 256) * 0.05).astype(np.float32)
    b = (rng.randn(256) * 0.1).astype(np.float32) if with_bias else None
    dy = rng.randn(2, 8, 16, 256).astype(np.float32)

    def f(x_, w_, b_):
        return jnp.sum(C.conv3x3(x_, w_, b_) * dy)

    argnums = (0, 1, 2) if with_bias else (0, 1)
    ref = jax.grad(f, argnums=argnums)(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b))

    xt = torch.from_numpy(x).requires_grad_()
    wt = _to_port_weight(w).requires_grad_()
    bt = None if b is None else torch.from_numpy(b).requires_grad_()
    y = TC.Conv3x3Function.apply(xt, wt, bt)
    _close(y.detach().numpy(), C._xla_conv3x3(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b)))
    inputs = (xt, wt, bt) if with_bias else (xt, wt)
    got = torch.autograd.grad(y, inputs, torch.from_numpy(dy))
    _close(got[0].numpy(), ref[0])
    _close(_from_port_weight(got[1]), ref[1])
    if with_bias:
        _close(got[2].numpy(), ref[2])


def test_conv3x3_on_cpu_carries_gradients_through_the_plain_version() -> None:
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(1, 4, 6, 8).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.randn(16, 3, 3, 8).astype(np.float32)).requires_grad_()
    y = TC.conv3x3(x, w)
    assert y.grad_fn is not None and not isinstance(y.grad_fn, TC.Conv3x3Function._backward_cls)
    gx, gw = torch.autograd.grad(y.sum(), (x, w))
    _close(gw.numpy(), TC.conv3x3_wgrad_plain(x.detach(), torch.ones_like(y)).numpy())


@pytest.mark.parametrize(
    "images,c,co",
    [((8, 256, 256), 128, 128), ((8, 64, 64), 512, 512), ((2, 5, 7), 64, 96), ((1, 1, 257), 64, 64), ((3, 33, 47), 64, 136)],
)
def test_wgrad_splits_cover_every_k_tile(images, c, co) -> None:
    plan = TC.wgrad_plan(*images, c, co)
    kt = plan.k_tiles  # K steps of one image row of 64 columns each
    assert kt == images[0] * images[1] * -(-images[2] // 64)
    splits, per = plan.splits, plan.per
    assert splits == TC.wgrad_splits(kt, c, co) and per == -(-kt // splits)
    assert splits >= 1 and per * splits >= kt and per * (splits - 1) < kt  # every split non-empty


def test_wgrad_tolerance_catches_a_dropped_tap() -> None:
    """`chip_smoke.py` holds the weight-gradient kernel to WGRAD_REL *
    max|ref| in bf16. A kernel that drops one tap, or shifts one tap's window
    by a pixel, exceeds it."""
    tol_rel = _smoke().WGRAD_REL
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 12, 20, 32).astype(np.float32)).bfloat16()
    dy = torch.from_numpy(rng.randn(2, 12, 20, 48).astype(np.float32)).bfloat16()
    ref = TC.conv3x3_wgrad_plain(x, dy).float()
    dropped = ref.clone()
    dropped[:, 1, 2] = 0.0
    shifted = ref.clone()
    shifted[:, 0, 1] = ref[:, 0, 2]
    limit = tol_rel * ref.abs().max().item()
    assert (TC.conv3x3_wgrad_plain(x.float(), dy.float()) - ref).abs().max().item() <= limit
    for bad in (dropped, shifted):
        assert (bad - ref).abs().max().item() > limit


# ---------------------------------------------------------------- GroupNorm (+ SiLU)


def _gn_inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.2 * rng.randn(shape[-1])).astype(np.float32)
    b = (0.2 * rng.randn(shape[-1])).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,groups", [((2, 8, 16, 64), 32), ((2, 24, 96), 8)])
def test_gn_plain_matches_pallas_and_xla(interpret, silu, shape, groups) -> None:
    x, w, b = _gn_inputs(shape)
    got = TG.group_norm_silu(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), num_groups=groups, eps=1e-6, apply_silu=silu
    ).numpy()
    kw = dict(num_groups=groups, eps=1e-6, apply_silu=silu)
    _close(got, G._group_norm_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw))
    flat = jnp.asarray(x).reshape(shape[0], -1, shape[-1])
    ref = G._group_norm_pallas(flat, jnp.asarray(w), jnp.asarray(b), **kw)
    _close(got.reshape(flat.shape), ref)


@pytest.mark.parametrize("silu", [False, True])
def test_fused_group_norm_gradients_match_jax(interpret, silu) -> None:
    x, w, b = _gn_inputs((2, 8, 8, 64), seed=1)
    dy = np.random.RandomState(2).randn(2, 8, 8, 64).astype(np.float32)

    def f(x_, w_, b_):
        return jnp.sum(G.fused_group_norm(x_, w_, b_, 32, 1e-6, silu) * dy)

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = TG.fused_group_norm(xt, wt, bt, 32, 1e-6, silu)
    assert isinstance(y.grad_fn, TG.FusedGroupNorm._backward_cls)
    got = torch.autograd.grad(y, (xt, wt, bt), torch.from_numpy(dy))
    for g, r in zip(got, ref):
        _close(g.numpy(), r)


def test_fused_group_norm_without_gradients_builds_no_graph() -> None:
    x, w, b = (torch.from_numpy(a) for a in _gn_inputs((1, 4, 4, 32)))
    assert TG.fused_group_norm(x, w, b, 8).grad_fn is None
    x.requires_grad_()
    with torch.no_grad():
        assert TG.fused_group_norm(x, w, b, 8).grad_fn is None
    # only x needs a gradient: the parameters get none
    y = TG.fused_group_norm(x, w, b, 8, 1e-6, True)
    (gx,) = torch.autograd.grad(y.sum(), x)
    assert gx.shape == x.shape


def test_fused_group_norm_under_functional_call_and_checkpoint() -> None:
    """The trainer's setting: parameters swapped for cast copies by
    `functional_call`, the block recomputed by a non-reentrant checkpoint, the
    backward inside the swap. The gradients reach the masters in their dtype
    and equal the plain path's."""
    from torch.func import functional_call
    from torch.utils.checkpoint import checkpoint

    from cflearn_torch.modules.layers import GroupNorm
    from cflearn_torch.trainer import _Call

    gn = GroupNorm(32, num_groups=8)
    with torch.no_grad():
        gn.weight.copy_(torch.linspace(0.5, 1.5, 32))
        gn.bias.copy_(torch.linspace(-0.2, 0.2, 32))
    x = torch.from_numpy(_gn_inputs((2, 4, 4, 32), seed=3)[0]).requires_grad_()
    leaves = [x] + list(gn.parameters())

    def grads(fn):
        def run():
            out = checkpoint(lambda t: fn(t, gn.weight, gn.bias), x.double(), use_reentrant=False)
            return torch.autograd.grad(out.square().sum(), leaves)

        cast = {f"module.{n}": p.double() for n, p in gn.named_parameters()}
        return functional_call(_Call(gn, run), cast, ())

    fused = grads(lambda t, w, b: TG.FusedGroupNorm.apply(t, w, b, 8, 1e-6, True))
    plain = grads(lambda t, w, b: TG.group_norm_silu_plain(t, w, b, num_groups=8, eps=1e-6, apply_silu=True))
    for g, r in zip(fused, plain):
        assert g.dtype == torch.float32
        _close(g.numpy(), r.numpy(), 1e-6)


def test_gn_kernel_plan_covers_the_rows() -> None:
    for batch, spatial, c, size in [(8, 65536, 128, 2), (1, 262144, 128, 2), (2, 64, 1280, 2), (2, 63, 36, 2), (3, 221, 96, 4), (1, 1, 32, 2), (2, 16, 8192, 2)]:
        slabs, rows = TG.kernel_plan(batch, spatial, c, size)
        assert slabs >= 1 and slabs * rows >= spatial and (slabs - 1) * rows < spatial


def test_module_call_keeps_the_default_path_on_cpu() -> None:
    """CPU tensors take the default path (SiLU after the cast, the promoted
    dtype); bf16 input with f32 parameters leaves as f32, as flax promotes."""
    x, w, b = (torch.from_numpy(a) for a in _gn_inputs((1, 4, 4, 32)))
    out = TG.module_call(x.bfloat16(), w, b, num_groups=8, eps=1e-6, apply_silu=True)
    assert out.dtype == torch.float32
    ref = TG.group_norm(x.bfloat16(), w, b, num_groups=8, eps=1e-6, apply_silu=True)
    assert torch.equal(out, ref)
    assert not TG.kernel_eligible(x, None, None, 8) and not TG.kernel_eligible(x, w, b, 5)
    assert TG.kernel_eligible(x, w, b, 8)


def test_gn_variance_clamp_on_a_constant_group() -> None:
    """The one place where the port's kernel arithmetic differs from the TPU
    kernel's: E[x^2] - mean^2 is clamped at 0. For a constant group the
    difference can round below -eps in f32, and rsqrt of a negative number is
    NaN; with the clamp the result is finite."""
    w, b = torch.ones(8), torch.full((8,), 0.25)
    negative = 0
    for value in (0.1, 300.7, 1000.1, 12345.678):
        x = torch.full((1, 64, 8), value)
        xf = x.reshape(1, 64, 2, 4)
        var = xf.square().mean(dim=(1, 3)) - xf.mean(dim=(1, 3)).square()
        negative += int((var + 1e-6 < 0).any())
        out = TG.group_norm_silu(x, w, b, num_groups=2, eps=1e-6)
        assert torch.isfinite(out).all()
    assert negative > 0  # the case the clamp exists for occurs among these


def test_gn_tolerance_catches_planted_faults() -> None:
    """`chip_smoke.py` holds the GroupNorm kernel to GN_REL * max|ref| in
    bf16. A kernel that forgets `- mean^2` in the variance, applies SiLU after
    the bf16 cast of a shifted result wrongly (drops the bias), or takes the
    statistics over the wrong group width exceeds it; the plain version in
    f32 against itself in bf16 output does not."""
    tol_rel = _smoke().GN_REL
    x, w, b = (torch.from_numpy(a) for a in _gn_inputs((2, 16, 16, 64), seed=4))
    xb = x.bfloat16()
    ref = TG.group_norm_silu_plain(xb, w, b, num_groups=32, eps=1e-6, apply_silu=True).float()
    limit = tol_rel * ref.abs().max().item()

    def faulty(kind: str) -> torch.Tensor:
        xf = xb.float().reshape(2, -1, 32, 2)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        mean2 = xf.square().mean(dim=(1, 3), keepdim=True)
        var = mean2 if kind == "no_mean_sq" else mean2 - mean.square()
        y = ((xf - mean) * torch.rsqrt(var + 1e-6)).reshape(xb.shape) * w
        if kind != "no_bias":
            y = y + b
        y = y * torch.sigmoid(y)
        return y.bfloat16().float()

    assert (faulty("none") - ref).abs().max().item() <= limit
    for kind in ("no_mean_sq", "no_bias"):
        assert (faulty(kind) - ref).abs().max().item() > limit
    wrong_groups = TG.group_norm_silu_plain(xb, w, b, num_groups=16, eps=1e-6, apply_silu=True).float()
    assert (wrong_groups - ref).abs().max().item() > limit


# ---------------------------------------------------------------- the ae parity gate


@pytest.mark.parametrize("fault", ["none", "zeroed_module", "dropped_tap", "halved_bias"])
def test_ae_parity_gate_catches_planted_faults(fault) -> None:
    """`chip_smoke.py`'s ae parity (`ae_parity`) on a small conv / GroupNorm
    net in f32: a kernel path equal to the plain one passes; one whose
    gradient lost a module's weight gradient, one tap of a conv weight's, or
    half of a conv bias's (more than the bias's share of its module's drift)
    fails, and the failure names the module. The reading against an f64
    reference puts the plain path at f32 rounding and the fault far above it."""
    S = _smoke()
    from cflearn_torch.ops import attention as TA

    torch.manual_seed(0)
    net = torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.GroupNorm(2, 8), torch.nn.SiLU(), torch.nn.Conv2d(8, 3, 3, padding=1)
    )
    with torch.no_grad():
        net[0].bias.mul_(20.0)  # a bias gradient of a size that shows in its module's norm
    calls = []

    def fwd_bwd(x):
        net.zero_grad()
        loss = (net(x) - x.flip(-1)).square().mean()
        loss.backward()
        grads = {f"m.{n}": p.grad.detach().clone() for n, p in net.named_parameters()}
        if not calls:  # the first call is the kernel path's
            if fault == "zeroed_module":
                grads["m.3.weight"].zero_()
            elif fault == "dropped_tap":
                grads["m.0.weight"][:, :, 0, 0] = 0.0
            elif fault == "halved_bias":
                grads["m.0.bias"].mul_(0.5)
        calls.append(x)
        return loss.item(), grads

    def reference(x):  # the same gradients in f64
        net64 = copy.deepcopy(net).double()
        (net64(x.double()) - x.double().flip(-1)).square().mean().backward()
        return {f"m.{n}": p.grad.float() for n, p in net64.named_parameters()}

    images = torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(1)).clamp(-1.0, 1.0)
    result = S.ae_parity(torch, fwd_bwd, images, TA, TC, TG, reference)
    assert len(calls) == 6  # kernels, plain, and four one-ulp moves
    assert result["modules"]["modules"] == 3 and set(result["module_drift_and_error"]) == {"m.0", "m.1", "m.3"}
    accuracy = result["accuracy"]["modules"]
    assert set(accuracy) == {"m.0", "m.1", "m.3"} and all(p < 1e-5 for _, p in accuracy.values())
    if fault == "none":
        assert result["failure"] is None and result["modules"]["err_max"] == 0.0
    else:
        assert result["failure"] is not None
        module = "m.3" if fault == "zeroed_module" else "m.0"
        assert result["ratio"][module] > S.AE_PARITY_FACTOR
        assert accuracy[module][0] > 1e3 * accuracy[module][1]
