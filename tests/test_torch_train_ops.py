"""The port's trainable flash attention against the JAX package's.

The JAX Pallas kernels (forward with logsumexp, fused and split backward) run
in interpret mode on the CPU; the port's CPU path is each kernel's plain
PyTorch version. In f32 the tolerances cover a different summation order only
(blockwise online softmax and per-block partial sums on the JAX side, one
pass in the plain versions)."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cflearn_torch.ops import attention as TA
from cflearn_torch.ops import conv as TC
from cflearn_tpu.ops import attention as A


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(A, "_INTERPRET", True)


def _inputs(lq, lk, d, bh=(1, 2), seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    b, h = bh
    return tuple(rng.randn(b, h, n, d).astype(dtype) for n in (lq, lk, lk, lq))  # q, k, v, dO


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x, np.float32))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk,d", [(1000, 777, 40), (300, 300, 64), (256, 256, 160)])
def test_fwd_with_lse_plain_matches_pallas(interpret, causal, lq, lk, d) -> None:
    q, k, v, _ = _inputs(lq, lk, d)
    ref_o, ref_lse = A._flash_fwd_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None)
    o, lse = TA.flash_fwd_lse(_t(q), _t(k), _t(v), causal=causal)
    assert lse.shape == (1, 2, lq) and lse.dtype == torch.float32  # no padded rows
    # f32: the JAX kernel sums its blocks online, the plain version in one pass
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=2e-5, rtol=1e-5)
    ref_lse = np.asarray(ref_lse)[:, :lq, 0].reshape(1, 2, lq)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=2e-5, rtol=1e-5)


def _jax_grads(fn, q, k, v, do, causal):
    def loss(q_, k_, v_):
        return jnp.sum(fn(q_, k_, v_, causal).astype(jnp.float32) * do.astype(jnp.float32))

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _port_grads(q, k, v, do, causal):
    o, lse = TA.flash_fwd_with_lse_plain(q, k, v, causal=causal)
    return TA.flash_bwd_plain(q, k, v, o, lse, do, causal=causal)


BWD_CASES = [
    # (Lq, Lk, d, (b, h)): one block; ragged; the 1024-row blocks of `_bwd_blocks` in a 2 x 2 grid
    (256, 256, 40, (1, 2)),
    (1000, 777, 64, (1, 2)),
    (1100, 1300, 16, (1, 1)),
]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk,d,bh", BWD_CASES)
def test_bwd_plain_matches_pallas(interpret, monkeypatch, fused, causal, lq, lk, d, bh) -> None:
    monkeypatch.setattr(A, "_FUSED_BWD", fused)
    q, k, v, do = _inputs(lq, lk, d, bh, seed=1)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    ref = _jax_grads(lambda a, b, c, cs: A.flash_attention_trainable(a, b, c, cs, None), jq, jk, jv, jdo, causal)
    xla = _jax_grads(lambda a, b, c, cs: A.xla_attention(a, b, c, causal=cs), jq, jk, jv, jdo, causal)
    got = _port_grads(_t(q), _t(k), _t(v), _t(do), causal)
    for name, g, r, x in zip(("dq", "dk", "dv"), got, ref, xla):
        scale = float(np.abs(np.asarray(x)).max())
        # f32 sums in another order: 1e-5 of the gradient's scale
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5 * scale, rtol=1e-5, err_msg=f"{name} vs pallas")
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-5 * scale, rtol=1e-4, err_msg=f"{name} vs xla")


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_pallas_bf16(interpret, causal) -> None:
    """bf16 inputs: both sides cast p and ds to bf16 before their products and
    round the gradients to bf16, at block boundaries that differ; two bf16 ulps
    (2^-7) of each gradient's largest value."""
    q, k, v, do = _inputs(300, 300, 64, seed=2)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    ref = _jax_grads(lambda a, b, c, cs: A.flash_attention_trainable(a, b, c, cs, None), jq, jk, jv, jdo, causal)
    got = _port_grads(*(_t(x, torch.bfloat16) for x in (q, k, v, do)), causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        assert np.abs(g.float().numpy() - r).max() <= 2.0**-7 * np.abs(r).max(), name


def _naive(q, k, v, causal, scale):
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("causal", [False, True])
def test_trainable_matches_autograd_of_naive_attention(causal) -> None:
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 2, 130, 24), generator=g, requires_grad=True) for _ in range(3))
    do = torch.randn((2, 2, 130, 24), generator=g)
    out = TA.flash_attention_trainable(q, k, v, causal, 0.3)
    ref = _naive(q, k, v, causal, 0.3)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(ref, (q, k, v), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4)


def test_trainable_is_an_autograd_function_and_routes(monkeypatch) -> None:
    assert issubclass(TA.FlashAttentionTrainable, torch.autograd.Function)
    calls = []
    for name in ("flash_attention", "flash_fwd_lse", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"):
        fn = getattr(TA, name)
        monkeypatch.setattr(TA, name, lambda *a, _fn=fn, _n=name, **kw: (calls.append(_n), _fn(*a, **kw))[1])
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn((1, 2, 256, 16), generator=g) for _ in range(3))
    # nothing needs a gradient: the inference forward, no graph
    out = TA.sdp_attn(q, k, v)
    assert calls == ["flash_attention"] and out.grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert TA.sdp_attn(q, k, v).grad_fn is None
    assert calls == ["flash_attention"] * 2
    # a gradient to carry: forward with lse, fused backward
    calls.clear()
    out = TA.sdp_attn(q, k, v)
    assert out.grad_fn is not None and calls == ["flash_fwd_lse"]
    out.sum().backward()
    assert calls == ["flash_fwd_lse", "flash_bwd_fused"] and q.grad is not None
    fused_grad, q.grad = q.grad.clone(), None
    # the split pair: by the module attribute, and under deterministic algorithms
    calls.clear()
    monkeypatch.setattr(TA, "FUSED_BWD", False)
    TA.sdp_attn(q, k, v).sum().backward()
    assert calls == ["flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"]
    torch.testing.assert_close(q.grad, fused_grad)
    monkeypatch.setattr(TA, "FUSED_BWD", True)
    calls.clear()
    torch.use_deterministic_algorithms(True)
    try:
        TA.sdp_attn(q, k, v).sum().backward()
    finally:
        torch.use_deterministic_algorithms(False)
    assert calls == ["flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"]


def test_sdp_attn_library_branch_keeps_its_graph() -> None:
    q = torch.randn((1, 2, 64, 16), requires_grad=True)
    kv = torch.randn((1, 2, 77, 16))
    assert TA.sdp_attn(q, kv, kv).grad_fn is not None


def test_conv_kernel_refuses_tensors_that_need_a_gradient(monkeypatch) -> None:
    """On the card the bare kernel launch never takes a tensor that needs a
    gradient, so none comes back without a `grad_fn`: such a call goes through
    `Conv3x3Function` (the conv VJP), and only a call with nothing to
    differentiate reaches the launcher directly. A stand-in with a CUDA device
    shows the routing here; `tests/test_torch_cuda.py` shows it on the card."""
    routed = []
    monkeypatch.setattr(TC.Conv3x3Function, "apply", lambda *args: routed.append("function"))
    monkeypatch.setattr(TC, "_launch_conv3x3", lambda *args: routed.append("kernel"))
    w = torch.zeros((64, 3, 3, 64))
    x = SimpleNamespace(device=torch.device("cuda"), requires_grad=True)
    TC.conv3x3(x, w)
    x.requires_grad = False
    TC.conv3x3(x, w.requires_grad_())
    TC.conv3x3(x, w.detach(), torch.zeros(64, requires_grad=True))
    assert routed == ["function"] * 3
    TC.conv3x3(x, w.detach())
    with torch.no_grad():
        x.requires_grad = True
        TC.conv3x3(x, w)
    assert routed[3:] == ["kernel"] * 2
    # on the CPU the plain version carries the gradient
    xc = torch.randn((1, 4, 4, 64), requires_grad=True)
    assert TC.conv3x3(xc, w).grad_fn is not None


def test_conv_module_weight_follows_the_parameter_under_training() -> None:
    from cflearn_torch.modules.layers import Conv

    conv = Conv(8, 8)
    torch.nn.init.normal_(conv.weight)
    with torch.no_grad():
        cached = conv.kernel_weight()
        assert conv.kernel_weight() is cached
    w = conv.kernel_weight()
    assert w.grad_fn is not None  # on the graph, so dW reaches the parameter
    w.sum().backward()
    assert conv.weight.grad is not None


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("l,d", [(1024, 80), (256, 160), (1024, 40)])
def test_bwd_tolerance_catches_faults(l, d) -> None:
    """`chip_smoke.py` holds dq, dk, dv of the backward kernels to
    FLASH_REL * max|ref| in bf16. A backward that drops the `- delta` term,
    skips the last kv tile (64 keys) or forgets `sm_scale` on dq must exceed
    that limit in the gradient it corrupts."""
    tol_rel = _smoke().FLASH_REL
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((1, 2, l, d), generator=g).bfloat16() for _ in range(4))
    o, lse = TA.flash_fwd_with_lse_plain(q, k, v)
    dq, dk, dv = (t.float() for t in TA.flash_bwd_plain(q, k, v, o, lse, do))
    scale = d**-0.5
    p = torch.exp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale - lse.unsqueeze(-1))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    no_delta = (p * dp).bfloat16().float()
    dq_short, _, _ = TA.flash_bwd_plain(q, k[:, :, :-64], v[:, :, :-64], o, lse, do)
    faults = {
        "dq_without_delta": (scale * torch.matmul(no_delta, k.float()), dq),
        "dk_without_delta": (scale * torch.matmul(no_delta.transpose(-1, -2), q.float()), dk),
        "dq_skips_last_kv_tile": (dq_short.float(), dq),
        "dq_without_sm_scale": (dq / scale, dq),
    }
    for name, (bad, ref) in faults.items():
        err = (bad.bfloat16().float() - ref).abs().max().item()
        assert err > tol_rel * ref.abs().max().item(), name
