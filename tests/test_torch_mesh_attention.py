"""Context-parallel attention and the pipeline over gloo ranks on the CPU.

`context_parallel_attention` at context = 4 (4 processes): the ring and
Ulysses, causal and not, held in value and in the gradients of q, k and v
to the JAX package's `context_parallel_attention` on the same seeded numpy
inputs (8 virtual devices, `data` 2 x `context` 4), at 2e-5 of the JAX
result's largest magnitude (f32: the ring merges its blocks by their
logsumexp in another order than JAX's online recurrence). "auto" on heads
that do not divide the axis takes the ring, and `sdp_attn` on a context
mesh routes a self-attention there. The ring with its ranks run in turn in
one process (`chip_smoke.ring_in_one_process`: the library's `ring_forward`
/ `ring_backward` over `chip_smoke.OneProcessRing`, what the card's check
runs) agrees with the dense attention and with its plain version, and the
card's gate on it (`chip_smoke.ring_gate`) fails a dropped block. `pipeline_apply` over pipe = 4 equals
the blocks run one after another (4 and 8 microbatches): the output and the
gradients at 2e-5 relative, as the JAX package's own test holds its
pipeline."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import _torch_bridge_common  # noqa: F401,E402
import _torch_mesh_common as C  # noqa: E402
import chip_smoke  # noqa: E402  (the card's one-process ring, run here on the CPU)


@pytest.fixture(scope="module")
def port_attention(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("attn")
    C.spawn(C.attention_worker, 4, tmp, str(tmp / "attn.npz"))
    with np.load(tmp / "attn.npz") as z:
        return {k: z[k] for k in z.files}


def _jax_attention(method, causal, heads=4):
    import jax
    import jax.numpy as jnp

    import _torch_mesh_jax as J
    from cflearn_tpu.ops.ring_attention import context_parallel_attention

    mesh = J.jax_mesh(data=2, context=4)
    q, k, v, w = (jnp.asarray(a) for a in C.attention_inputs(heads))

    def f(q, k, v):
        return context_parallel_attention(q, k, v, mesh, causal=causal, method=method)

    o = f(q, k, v)
    grads = jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * w), argnums=(0, 1, 2))(q, k, v)
    return {"o": np.asarray(o), "dq": np.asarray(grads[0]), "dk": np.asarray(grads[1]), "dv": np.asarray(grads[2])}


def _close(got, want, name):
    tol = 2e-5 * max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol, (name, float(np.abs(got - want).max()), tol)


@pytest.mark.parametrize("method", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_context_parallel_attention_matches_jax(port_attention, method, causal):
    want = _jax_attention(method, causal)
    for name in ("o", "dq", "dk", "dv"):
        _close(port_attention[f"{method}/{causal}/{name}"], want[name], f"{method} causal={causal} {name}")


def test_auto_takes_the_ring_and_sdp_attn_routes(port_attention):
    want = _jax_attention("auto", False, heads=3)
    for name in ("o", "dq", "dk", "dv"):
        _close(port_attention[f"auto3/{name}"], want[name], f"auto {name}")
    q, k, v, w = (torch.tensor(a, requires_grad=i < 3) for i, a in enumerate(C.attention_inputs()))
    o = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)
    (o * w).sum().backward()
    for name, ref in (("o", o.detach()), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        _close(port_attention[f"sdp/{name}"], ref.numpy(), f"sdp {name}")


def _ring_inputs():
    rs = np.random.RandomState(3)
    return [torch.from_numpy(rs.randn(1, 2, 256, 32).astype(np.float32)) for _ in range(4)]


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_reference_in_one_process(cp, causal):
    from cflearn_torch.ops.attention import flash_attention_plain, flash_fwd_with_lse_plain

    q, k, v, do = _ring_inputs()
    o, lses, grads = chip_smoke.ring_in_one_process(q, k, v, do, cp, causal=causal)
    o_plain, _, grads_plain = chip_smoke.ring_in_one_process(q, k, v, do, cp, causal=causal, plain=True)
    assert len(lses) == cp and lses[0].shape == (1, 2, 256 // cp)
    torch.testing.assert_close(o, o_plain, atol=0, rtol=0)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = torch.nn.functional.scaled_dot_product_attention(qq, kk, vv, is_causal=causal)
    ref.backward(do)
    torch.testing.assert_close(o, ref.detach(), atol=2e-5, rtol=0)
    for got, plain, want in zip(grads, grads_plain, (qq.grad, kk.grad, vv.grad)):
        torch.testing.assert_close(got, plain, atol=0, rtol=0)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert flash_fwd_with_lse_plain(q, k, v)[1].shape == (1, 2, 256)
    assert flash_attention_plain(q, k, v).shape == q.shape


@pytest.mark.parametrize("causal", [False, True])
def test_ring_gate_fails_a_dropped_block(causal):
    """The card's gate on the ring (each position against its own largest
    magnitude) passes the ring and fails it with the last rank's block
    against the first rank's keys dropped from dk and dv."""
    from cflearn_torch.ops.attention import flash_bwd_plain

    cp, rel = 4, 2.0**-6
    q, k, v, do = _ring_inputs()
    o, lses, grads = chip_smoke.ring_in_one_process(q, k, v, do, cp, causal=causal)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    torch.nn.functional.scaled_dot_product_attention(qq, kk, vv, is_causal=causal).backward(do)
    n = q.shape[2] // cp
    last = slice((cp - 1) * n, None)
    _, dk_b, dv_b = flash_bwd_plain(
        q[:, :, last], k[:, :, :n], v[:, :, :n], o[:, :, last], lses[-1], do[:, :, last], causal=False,
        sm_scale=q.shape[-1] ** -0.5,
    )
    for got, want, blk in ((grads[1], kk.grad, dk_b), (grads[2], vv.grad, dv_b)):
        assert chip_smoke.ring_gate(got, want, rel)[1] <= 1.0
        dropped = got.clone()
        dropped[:, :, :n] -= blk
        assert chip_smoke.ring_gate(dropped, want, rel)[1] > 1.0


def test_pipeline_apply_matches_sequential(tmp_path):
    C.spawn(C.pipeline_worker, 4, tmp_path, str(tmp_path / "pp"))
    for rank in range(4):
        with np.load(tmp_path / f"pp_{rank}.npz") as z:
            res = {k: z[k] for k in z.files}
        for m in (4, 8):
            for key in [k[len("seq/"):] for k in res if k.startswith("seq/")]:
                got, want = res[f"{m}/{key}"], res[f"seq/{key}"]
                rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
                assert rel < 2e-5, (rank, m, key, rel)
