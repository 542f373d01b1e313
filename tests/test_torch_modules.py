"""The port's modules against the JAX package's, one by one, in f32 on the
CPU. Each JAX module is built with `nnx.Rngs(0)` at a narrow width, its
zero-initialised kernels redrawn, and its parameters carried across by
`cflearn_torch.bridge`. Both get the same numpy inputs. Tolerances cover f32
summation order only (XLA vs PyTorch CPU kernels, online vs one-pass
softmax in the flash route), through a few normalised layers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from _torch_bridge_common import bridged, dezero
from cflearn_torch.modules.core.convs import ResidualBlockWithTimeEmbedding as TResBlock
from cflearn_torch.modules.core.mixed_stacks import SpatialTransformer as TSpatialTransformer
from cflearn_torch.modules.cv.ae import AttnDecoder as TAttnDecoder
from cflearn_torch.modules.multimodal.clip import TeTEncoder as TTeTEncoder
from cflearn_tpu.modules.core.convs import ResidualBlockWithTimeEmbedding
from cflearn_tpu.modules.core.mixed_stacks import SpatialTransformer
from cflearn_tpu.modules.cv.ae import AttnDecoder
from cflearn_tpu.modules.multimodal.clip import TeTEncoder
from cflearn_tpu.ops import attention as A


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    # flash-eligible shapes (L >= 256) run the Pallas kernel in interpret mode
    monkeypatch.setattr(A, "_INTERPRET", True)


def _close(got: torch.Tensor, ref, atol: float) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=1e-4)


@pytest.mark.parametrize("clip_skip", [0, 1])
def test_tet_encoder(clip_skip) -> None:
    kw = dict(vocab_size=100, context_length=77, latent_dim=64, num_layers=2, num_heads=4)
    jm = TeTEncoder(rngs=nnx.Rngs(0), **kw)
    tm = bridged(jm, TTeTEncoder(**kw))
    ids = np.random.RandomState(0).randint(0, 100, (2, 77))
    ref = jm(jnp.asarray(ids, jnp.int32), clip_skip=clip_skip)
    got = tm(torch.from_numpy(ids), clip_skip=clip_skip)
    _close(got, ref, 1e-4)


def test_spatial_transformer() -> None:
    """16x16 tokens: the self-attention takes the flash route (L = 256)."""
    jm = dezero(SpatialTransformer(64, 4, 16, context_dim=32, rngs=nnx.Rngs(0)))
    tm = bridged(jm, TSpatialTransformer(64, 4, 16, context_dim=32))
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 16, 64).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    ref = jm(jnp.asarray(x), jnp.asarray(ctx))
    got = tm(torch.from_numpy(x), torch.from_numpy(ctx))
    _close(got, ref, 1e-4)


def test_residual_block_with_time_embedding() -> None:
    jm = dezero(ResidualBlockWithTimeEmbedding(64, 128, time_embed_dim=32, rngs=nnx.Rngs(0)))
    tm = bridged(jm, TResBlock(64, 128, time_embed_dim=32))
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 64).astype(np.float32)
    emb = rng.randn(2, 32).astype(np.float32)
    ref = jm(jnp.asarray(x), jnp.asarray(emb))
    got = tm(torch.from_numpy(x), torch.from_numpy(emb))
    _close(got, ref, 1e-4)


def test_attn_decoder() -> None:
    """16x16 latents: the mid-block attention takes the flash route."""
    kw = dict(img_size=32, inner_channels=32, z_channels=4, channel_multipliers=[1, 2], num_res_blocks=1)
    jm = AttnDecoder(rngs=nnx.Rngs(0), **kw)
    tm = bridged(jm, TAttnDecoder(**kw))
    z = np.random.RandomState(3).randn(1, 16, 16, 4).astype(np.float32)
    ref = jm(jnp.asarray(z))
    got = tm(torch.from_numpy(z))
    assert tuple(got.shape) == (1, 32, 32, 3)
    _close(got, ref, 2e-4)


def test_redraw_zero_init() -> None:
    """The seeded redraw reaches every `zero_module`-marked module, and only
    those, and the same seed gives the same weights."""
    from cflearn_torch.modules.common import init_parameters, redraw_zero_init

    def build():
        return init_parameters(TResBlock(64, 128, time_embed_dim=32), seed=0)

    a, b = build(), build()
    marked = [m for m in a.modules() if getattr(m, "zero_init", False)]
    assert marked and all(not p.any() for m in marked for p in m.parameters())
    before = {k: v.clone() for k, v in a.state_dict().items()}
    assert redraw_zero_init(a, seed=1) == len(marked) == redraw_zero_init(b, seed=1)
    assert all(p.any() for m in marked for p in m.parameters() if p.ndim > 1)
    marked_names = {
        f"{n}.{k}"
        for n, m in a.named_modules()
        if getattr(m, "zero_init", False)
        for k, _ in m.named_parameters()
    }
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
        if k not in marked_names:
            assert torch.equal(v, before[k])
