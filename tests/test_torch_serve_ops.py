"""The serving levers of the port against the JAX package's, piece by piece,
on the CPU: the CLIP tokenizer, ToMe, the DeepCache refresh schedule and the
UNet's shallow pass, the W8A8 quantisation and conv, and the dj-folded conv.

The JAX Pallas conv kernels run in interpret mode (the module attribute is
patched, as the JAX kernel tests do); the port's CPU path is each kernel's
plain version. f32 unless a case says otherwise; the tolerances cover f32
summation order only, except where integer arithmetic makes both exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from _torch_bridge_common import bridged, dezero, rel_err
import cflearn_torch
from cflearn_torch.modules.core import tome as TT
from cflearn_torch.modules.core.mixed_stacks import SpatialTransformer as TSpatialTransformer
from cflearn_torch.modules.cv.ae import AttnDecoder as TAttnDecoder
from cflearn_torch.modules.multimodal.diffusion import samplers as TS
from cflearn_torch.modules.nlp.tokenizers import CLIPTokenizer as TCLIPTokenizer
from cflearn_torch.ops import conv as TC
from cflearn_tpu.modules.core import tome as JT
from cflearn_tpu.modules.core.mixed_stacks import SpatialTransformer
from cflearn_tpu.modules.cv.ae import AttnDecoder
from cflearn_tpu.modules.multimodal.diffusion import samplers as JS
from cflearn_tpu.modules.multimodal.diffusion.ddpm import DDPM
from cflearn_tpu.modules.nlp.tokenizers import CLIPTokenizer
from cflearn_tpu.ops import conv as C

# the synthetic merges table of `tests/test_tokenizer_bpe.py` (rank order)
SYNTH_MERGES = """#version: synthetic-test
l l
h e
he ll
hell o</w>
l o</w>
"""
PROMPTS = [
    "hello hello, hell & helo",
    "a photo of a café in São Paulo, 2023 — naïve Ünïcödé 東京 😀",
    "fish &amp; chips &lt;b&gt;bold&lt;/b&gt; &amp;amp; it's",
    "",
    " ".join(f"word{i} hello" for i in range(60)),  # well past 77 tokens
]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(C, "_INTERPRET", True)


# ---------------------------------------------------------------- tokenizer


@pytest.mark.parametrize("merges", [True, False], ids=["synthetic_merges", "byte_fallback"])
def test_tokenizer_ids_match(tmp_path, merges) -> None:
    path = None
    if merges:
        path = tmp_path / "merges.txt"
        path.write_text(SYNTH_MERGES, encoding="utf-8")
        path = str(path)
    ref, tok = CLIPTokenizer(bpe_path=path), TCLIPTokenizer(bpe_path=path)
    assert tok.provenance == ref.provenance == ("bpe-merges" if merges else "byte-fallback")
    got = tok.tokenize(PROMPTS)
    want = ref.tokenize(PROMPTS)
    assert got.shape == (len(PROMPTS), 77) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # SOT first, EOT last on the long prompt, which is cut to 77
    assert got[-1, 0] == tok.sot_token and got[-1, -1] == tok.eot_token
    assert tok.tokenize("hello")[0, 1] != tok.tokenize("hell")[0, 1] or not merges


def test_tokenizer_refuses_long_text_without_truncate() -> None:
    with pytest.raises(ValueError, match="too long"):
        TCLIPTokenizer(truncate=False).tokenize(PROMPTS[-1])


# --------------------------------------------------------------------- ToMe


def _jax_tome(metric: np.ndarray, h: int, w: int, *xs: np.ndarray):
    """The JAX package's merge of xs[0::2] and unmerge of xs[1::2], jitted
    (one compile where op-by-op dispatch would compile every op)."""

    @jax.jit
    def run(metric, *args):
        merge, unmerge, _ = JT.bipartite_soft_matching_random2d(metric, h, w, ratio=0.5)
        return [merge(a) if i % 2 == 0 else unmerge(a) for i, a in enumerate(args)]

    return [np.asarray(r) for r in run(jnp.asarray(metric), *map(jnp.asarray, xs))]


def _ids(b: int, n: int) -> np.ndarray:
    """Each token's index as its one feature: exact in f32."""
    return np.broadcast_to(np.arange(n, dtype=np.float32)[None, :, None], (b, n, 1)).copy()


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied_scores"])
@pytest.mark.parametrize("hw", [(16, 16), (7, 9)])
def test_tome_indices_and_values_match(ties, hw) -> None:
    """The chosen indices are identical (the kept tokens, in their order,
    and the merged row each token reads back), and merge / unmerge of random
    features match at f32 rounding. The tied case duplicates rows of five
    vectors with four entries of +-2^20 each: every normalised entry is
    +-0.5 exactly (the norm's +1e-6 is below its ulp), so every score is an
    exact multiple of 1/4 in both frameworks and most src tokens tie, on
    their best score and on their best dst: both take the first maximum and
    rank the lower index first."""
    h, w = hw
    n = h * w
    rng = np.random.RandomState(0)
    if ties:
        base = np.zeros((2, 5, 16), np.float32)
        for b in range(2):
            for k in range(5):
                base[b, k, rng.choice(16, 4, replace=False)] = rng.choice([-1.0, 1.0], 4) * 2.0**20
        metric = base[:, rng.randint(0, 5, n)]
    else:
        metric = rng.randn(2, n, 16).astype(np.float32)
    tm, tu, remaining = TT.bipartite_soft_matching_random2d(torch.from_numpy(metric), h, w, ratio=0.5)
    assert remaining == n - int(n * 0.5)
    ids, back = _ids(2, n), _ids(2, remaining)
    x = rng.randn(2, n, 24).astype(np.float32)
    y = rng.randn(2, remaining, 24).astype(np.float32)
    j_ids, j_back, j_x, j_y = _jax_tome(metric, h, w, ids, back, x, y)
    np.testing.assert_array_equal(tm(torch.from_numpy(ids)).numpy(), j_ids)
    np.testing.assert_array_equal(tu(torch.from_numpy(back)).numpy(), j_back)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), j_x, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tu(torch.from_numpy(y)).numpy(), j_y, atol=1e-6, rtol=1e-6)
    if ties:
        assert len(np.unique(metric[0], axis=0)) <= 5


@pytest.mark.parametrize("side,on", [(48, True), (44, False)])
def test_tome_min_tokens_gate(side, on) -> None:
    x = np.random.RandomState(1).randn(1, side * side, 8).astype(np.float32)
    *_, j_on = JT.compute_merge(jnp.asarray(x), side, side, ratio=0.5)
    merge, _, t_on = TT.compute_merge(torch.from_numpy(x), side, side, ratio=0.5)
    assert t_on == j_on == on
    assert merge(torch.from_numpy(x)).shape[1] == (side * side - int(side * side * 0.5) if on else side * side)


@pytest.mark.parametrize("merge_mlp", [False, True])
def test_spatial_transformer_with_tome(merge_mlp) -> None:
    """64x64 tokens at a narrow width: ToMe engages (4096 >= 2048)."""
    jm = dezero(SpatialTransformer(32, 2, 16, context_dim=16, rngs=nnx.Rngs(0)))
    tm = bridged(jm, TSpatialTransformer(32, 2, 16, context_dim=16))
    jm.set_tome_ratio(0.5, merge_mlp=merge_mlp)
    tm.set_tome_ratio(0.5, merge_mlp=merge_mlp)
    rng = np.random.RandomState(2)
    x = rng.randn(1, 64, 64, 32).astype(np.float32)
    ctx = rng.randn(1, 77, 16).astype(np.float32)
    graph, state = nnx.split(jm)
    ref = np.asarray(jax.jit(lambda st, a, c: nnx.merge(graph, st)(a, c))(state, jnp.asarray(x), jnp.asarray(ctx)))
    got = tm(torch.from_numpy(x), torch.from_numpy(ctx)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    tm.set_tome_ratio(0.0)
    plain = tm(torch.from_numpy(x), torch.from_numpy(ctx)).detach().numpy()
    assert np.abs(plain - got).max() > 1e-3  # the merge changed the output


# ---------------------------------------------------- DeepCache: the schedule


@pytest.mark.parametrize("center", [None, 0.0, 0.3, 1.0])
def test_refresh_mask_and_center_mapping_match(center) -> None:
    for n in range(1, 31):
        for interval in range(1, 7):
            got = TS.deepcache_refresh_mask(n, interval, center)
            np.testing.assert_array_equal(got, JS.deepcache_refresh_mask(n, interval, center))
            assert got[0] and got.sum() == ((np.arange(n) % interval) == 0).sum()
        if center is not None:
            for seg in (np.arange(0, n), np.arange(n // 3, n), np.arange(0, max(1, n // 2))):
                assert TS.map_center_to_segment(center, n, seg) == JS.map_center_to_segment(center, n, seg)


# ------------------------------------------------- DeepCache: the UNet passes

UNET = dict(
    start_channels=32, num_res_blocks=1, channel_multipliers=(1, 2),
    attention_downsample_rates=(1,), num_heads=4, context_dim=32,
)


@pytest.fixture(scope="module")
def tiny_ddpm():
    jm = dezero(DDPM(img_size=8, num_timesteps=50, unet_config=UNET, rngs=nnx.Rngs(0)))
    tm = bridged(jm, cflearn_torch.build(cflearn_torch.DDPM, device="cpu", img_size=8, num_timesteps=50,
                                         unet_config=UNET))
    return jm, tm


@pytest.mark.parametrize("cut", [1, 5])
def test_unet_full_and_shallow_passes_match(tiny_ddpm, cut) -> None:
    """The full pass with `return_cache` and the shallow pass on its cache,
    at cut 1 and at a cut that `_effective_cache_cut` clamps (5 -> 3)."""
    jm, tm = tiny_ddpm
    jm.deepcache_cut = tm.deepcache_cut = cut
    assert tm._effective_cache_cut() == jm._effective_cache_cut() == min(cut, 3)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    x2 = rng.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    t, t2 = np.array([30, 30]), np.array([20, 20])
    graph, state = nnx.split(jm)  # the cut is part of the graph: one compile per pass and cut

    @jax.jit
    def j_denoise(st, a, tt, c, cache=None):
        return nnx.merge(graph, st).denoise(a, tt, c, deep_cache=cache, return_cache=True)

    j_out, j_cache = j_denoise(state, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    j_sh, j_cache2 = j_denoise(state, jnp.asarray(x2), jnp.asarray(t2), jnp.asarray(ctx), j_cache)
    with torch.no_grad():
        t_out, t_cache = tm.denoise(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), return_cache=True)
        t_sh, t_cache2 = tm.denoise(torch.from_numpy(x2), torch.from_numpy(t2), torch.from_numpy(ctx),
                                    deep_cache=t_cache, return_cache=True)
        full2 = tm.denoise(torch.from_numpy(x2), torch.from_numpy(t2), torch.from_numpy(ctx))
    for got, ref in ((t_out, j_out), (t_cache, j_cache), (t_sh, j_sh), (t_cache2, j_cache2)):
        assert tuple(got.shape) == tuple(ref.shape)
        assert rel_err(got.numpy(), np.asarray(ref)) < 1e-4
    assert t_cache2 is t_cache  # the shallow pass hands its cache on
    assert rel_err(t_sh.numpy(), full2.numpy()) > 1e-3  # and does not run the deep levels


# ------------------------------------------------------------------- W8A8


@jax.jit
def _jax_quantize(x, w):
    """The quantisation lines of the JAX package's `conv3x3_w8a8`, jitted as there."""
    s_x = jnp.max(jnp.abs(x.astype(jnp.float32))) / 127.0 + 1e-12
    x8 = jnp.clip(jnp.round(x.astype(jnp.float32) / s_x), -127, 127).astype(jnp.int8)
    s_w = jnp.max(jnp.abs(w.astype(jnp.float32)), axis=(0, 1, 2)) / 127.0 + 1e-12
    w8 = jnp.clip(jnp.round(w.astype(jnp.float32) / s_w), -127, 127).astype(jnp.int8)
    return x8, w8, s_x, s_w


def _conv_inputs(shape, co, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[-1], co) * (9 * shape[-1]) ** -0.5).astype(np.float32)
    b = (rng.randn(co) * 0.1).astype(np.float32)
    return x, w, b


def _ohwi(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 0, 1, 2)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_quantisation_matches(dtype) -> None:
    x, w, _ = _conv_inputs((2, 9, 11, 64), 72, seed=1)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jw = jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd)
    x8, w8, s_x, s_w = _jax_quantize(jx, jw)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(td)
    tw = _ohwi(np.asarray(jw.astype(jnp.float32))).to(td)
    got_x8, got_sx = TC.quantize_activation(tx)
    got_w8, got_sw = TC.quantize_weight(tw)
    np.testing.assert_array_equal(got_x8.numpy(), np.asarray(x8))
    np.testing.assert_array_equal(got_w8.numpy(), np.asarray(w8).transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(got_sx.numpy(), np.asarray(s_x))
    np.testing.assert_array_equal(got_sw.numpy(), np.asarray(s_w))
    assert got_x8.dtype == torch.int8 and int(got_x8.abs().max()) == 127


def test_w8a8_rounds_half_to_even() -> None:
    """Values that land exactly on .5 after scaling round to even in both."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5], np.float32).reshape(1, 1, 7, 1)
    x = np.repeat(x, 16, axis=-1)
    w = np.ones((3, 3, 16, 8), np.float32)
    x8, *_ = _jax_quantize(jnp.asarray(x), jnp.asarray(w))
    got, s_x = TC.quantize_activation(torch.from_numpy(x))
    assert float(s_x) == pytest.approx(1.0, abs=1e-6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(x8))
    assert got[0, 0, :, 0].tolist() == [127, 0, 2, 2, 0, -2, 4]


@pytest.mark.parametrize("shape,co", [((1, 16, 16, 64), 64), ((2, 12, 20, 128), 136), ((1, 8, 8, 256), 512)])
def test_w8a8_conv_matches_pallas(interpret, shape, co) -> None:
    """At shapes where the JAX picker has a tile: bit-identical in f32 (the
    int sums are exact, the epilogue rounds the same), within one bf16 ulp of
    max|ref| in bf16. With a bias in f32, XLA compiles the interpret-mode
    kernel's product and the bias add after it into one fused multiply-add
    on the CPU (on the TPU the kernel's store rounds between them, as the
    port's epilogue does): there the two differ by the product's rounding
    and the sum's, at most an ulp of each."""
    x, w, b = _conv_inputs(shape, co, seed=2)
    assert C._pick_config(shape[0], shape[1], shape[2], shape[3], co, 2) is not None
    ref = np.asarray(C.conv3x3_w8a8(jnp.asarray(x), jnp.asarray(w)))
    got = TC.conv3x3_w8a8(torch.from_numpy(x), _ohwi(w))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(TC.conv3x3_w8a8_plain(torch.from_numpy(x), _ohwi(w)).numpy(), ref)
    ref_b = np.asarray(C.conv3x3_w8a8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got_b = TC.conv3x3_w8a8(torch.from_numpy(x), _ohwi(w), torch.from_numpy(b)).numpy()
    assert np.all(np.abs(got_b - ref_b) <= np.spacing(np.abs(ref)) + np.spacing(np.abs(ref_b)))
    # bf16
    jx, jw, jb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, b))
    ref16 = np.asarray(C.conv3x3_w8a8(jx, jw, jb).astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    tw = _ohwi(np.asarray(jw.astype(jnp.float32))).bfloat16()
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).bfloat16()
    got16 = TC.conv3x3_w8a8(tx, tw, tb)
    assert got16.dtype == torch.bfloat16
    assert np.abs(got16.float().numpy() - ref16).max() <= 2.0**-8 * np.abs(ref16).max()
    # W8A8 stays near the unquantised conv: a few per cent of its largest output
    exact = TC.conv3x3_plain(torch.from_numpy(x), _ohwi(w), torch.from_numpy(b)).numpy()
    assert 0 < np.abs(got_b - exact).max() < 0.05 * np.abs(exact).max()


def test_w8a8_decoder_through_conv_call(interpret, monkeypatch) -> None:
    """A tiny VAE decoder in bf16 at 128x128 with 64 channels, W8A8 on by
    default in both packages: the same five convs route to W8A8 (the two
    128x128 res blocks and the upsampling conv). Each routed call of the
    port, handed to the JAX package's `conv3x3_w8a8` as it is (its weight
    back in the (3, 3, C, Co) layout), gives the same output within one bf16
    ulp of its largest value. The two decoders' images agree within the W8A8
    noise bound of the JAX package's own test (5% of the largest value): the
    bf16 activations entering a conv differ by an ulp here and there between
    the two, and an ulp at a rounding boundary moves that int8 value by one
    step, 1/127 of the tensor's largest value."""
    kw = dict(img_size=128, inner_channels=64, z_channels=4, channel_multipliers=[1, 1], num_res_blocks=1)
    jm = AttnDecoder(rngs=nnx.Rngs(0), **kw)
    tm = bridged(jm, TAttnDecoder(**kw))
    params = nnx.state(jm, nnx.Param)
    nnx.update(jm, jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params))
    tm = tm.to(torch.bfloat16)
    zb = jnp.asarray(np.random.RandomState(4).randn(1, 64, 64, 4).astype(np.float32)).astype(jnp.bfloat16)
    calls = {"jax": 0}
    routed = []
    j_w8a8, t_w8a8 = C.conv3x3_w8a8, TC.conv3x3_w8a8

    def j_rec(*a, **k):
        calls["jax"] += 1
        return j_w8a8(*a, **k)

    def t_rec(x, w, b=None):
        out = t_w8a8(x, w, b)
        routed.append((x, w, b, out))
        return out

    monkeypatch.setattr(C, "_W8A8_DEFAULT", True)
    monkeypatch.setattr(C, "conv3x3_w8a8", j_rec)
    monkeypatch.setattr(TC, "W8A8_DEFAULT", True)
    monkeypatch.setattr(TC, "conv3x3_w8a8", t_rec)
    graph, state = nnx.split(jm)
    ref = np.asarray(jax.jit(lambda st, a: nnx.merge(graph, st)(a))(state, zb).astype(jnp.float32))
    with torch.no_grad():
        got = tm(torch.from_numpy(np.array(zb.astype(jnp.float32))).bfloat16()).float().numpy()
    assert calls["jax"] == len(routed) == 5
    assert got.shape == (1, 128, 128, 3)
    assert rel_err(got, ref) < 0.05

    def to_jax(t: torch.Tensor):
        return jnp.asarray(t.detach().float().numpy()).astype(jnp.bfloat16)

    for x, w, b, out in routed:
        assert x.dtype == w.dtype == b.dtype == out.dtype == torch.bfloat16 and x.shape[1:3] == (128, 128)
        want = np.asarray(j_w8a8(to_jax(x), to_jax(w.permute(1, 2, 3, 0)), to_jax(b)).astype(jnp.float32))
        assert np.abs(out.float().numpy() - want).max() <= 2.0**-8 * np.abs(want).max()


# ------------------------------------------------------------------- fold


@pytest.mark.parametrize("shape,co", [((1, 16, 16, 64), 128), ((1, 12, 20, 96), 64), ((1, 8, 8, 256), 256)])
def test_fold_conv_matches_pallas(interpret, shape, co) -> None:
    """Batch 1, where the JAX package really folds (its guard turns the fold
    off for a batch-folded tile)."""
    x, w, b = _conv_inputs(shape, co, seed=5)
    ref = np.asarray(C.conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), fold=True))
    got = TC.conv3x3_fold_plain(torch.from_numpy(x), _ohwi(w), torch.from_numpy(b)).numpy()
    assert rel_err(got, ref) < 1e-5
    # and the dispatcher: fold=True, or the module default, takes the same path
    np.testing.assert_array_equal(TC.conv3x3(torch.from_numpy(x), _ohwi(w), torch.from_numpy(b), fold=True).numpy(), got)
    saved, TC.FOLD = TC.FOLD, True
    try:
        np.testing.assert_array_equal(TC.conv3x3(torch.from_numpy(x), _ohwi(w), torch.from_numpy(b)).numpy(), got)
    finally:
        TC.FOLD = saved
