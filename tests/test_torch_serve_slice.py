"""The port's serving configurations as a whole against the JAX package: a
tiny SD-shaped LDM through `txt2img` with string prompts, in the lossless,
faithful and accelerated configurations of `bench.py`, and the faithful
one with the guidance interval and a DeepCache refresh center.

48x48 latents, so that ToMe engages at the UNet's top level (2304 tokens >=
2048), 8 DDIM steps with CFG 7.5, so that DeepCache refreshes inside the
loop (N=3: steps 0, 3, 6; N=5: 0, 5) and the guidance interval (0.25, 0.70)
splits it into 2 / 4 / 2 steps, the middle segment refreshing twice. f32
throughout; the attention takes XLA's route on the JAX side (the flash
kernel's parity is `tests/test_torch_ops.py`'s). The JAX side is driven as
`bench.py` drives it: the levers set on the module, one jitted program per
configuration, the sampler given the guidance interval. Tolerance: f32
summation order per layer, times CFG's 7.5 per step, as in
`tests/test_torch_slice.py`.

ToMe's matching meets near-ties: two candidates whose scores differ by an
ulp or two, where the summation order (which moves with the intra-op thread
count) decides the merge. The JAX program records each matching it makes
(from inside the jitted program); the port, run at one thread (as the
tier-1 workers run) and at the default count, compares its matching with
the JAX side's call by call (each src token's dst, the merged set, the
order) and takes the JAX side's. Each difference must be a tie of the
port's own scores, within TIE_ULPS ulps (ORDER_ULPS for the order, which
only orders sums), and a call without such a tie must match exactly; with
the ties taken alike, the latents are held to the JAX side's."""

from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from _torch_bridge_common import bridged, default_threads, dezero, rel_err
import cflearn_torch
import cflearn_torch.modules.core.tome as ttome
import cflearn_tpu.modules.core.tome as jtome
from cflearn_torch.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel as TCLIPText
from cflearn_torch.pipeline import ACCEL_DC, FAITHFUL_DC, GUIDANCE_INTERVAL, TOME_RATIO, configure
from cflearn_torch.toolkit.quality import compare_outputs
from cflearn_tpu.modules.core.mixed_stacks import SpatialTransformer
from cflearn_tpu.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel
from cflearn_tpu.modules.multimodal.diffusion.ldm import LDM
from cflearn_tpu.modules.multimodal.diffusion.samplers import ISampler
from cflearn_tpu.modules.nlp.tokenizers import CLIPTokenizer
from cflearn_tpu.toolkit import quality as JQ

UNET = dict(
    start_channels=32, num_res_blocks=1, channel_multipliers=(1, 2),
    attention_downsample_rates=(1,), num_heads=1, context_dim=32,
)
# no downsampling: the decoder works at the latents' 48x48
FIRST_STAGE = dict(
    img_size=48, inner_channels=32, z_channels=4, embedding_channels=4, channel_multipliers=[1], num_res_blocks=1,
)
CLIP = dict(latent_dim=32, num_layers=1, num_heads=2)
STEPS = 8
LATENT = 48
PROMPT = "a photo of a café at dusk, 35mm — &amp; a 2nd prompt's words"
# how far (in ulps of the score) a merge the port takes from the JAX side may be from the port's own choice, and
# how far apart two src tokens that the sides rank the other way may be (an order that only orders sums)
TIE_ULPS = 8
ORDER_ULPS = 64
THREADS = ("one", "default")
# (config, guidance interval, DeepCache center)
RUNS = {
    "lossless": ("lossless", None, None),
    "faithful": ("faithful", None, None),
    "accelerated": ("accelerated", None, None),
    "faithful_gi_center": ("faithful", GUIDANCE_INTERVAL, 0.3),
}


def _jax_configure(m, config: str) -> None:
    """`bench.py`'s `configure` with the port's constants (which are its)."""
    lossless = config == "lossless"
    for _, module in nnx.iter_graph(m):
        if isinstance(module, SpatialTransformer):
            module.set_tome_ratio(0.0 if lossless else TOME_RATIO)
    interval, cut = ACCEL_DC if config == "accelerated" else FAITHFUL_DC
    m.deepcache_interval = None if lossless else interval
    m.deepcache_cut = cut
    m.deepcache_center = None


def _jax_txt2img(m, tokens, uncond, z, guidance_interval):
    """`bench.py`'s closure: one jitted program per configuration (the levers
    are static attributes of the module graph)."""
    graph, state = nnx.split(m)

    @jax.jit
    def run(st, tokens, uncond, z):
        model = nnx.merge(graph, st)
        both = model.get_cond(jnp.concatenate([tokens, uncond], axis=0))
        cond, unc = jnp.split(both, 2, axis=0)
        sampler_config = {"model": model}
        if guidance_interval is not None:
            sampler_config["guidance_interval"] = guidance_interval
        sampler = ISampler.make("ddim", sampler_config)
        latents = sampler.sample(z, cond=cond, uncond=unc, guidance_scale=7.5, num_steps=STEPS)
        return latents, model.decode(latents)

    latents, images = run(state, tokens, uncond, z)
    return np.asarray(latents), np.asarray(images)


def _recording_matching(record):
    """The JAX function with its matching (its own first lines, in the same
    program) sent to `record` as (best_dst, merge_order) at each call."""
    original = jtome.bipartite_soft_matching_random2d

    def wrapped(metric, h, w, *, ratio=0.5, sx=2, sy=2):
        b, n, _ = metric.shape
        is_dst = (((jnp.arange(h)[:, None] % sy) == 0) & ((jnp.arange(w)[None, :] % sx) == 0)).reshape(-1)
        num_dst = -(-h // sy) * -(-w // sx)
        dst_idx = jnp.nonzero(is_dst, size=num_dst)[0]
        src_idx = jnp.nonzero(~is_dst, size=n - num_dst)[0]
        metric_n = metric / (jnp.linalg.norm(metric, axis=-1, keepdims=True) + 1e-6)
        scores = jnp.einsum("bsc,bdc->bsd", jnp.take(metric_n, src_idx, axis=1), jnp.take(metric_n, dst_idx, axis=1))
        _, order = jax.lax.top_k(jnp.max(scores, axis=-1), n - num_dst)
        jax.debug.callback(lambda d, o: record.append((np.asarray(d), np.asarray(o))),
                           jnp.argmax(scores, axis=-1), order, ordered=True)
        return original(metric, h, w, ratio=ratio, sx=sx, sy=sy)

    return wrapped


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in ulps of the larger of the two."""
    t = torch.maximum(a.abs(), b.abs())
    return (a - b).abs() / (torch.nextafter(t, torch.full_like(t, float("inf"))) - t)


def _worst(ulps: torch.Tensor, differs: torch.Tensor) -> float:
    return float(ulps[differs].max()) if bool(differs.any()) else 0.0


def _jax_matchings(matchings, ties):
    """`match_tokens` taking the JAX side's recorded matchings in order. Each
    call goes to `ties` with where the port's own matching differs from the
    JAX side's and how far apart the two choices are under the port's
    scores, in ulps of the score: the dst of each src token that the JAX
    side merges (the two choices' scores); the set of merged src tokens (the best scores of the
    tokens that only one side merges); the order of the src tokens (position
    by position, their best scores). Beside each, the ties the port's scores
    hold: merged src tokens whose two best dst lie within TIE_ULPS, the r-th and
    (r+1)-th best scores within TIE_ULPS, neighbours in the order within
    ORDER_ULPS; where there is no tie, no choice may differ."""
    original = ttome.match_tokens
    calls = iter(matchings)

    def wrapped(metric, h, w, **kw):
        mine = original(metric, h, w, **kw)
        jdst, jorder = (torch.as_tensor(np.array(a), dtype=torch.long) for a in next(calls))
        r, scores = mine.r, mine.scores
        best = scores.amax(dim=-1)
        # the dst of the tokens the JAX side merges (no other token's dst is used)
        merged = jorder[:, :r]
        dst_differs = torch.gather(jdst != mine.best_dst, 1, merged)
        dst_ulps = torch.gather(_ulps(torch.gather(scores, -1, mine.best_dst[..., None]),
                                      torch.gather(scores, -1, jdst[..., None]))[..., 0], 1, merged)
        top2 = torch.gather(scores.topk(2, dim=-1).values, 1, merged[..., None].expand(-1, -1, 2))
        ranked = torch.gather(best, 1, mine.merge_order)
        set_differs, set_ulps = 0, 0.0
        for row, j_row, m_row in zip(best, jorder, mine.merge_order):
            only = torch.as_tensor(sorted(set(j_row[:r].tolist()) ^ set(m_row[:r].tolist())), dtype=torch.long)
            if only.numel():
                set_differs += only.numel()
                set_ulps = max(set_ulps, float(_ulps(row[only].max(), row[only].min())))
        order_differs = jorder != mine.merge_order
        order_ulps = _ulps(ranked, torch.gather(best, 1, jorder))
        ties.append({
            "dst_differs": int(dst_differs.sum()), "dst_ulps": _worst(dst_ulps, dst_differs),
            "dst_ties": int((_ulps(top2[..., 0], top2[..., 1]) <= TIE_ULPS).sum()),
            "set_differs": set_differs, "set_ulps": set_ulps,
            "set_ties": int((_ulps(ranked[:, r - 1], ranked[:, r]) <= TIE_ULPS).sum()) if r < ranked.shape[1] else 0,
            "order_differs": int(order_differs.sum()), "order_ulps": _worst(order_ulps, order_differs),
            "order_ties": int((_ulps(ranked[:, 1:], ranked[:, :-1]) <= ORDER_ULPS).sum()),
        })
        return ttome.Matching(jdst, jorder, r, scores)

    return wrapped


@pytest.fixture(scope="module")
def runs():
    rngs = nnx.Rngs(0)
    jm = LDM(
        img_size=LATENT, in_channels=4, out_channels=4, num_timesteps=100,
        condition_model=CLIPTextConditionModel(rngs=rngs, **CLIP),
        unet_config=UNET, first_stage_config=FIRST_STAGE, rngs=rngs,
    )
    dezero(jm)
    tm = cflearn_torch.build(
        cflearn_torch.LDM, device="cpu", img_size=LATENT, in_channels=4, out_channels=4, num_timesteps=100,
        condition_model=TCLIPText(**CLIP), unet_config=UNET, first_stage_config=FIRST_STAGE,
    )
    tm = bridged(jm, tm)
    tok = CLIPTokenizer()
    tokens = jnp.asarray(tok.tokenize([PROMPT]))
    uncond = jnp.asarray(tok.tokenize([""]))
    z = np.random.RandomState(0).randn(1, LATENT, LATENT, 4).astype(np.float32)
    out, ties = {}, {}
    for name, (config, gi, center) in RUNS.items():
        _jax_configure(jm, config)
        jm.deepcache_center = center
        matchings = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jtome, "bipartite_soft_matching_random2d", _recording_matching(matchings))
            ref = _jax_txt2img(jm, tokens, uncond, jnp.asarray(z), gi)
        configure(tm, config)
        tm.deepcache_center = center
        for threads in THREADS:
            ties[name, threads] = []
            with pytest.MonkeyPatch.context() as mp, (default_threads() if threads == "default" else nullcontext()):
                mp.setattr(ttome, "match_tokens", _jax_matchings(matchings, ties[name, threads]))
                images, latents = cflearn_torch.txt2img(
                    tm, PROMPT, num_steps=STEPS, guidance_scale=7.5, z=z, guidance_interval=gi, return_latents=True,
                )
                with torch.no_grad():
                    decoded = tm.decode(latents).numpy()
            assert len(ties[name, threads]) == len(matchings), (name, threads)
            out[name, threads] = (ref, (latents.numpy(), decoded, images.numpy()))
        out[name] = out[name, "one"]
    return out, tm, ties


@pytest.mark.parametrize("name", list(RUNS))
def test_serving_latents_match(runs, name) -> None:
    """At one thread and at the default count, with ToMe's ties taken as the
    JAX side took them."""
    for threads in THREADS:
        (ref_lat, _), (lat, _, images) = runs[0][name, threads]
        assert lat.shape == (1, LATENT, LATENT, 4) and np.isfinite(lat).all()
        assert images.shape == (1, LATENT, LATENT, 3) and images.dtype == np.uint8
        assert rel_err(lat, ref_lat) < 1e-4, threads


@pytest.mark.parametrize("name", [n for n in RUNS if n != "lossless"])
def test_tome_matchings_differ_from_jax_only_at_ties(runs, name) -> None:
    """Every ToMe matching of the port, at one thread and at the default
    count, is the JAX side's or differs from it only at a tie of the port's
    own scores: each src token's dst and the set of merged tokens only
    between choices within TIE_ULPS ulps, the src tokens' order only between
    scores within ORDER_ULPS; a call whose scores hold no such tie has the
    JAX side's matching exactly."""
    ties = runs[2]
    for threads in THREADS:
        calls = ties[name, threads]
        assert calls, (name, threads)
        for i, c in enumerate(calls):
            where = (threads, i, c)
            assert c["dst_ulps"] <= TIE_ULPS and c["set_ulps"] <= TIE_ULPS, where
            assert c["order_ulps"] <= ORDER_ULPS, where
            assert not c["dst_differs"] or c["dst_ties"], where
            assert not c["set_differs"] or c["set_ties"], where
            assert not c["order_differs"] or c["order_ties"], where


def test_levers_change_the_output(runs) -> None:
    """Each lossy configuration moves the latents away from the lossless
    ones by far more than the port-vs-JAX tolerance, in both packages, and
    the port's quality report equals the JAX package's on the same arrays."""
    out, _, _ = runs
    (ref_lossless, ref_img), (lossless, img, _) = out["lossless"]
    for name in ("faithful", "accelerated", "faithful_gi_center"):
        (ref_lat, ref_dec), (lat, dec, _) = out[name]
        assert rel_err(lat, lossless) > 1e-2 and rel_err(ref_lat, ref_lossless) > 1e-2, name
        got = compare_outputs(lossless, img, lat, dec)
        want = JQ.compare_outputs(ref_lossless, ref_img, ref_lat, ref_dec)
        for key, value in got.to_dict().items():
            assert value == pytest.approx(want.to_dict()[key], rel=1e-3, abs=1e-6), (name, key)


def test_configure_sets_bench_levers(runs) -> None:
    _, tm, _ = runs
    from cflearn_torch.modules.core.mixed_stacks import SpatialTransformer as TST

    configure(tm, "accelerated")
    assert (tm.deepcache_interval, tm.deepcache_cut, tm.deepcache_center) == (5, 1, None)
    assert all(m.tome_ratio == 0.5 for m in tm.modules() if isinstance(m, TST))
    configure(tm, "faithful")
    assert tm.deepcache_interval == 3
    configure(tm, "lossless")
    assert tm.deepcache_interval is None
    assert all(m.tome_ratio == 0.0 for m in tm.modules() if isinstance(m, TST))
    with pytest.raises(ValueError):
        configure(tm, "fast")
