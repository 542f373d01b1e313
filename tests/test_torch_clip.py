"""CLIP in the port against the JAX package's, in f32 on the CPU at tiny
widths: the vision tower (`CLIPVisionTower`) at an input size its patch
divides and at one it does not (XLA's "SAME" padding, split unevenly), the
joint model (`CLIP.encode_image` / `encode_text` with and without
`normalize`, `__call__`'s dict), the text tower's EOT pooling
(`return_pooled`, with ties) and `embed_with`, both activations, and a tower
at a routed shape (257 tokens: the flash path, the JAX side's Pallas kernel
in interpret mode). Then the zoo's CLIP and ESRGAN presets: parsed as the
JAX package parses them, the port's own copies of the JSON files, the
parameter counts at full width (built on "meta") and the strict bridge over
each preset's structure.

Each JAX module is built with `nnx.Rngs(0)`, its parameters carried across
by `cflearn_torch.bridge`; both get the same seeded numpy inputs.
Tolerance: 1e-5 of max|ref| (f32 summation order)."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import cflearn_torch
from _torch_bridge_common import bridged, flat_params, flat_shapes, rel_err
from cflearn_torch import zoo as tzoo
from cflearn_torch.bridge import map_names
from cflearn_torch.modules.core.activations import gelu as t_gelu
from cflearn_torch.modules.core.activations import quick_gelu as t_quick_gelu
from cflearn_torch.modules.multimodal import clip as TC
from cflearn_torch.modules.nlp.tokenizers import CLIPTokenizer
from cflearn_torch.ops import attention as TA
from cflearn_tpu import zoo as jzoo
from cflearn_tpu.modules.multimodal import clip as JC
from cflearn_tpu.ops import attention as A

TOL = 1e-5
TOWER = dict(latent_dim=32, num_layers=2, num_heads=2)
TINY_CLIP = dict(
    img_size=32, latent_dim=24, vision_latent_dim=32, vision_patch_size=8, vision_num_layers=2, vision_num_heads=2,
    vocab_size=600, context_length=77, text_latent_dim=32, text_num_layers=2, text_num_heads=2,
)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _check(got: torch.Tensor, ref, tol: float = TOL) -> None:
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    assert rel_err(got.detach().numpy(), ref) < tol


def _images(seed, b, side):
    return np.random.RandomState(seed).randn(b, side, side, 3).astype(np.float32)


def _port(cls, **kw):
    return cflearn_torch.build(cls, device="cpu", **kw)


@pytest.fixture(scope="module")
def tiny_clip():
    jm = JC.CLIP(rngs=nnx.Rngs(0), **TINY_CLIP)
    return jm, bridged(jm, _port(TC.CLIP, **TINY_CLIP))


@pytest.fixture(scope="module")
def tokens():
    ids = CLIPTokenizer().tokenize(["a photo of a cat", "two dogs on the grass, at noon", ""])
    assert ids.max() < TINY_CLIP["vocab_size"]
    return ids


def _jax(fn, *args):
    """`fn(*args)` under `nnx.jit`: one compile instead of one per primitive."""
    return nnx.jit(fn)(*args)


# ---- the towers ----


@pytest.mark.parametrize("side", [32, 27], ids=["divides", "same_pad_2_3"])
def test_vision_tower(tiny_clip, side) -> None:
    """The 32px tower (patch 8: 16 patches) on 32px images, and on 27px images, which XLA's "SAME" pads by two
    pixels above and three below (ceil(27 / 8) = 4 patches a side)."""
    jm, tm = tiny_clip
    x = _images(1, 2, side)
    with torch.no_grad():
        _check(tm.vit(_t(x)), _jax(lambda m, v: m(v), jm.vit, jnp.asarray(x)))


def test_vision_tower_refuses_what_its_positional_table_does_not_fit(tiny_clip) -> None:
    """At an input that gives more patches than the table holds (40px: 25), both packages raise."""
    jm, tm = tiny_clip
    x = _images(2, 1, 40)
    with pytest.raises((TypeError, ValueError)):
        _jax(lambda m, v: m(v), jm.vit, jnp.asarray(x))
    with pytest.raises(RuntimeError):
        tm.vit(_t(x))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(A, "_INTERPRET", True)


def test_vision_tower_at_a_routed_shape(interpret, monkeypatch) -> None:
    """64px images in patches of 4: 16^2 + 1 = 257 tokens, 2 heads of 16. The port routes the self-attention to
    its flash wrapper (the plain version on the CPU), the JAX package to its Pallas kernel."""
    kw = dict(img_size=64, patch_size=4, latent_dim=32, num_layers=1, num_heads=2)
    jm = JC.CLIPVisionTower(rngs=nnx.Rngs(0), **kw)
    tm = bridged(jm, _port(TC.CLIPVisionTower, **kw))
    routed = {"jax": [], "port": []}

    def spy(side, fn):
        def call(q, *args, **kwargs):
            routed[side].append(tuple(q.shape))
            return fn(q, *args, **kwargs)

        return call

    monkeypatch.setattr(A, "flash_attention_trainable", spy("jax", A.flash_attention_trainable))
    monkeypatch.setattr(TA, "flash_attention", spy("port", TA.flash_attention))
    x = _images(3, 1, 64)
    want = _jax(lambda m, v: m(v), jm, jnp.asarray(x))
    with torch.no_grad():
        _check(tm(_t(x)), want)
    assert routed == {"jax": [(1, 2, 257, 16)], "port": [(1, 2, 257, 16)]}


@pytest.mark.parametrize("normalize", [True, False])
def test_clip_encoders(tiny_clip, tokens, normalize) -> None:
    jm, tm = tiny_clip
    x = _images(4, 3, 32)
    with torch.no_grad():
        img = tm.encode_image(_t(x), normalize=normalize)
        txt = tm.encode_text(_t(tokens).long(), normalize=normalize)
    _check(img, _jax(lambda m, v: m.encode_image(v, normalize=normalize), jm, jnp.asarray(x)))
    _check(txt, _jax(lambda m, t: m.encode_text(t, normalize=normalize), jm, jnp.asarray(tokens)))
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(img.numpy(), axis=-1), 1.0, atol=1e-6)


def test_clip_call(tiny_clip, tokens) -> None:
    jm, tm = tiny_clip
    x = _images(5, 3, 32)
    with torch.no_grad():
        got = tm(_t(x), _t(tokens).long())
    want = _jax(lambda m, v, t: m(v, t), jm, jnp.asarray(x), jnp.asarray(tokens))
    assert sorted(got) == sorted(want)
    for key in want:
        _check(got[key], want[key])
    assert tm.logit_scale.item() == pytest.approx(float(jm.logit_scale[...]))


def test_logit_scale_is_initialised_as_the_jax_package_does() -> None:
    tm = _port(TC.CLIP, **TINY_CLIP)
    assert tm.logit_scale.item() == pytest.approx(float(JC.CLIP(rngs=nnx.Rngs(0), **TINY_CLIP).logit_scale[...]))
    assert tm.vit.class_embedding.abs().max().item() > 0  # drawn, not left at zero


@pytest.mark.parametrize("ids", ["tokenizer", "ties"])
def test_return_pooled_takes_the_eot_row(tiny_clip, tokens, ids) -> None:
    """The pooled row is the largest id's, the first of equal ones: the tokenizer's ids (SOT, the text, EOT, zero
    padding) and hand-made rows with the largest id twice (and a row of zeros)."""
    jm, tm = tiny_clip
    if ids == "ties":
        tokens = np.zeros((3, 9), np.int32)
        tokens[0, [2, 5]] = 513
        tokens[1, [0, 8]] = 77
        tokens[1, 3] = 12
    with torch.no_grad():
        x, pooled = tm.token_encoder(_t(tokens).long(), return_pooled=True)
    jx, jpooled = _jax(lambda m, t: m(t, return_pooled=True), jm.token_encoder, jnp.asarray(tokens))
    _check(x, jx)
    _check(pooled, jpooled)
    rows = np.argmax(tokens, axis=-1)
    np.testing.assert_array_equal(pooled.numpy(), x.numpy()[np.arange(len(rows)), rows])


@pytest.mark.parametrize("apply_final_ln", [True, False])
def test_embed_with(tiny_clip, apply_final_ln) -> None:
    jm, tm = tiny_clip
    e = np.random.RandomState(6).randn(2, 11, 32).astype(np.float32)
    with torch.no_grad():
        got = tm.token_encoder.embed_with(_t(e), apply_final_ln=apply_final_ln)
    _check(got, _jax(lambda m, v: m.embed_with(v, apply_final_ln=apply_final_ln), jm.token_encoder, jnp.asarray(e)))


def test_activations() -> None:
    x = np.linspace(-6.0, 6.0, 1001, dtype=np.float32)
    _check(t_quick_gelu(_t(x)), x * jax.nn.sigmoid(1.702 * jnp.asarray(x)), 1e-6)
    _check(t_gelu(_t(x)), jax.nn.gelu(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("activation", ["quick_gelu", "gelu"])
def test_block_by_activation(activation) -> None:
    """One pre-norm block with each MLP activation (ViT-H/14 runs GELU, the others quick GELU)."""
    jm = JC.CLIPBlock(32, 2, activation=activation, rngs=nnx.Rngs(0))
    tm = bridged(jm, _port(TC.CLIPBlock, dim=32, num_heads=2, activation=activation))
    x = np.random.RandomState(7).randn(2, 9, 32).astype(np.float32)
    with torch.no_grad():
        _check(tm(_t(x)), _jax(lambda m, v: m(v), jm, jnp.asarray(x)))


# ---- the zoo and the bridge ----

PRESETS = ["multimodal/clip", "multimodal/clip.large", "multimodal/clip.open_clip_ViT_H_14", "sr/esr", "sr/esr.anime"]
PRESET_COUNTS = {"clip": 151_277_313, "clip_large": 427_616_513, "open_clip_ViT_H_14": 986_109_441, "esr": 16_697_987,
            "esr_anime": 4_467_779}


@pytest.mark.parametrize("config", PRESETS)
def test_parse_config(config) -> None:
    assert tzoo.parse_config(config) == jzoo.parse_config(config)


def test_presets_are_the_port_own_copies() -> None:
    import cflearn_tpu.zoo.common as jcommon

    for rel in ("multimodal/clip.json", "sr/esr.json"):
        port = tzoo.CONFIGS_DIR / rel
        assert port.is_file() and "cflearn_torch" in port.parts
        assert port.read_bytes() == (Path(jcommon.CONFIGS_DIR) / rel).read_bytes()
        json.loads(port.read_text())


# one block (one layer a tower): the structure repeats, so one maps as all do, at a fraction of the trace
ONE_DEEP = {"clip": dict(vision_num_layers=1, text_num_layers=1), "esr": dict(num_blocks=1)}


@pytest.mark.parametrize("name", sorted(PRESET_COUNTS))
def test_presets_bridge_one_to_one_at_full_width(name) -> None:
    """Each preset at full width, one block deep: the JAX constructor's parameters (shapes only,
    `nnx.eval_shape`) map one to one onto the port's (built on "meta"): the class and positional embeddings and
    the logit scale as they are, the patch conv HWIO -> OIHW, every RRDB conv. At full depth the port counts the
    JAX constructor's parameters (`nnx.eval_shape` of the presets as they are)."""
    assert sum(p.numel() for p in getattr(tzoo, name)(device="meta").parameters()) == PRESET_COUNTS[name]
    cut = ONE_DEEP["esr" if name.startswith("esr") else "clip"]
    m = getattr(tzoo, name)(device="meta", **cut)
    jm = nnx.eval_shape(lambda: getattr(jzoo, name)(**cut))
    shapes = flat_shapes(jm)
    mapping = map_names(shapes, m)
    assert len(mapping) == len(shapes) == len(list(m.parameters()))
    if name.startswith(("clip", "open")):
        assert mapping["vit.conv.kernel"] == ("vit.conv.weight", (3, 2, 0, 1))
        for leaf in ("vit.class_embedding", "vit.positional_embedding", "logit_scale"):
            assert mapping[leaf] == (leaf, None)
        assert tuple(m.vit.positional_embedding.shape)[0] == {"clip": 50}.get(name, 257)
    else:
        assert sum(k.endswith(".kernel") for k in mapping) == 6 + 3 * 5  # six outside the block, five a dense block


def test_bridge_is_strict_both_ways(tiny_clip) -> None:
    """Every JAX leaf has one port parameter of its shape and every port parameter one JAX leaf; a missing or an
    extra leaf raises; the loaded parameters equal the JAX ones, conv kernels transposed."""
    jm, tm = tiny_clip
    flat = flat_params(jm)
    mapping = map_names({k: v.shape for k, v in flat.items()}, tm)
    assert len(mapping) == len(flat) == len(list(tm.parameters()))
    params = dict(tm.named_parameters())
    np.testing.assert_array_equal(params["vit.conv.weight"].detach().numpy(),
                                  flat["vit.conv.kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(params["logit_scale"].detach().numpy(), flat["logit_scale"])
    for drop in ("vit.class_embedding", "logit_scale", "vit.conv.kernel"):
        with pytest.raises(ValueError, match="no JAX leaf"):
            map_names({k: v.shape for k, v in flat.items() if k != drop}, tm)
    with pytest.raises(ValueError, match="no such port parameter"):
        map_names(dict({k: v.shape for k, v in flat.items()}, **{"vit.extra_embedding": (3,)}), tm)


def test_pretrained_raises() -> None:
    """Pretrained weights load from the local cache onto a real device (`tests/test_torch_pretrained.py`):
    on "meta" every constructor refuses before it reads anything."""
    for fn in (tzoo.clip, tzoo.clip_large, tzoo.open_clip_ViT_H_14, tzoo.esr, tzoo.esr_anime):
        with pytest.raises(ValueError, match="not 'meta'"):
            fn(pretrained=True, device="meta")
