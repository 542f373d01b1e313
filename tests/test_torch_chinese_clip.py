"""ChineseCLIP in the port against the JAX package's, in f32 on the CPU at
tiny widths: the tokenizer's character path (ids, truncation at 52, and the
guarded `transformers` load falling back to it without the package or
without a cached vocabulary), the BERT text tower (`BertTextEncoder`: the
hidden states and the tanh pooler), `ChineseCLIP.encode_image` /
`encode_text` and its logits, `CLIPExtractor` choosing the Chinese
tokenizer (by class, and by a 512-token context) with its text and image
latents, and the zoo's `chinese_clip`, which refuses `pretrained=True` on
both sides.

Each JAX module is built with `nnx.Rngs(0)`, its parameters carried across
by `cflearn_torch.bridge`; both get the same seeded numpy inputs.
Tolerance: 1e-5 of max|ref| (f32 summation order)."""

import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import cflearn_torch
from _torch_bridge_common import bridged, rel_err
from cflearn_torch import zoo as tzoo
from cflearn_torch.api.multimodal.clip import CLIPExtractor
from cflearn_torch.modules.multimodal import clip as TC
from cflearn_torch.modules.nlp.tokenizers import ChineseCLIPTokenizer, CLIPTokenizer
from cflearn_tpu import zoo as jzoo
from cflearn_tpu.api.multimodal.clip import CLIPExtractor as JCLIPExtractor
from cflearn_tpu.modules.multimodal import clip as JC
from cflearn_tpu.modules.nlp import tokenizers as JT

TOL = 1e-5
TINY = dict(
    img_size=28, latent_dim=24, vision_latent_dim=32, vision_patch_size=14, vision_num_layers=2, vision_num_heads=2,
    text_latent_dim=32, text_num_layers=2, text_num_heads=2,
)  # the 21,128-id vocabulary and the 512-token table of the default
TEXTS = ["一只猫的照片", "a red car 在路上", "", "长" * 60]


def _check(got: torch.Tensor, ref, tol: float = TOL) -> None:
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    assert rel_err(got.detach().numpy(), ref) < tol


@pytest.fixture(scope="module")
def tiny():
    jm = JC.ChineseCLIP(rngs=nnx.Rngs(0), **TINY)
    return jm, bridged(jm, cflearn_torch.build(TC.ChineseCLIP, device="cpu", **TINY))


@pytest.fixture(scope="module")
def tokens():
    return ChineseCLIPTokenizer()._char_tokenize(TEXTS)


def test_char_tokenizer_matches_jax(tokens) -> None:
    ref = JT.ChineseCLIPTokenizer()._char_tokenize(TEXTS)
    assert tokens.dtype == ref.dtype == np.int32 and np.array_equal(tokens, ref)
    assert tokens.shape == (4, 52) and tokens.max() < 21128
    assert list(tokens[2, :3]) == [101, 102, 0]  # the empty text: [CLS] [SEP], padding
    assert tokens[3, 0] == 101 and tokens[3, 51] == 102 and len(set(tokens[3, 1:51])) == 1  # cut to 50 characters


@pytest.mark.parametrize("missing", ["package", "vocabulary"])
def test_tokenizer_falls_back_to_characters(missing, monkeypatch) -> None:
    """Without `transformers`, or with it and no cached vocabulary, both tokenizers take the character path."""
    if missing == "package":
        monkeypatch.setitem(sys.modules, "transformers", None)  # `from transformers import ...` raises ImportError
    else:
        def no_cache(*args, **kwargs):
            raise OSError("not in the local cache")

        fake = types.SimpleNamespace(AutoTokenizer=types.SimpleNamespace(from_pretrained=no_cache))
        monkeypatch.setitem(sys.modules, "transformers", fake)
    got, ref = ChineseCLIPTokenizer().tokenize(TEXTS[:2]), JT.ChineseCLIPTokenizer().tokenize(TEXTS[:2])
    assert np.array_equal(got, ref) and np.array_equal(got, ChineseCLIPTokenizer()._char_tokenize(TEXTS[:2]))
    assert np.array_equal(ChineseCLIPTokenizer().tokenize(TEXTS[0]), got[:1])


def test_bert_text_encoder(tiny, tokens) -> None:
    jm, tm = tiny
    hidden, pooled = nnx.jit(lambda m, t: m(t, return_pooled=True))(jm.token_encoder, jnp.asarray(tokens))
    with torch.no_grad():
        got_hidden, got_pooled = tm.token_encoder(torch.from_numpy(tokens).long(), return_pooled=True)
    _check(got_hidden, hidden)
    _check(got_pooled, pooled)
    assert float(np.abs(np.asarray(pooled)).max()) < 1.0  # tanh


@pytest.mark.parametrize("normalize", [True, False])
def test_chinese_clip_encoders_and_logits(tiny, tokens, normalize) -> None:
    jm, tm = tiny
    images = np.random.RandomState(1).randn(2, 28, 28, 3).astype(np.float32)
    ref_img = nnx.jit(lambda m, x: m.encode_image(x, normalize=normalize))(jm, jnp.asarray(images))
    ref_txt = nnx.jit(lambda m, t: m.encode_text(t, normalize=normalize))(jm, jnp.asarray(tokens))
    with torch.no_grad():
        _check(tm.encode_image(torch.from_numpy(images), normalize=normalize), ref_img)
        _check(tm.encode_text(torch.from_numpy(tokens).long(), normalize=normalize), ref_txt)
        out = tm(torch.from_numpy(images), torch.from_numpy(tokens).long())
    ref = nnx.jit(lambda m, x, t: m(x, t))(jm, jnp.asarray(images), jnp.asarray(tokens))
    for key in ("image_embeds", "text_embeds", "logits_per_image", "logits_per_text"):
        _check(out[key], ref[key])


def test_chinese_clip_structure_and_registry() -> None:
    with torch.device("meta"):
        tm = TC.ChineseCLIP(**TINY)
    assert isinstance(tm.token_encoder, TC.BertTextEncoder) and tm.context_length == 512
    assert not hasattr(tm.token_encoder, "ln_final")  # no TeTEncoder was built
    assert cflearn_torch.modules.common.module_registry["clip.chinese"] is TC.ChineseCLIP
    with pytest.raises(TypeError, match="unrecognized ChineseCLIP kwargs"), torch.device("meta"):
        TC.ChineseCLIP(vision_width=3)


def test_extractor_picks_the_chinese_tokenizer(tiny) -> None:
    jm, tm = tiny
    japi, tapi = JCLIPExtractor(jm), CLIPExtractor(tm, device="cpu")
    assert isinstance(tapi.tokenizer, ChineseCLIPTokenizer) and isinstance(japi.tokenizer, JT.ChineseCLIPTokenizer)
    _check(torch.from_numpy(np.asarray(tapi.get_text_latent(TEXTS))), japi.get_text_latent(TEXTS))
    images = np.random.RandomState(2).randint(0, 256, (2, 28, 28, 3)).astype(np.uint8)
    _check(torch.from_numpy(np.asarray(tapi.get_image_latent(images))), japi.get_image_latent(images), 1e-4)
    # a plain CLIP keeps the English tokenizer
    plain = cflearn_torch.build(TC.CLIP, device="cpu", img_size=28, vision_patch_size=14, vision_latent_dim=32,
                                vision_num_layers=1, vision_num_heads=2, latent_dim=24, vocab_size=600,
                                text_latent_dim=32, text_num_layers=1, text_num_heads=2)
    assert isinstance(CLIPExtractor(plain, device="cpu").tokenizer, CLIPTokenizer)


def test_zoo_chinese_clip() -> None:
    for make in (tzoo.chinese_clip, jzoo.chinese_clip):
        with pytest.raises(ValueError, match="only re-hosted in the reference's cflearn layout"):
            make(pretrained=True)
    tm = tzoo.chinese_clip(device="meta")
    assert type(tm) is TC.ChineseCLIP and tm.token_encoder.positional_embedding.shape == (512, 1024)
    assert len(tm.vit.blocks) == len(tm.token_encoder.blocks) == 24 and tm.vit.blocks[0].attn.num_heads == 16
