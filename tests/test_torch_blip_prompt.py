"""BLIP captioning and the GPT-2 prompt API in the port against the JAX
package's, in f32 on the CPU at tiny widths.

BLIP: the vision features, the decoder's logits under a causal and padding
mask, `generate_caption_tokens` (greedy, rows padded after their [SEP]),
`BLIPAPI.caption` with a stand-in tokenizer (the antialiased resize, the
prompt's ids, the decode) and raising without one, whether `transformers`
or its cached vocabulary is missing (or holds its special tokens alone,
where the port departs from the JAX package), and `convert_blip` from the official
checkpoint's layout. GPT-2: the logits, `sample_tokens` with `top_k=1`
(exact without any hook) and at the `PromptConfig` defaults with the JAX
package's own Gumbel draws fed in, the repetition penalty's mark on
`eos_token` (which fills every position not yet drawn), `enhance` raising
without a tokenizer, and `convert_gpt2` from a HF `GPT2LMHeadModel` state
dict.

Each JAX module is built by `_torch_cv_common.fast_build`, its parameters
carried across by `cflearn_torch.bridge`. Tolerances: features and logits
1e-5 of max|ref| (f32 summation order); tokens exactly."""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from _torch_annotator_common import npd, port
from _torch_bridge_common import bridged, rel_err
from _torch_cv_common import fast_build
from cflearn_torch import bridge as B
from cflearn_torch.api.multimodal.third_party import blip as TB
from cflearn_torch.api.nlp.third_party import prompt as TPR
from cflearn_tpu.api.multimodal.third_party import blip as JB
from cflearn_tpu.api.nlp.third_party import prompt as JPR

TOL = 1e-5
BLIP = dict(img_size=32, dim=32, vision_depth=2, text_depth=2, heads=2, vocab_size=120)
GPT2 = dict(vocab_size=120, dim=32, num_layers=2, num_heads=2, max_positions=64)


def _check(got, ref, tol: float = TOL) -> None:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and rel_err(got, ref) < tol


def _no_transformers(monkeypatch, missing: str, name: str) -> None:
    """`transformers` absent (`missing="package"`), or present without the cached vocabulary of tokenizer `name`."""
    if missing == "package":
        monkeypatch.setitem(sys.modules, "transformers", None)
        return

    def no_cache(*args, **kwargs):
        raise OSError("not in the local cache")

    fake = types.SimpleNamespace(**{name: types.SimpleNamespace(from_pretrained=no_cache)})
    monkeypatch.setitem(sys.modules, "transformers", fake)


# ---- BLIP ----


@pytest.fixture(scope="module")
def blip():
    jm = fast_build(lambda: JB.BLIPCaptioner(rngs=nnx.Rngs(0), **BLIP), seed=50)
    return jm, port(lambda: TB.BLIPCaptioner(**BLIP), B.blip_state_dict(npd(jm)))


@pytest.fixture(scope="module")
def pixels():
    return np.random.RandomState(51).randn(2, 32, 32, 3).astype(np.float32)


def test_blip_vision_features(blip, pixels) -> None:
    jm, tm = blip
    ref = nnx.jit(lambda m, x: m(x))(jm.visual_encoder, jnp.asarray(pixels))
    with torch.no_grad():
        got = tm.visual_encoder(torch.from_numpy(pixels))
    assert got.shape == (2, 5, 32)  # the class token and 2 x 2 patches
    _check(got, ref)


def test_blip_decoder_logits(blip, pixels) -> None:
    jm, tm = blip
    rng = np.random.RandomState(52)
    tokens = rng.randint(0, BLIP["vocab_size"], (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), bool)
    mask[0, 6:] = False
    mask[1, 3:5] = False
    enc = nnx.jit(lambda m, x: m(x))(jm.visual_encoder, jnp.asarray(pixels))
    ref = nnx.jit(lambda m, t, e, k: m(t, e, k))(jm.text_decoder, jnp.asarray(tokens), enc, jnp.asarray(mask))
    with torch.no_grad():
        got = tm.text_decoder(torch.from_numpy(tokens).long(), torch.from_numpy(np.asarray(enc)), torch.from_numpy(mask))
    assert got.shape == (2, 9, BLIP["vocab_size"])
    _check(got, ref)


def test_blip_generate_caption_tokens(blip, pixels) -> None:
    jm, tm = blip
    prompt = np.asarray([101, 5, 7, 9])
    free = JB.generate_caption_tokens(jm, jnp.asarray(pixels), prompt, max_length=14, eos_token=119)
    # a [SEP] that the rows draw at different steps: each row is padded after its own
    eos = int(free[0, 6])
    ref = JB.generate_caption_tokens(jm, jnp.asarray(pixels), prompt, max_length=14, eos_token=eos, pad_token=3)
    got = TB.generate_caption_tokens(tm, torch.from_numpy(pixels), prompt, max_length=14, eos_token=eos, pad_token=3)
    assert got.dtype == np.int32 and np.array_equal(got, ref), (got, ref)
    assert np.array_equal(got[:, :4], np.stack([prompt] * 2)) and (got[0, 7:] == 3).all()
    assert np.array_equal(TB.generate_caption_tokens(tm, torch.from_numpy(pixels), prompt, max_length=14,
                                                     eos_token=119), free)


class _StandInTokenizer:
    """What `caption` reads of `BertTokenizer`: ids of a prompt with [CLS] first and [SEP] last, the special
    ids, and `decode`."""

    bos_token_id, sep_token_id, pad_token_id = 110, 102, 0

    def __call__(self, text):
        return types.SimpleNamespace(input_ids=[101] + [10 + ord(c) % 90 for c in text] + [102])

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids if int(i) not in (0, 101, 102, 110))


def test_blip_caption_matches_jax(blip) -> None:
    jm, tm = blip
    japi = object.__new__(JB.BLIPAPI)
    japi.m, japi.tokenizer = jm, _StandInTokenizer()
    tapi = object.__new__(TB.BLIPAPI)
    tapi.m, tapi.device, tapi.tokenizer = tm, torch.device("cpu"), _StandInTokenizer()
    image = np.random.RandomState(53).randint(0, 256, (40, 36, 3)).astype(np.uint8)  # shrunk to 32, antialiased
    _check(tapi.preprocess(image), (jax.image.resize(jnp.asarray(image, jnp.float32)[None] / 255.0, (1, 32, 32, 3),
                                                     "bilinear") - np.asarray(TB.BLIP_MEAN)) / np.asarray(TB.BLIP_STD))
    ref = japi.caption(image, prompt="a photo ", max_length=12)
    assert tapi.caption(image, prompt="a photo ", max_length=12) == ref and len(ref.split()) > 7


@pytest.mark.parametrize("missing", ["package", "vocabulary"])
def test_blip_caption_raises_without_a_tokenizer(missing, monkeypatch) -> None:
    _no_transformers(monkeypatch, missing, "BertTokenizer")
    small = dict(BLIP, vision_depth=1, text_depth=1)
    image = np.zeros((32, 32, 3), np.uint8)
    for api in (JB.BLIPAPI(**small), TB.BLIPAPI(device="cpu", **small)):
        assert api.tokenizer is None
        with pytest.raises(RuntimeError, match="bert-base-uncased"):
            api.caption(image)


def _vocabulary_tokenizers(folder, words):
    """A `BertTokenizer` and a `GPT2Tokenizer` built from files that hold their special tokens and `words`: with
    no word, what `transformers` 5 hands back for a tokenizer whose vocabulary is not cached."""
    import json

    from transformers import BertTokenizer, GPT2Tokenizer

    (folder / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *words]) + "\n")
    (folder / "vocab.json").write_text(json.dumps({"<|endoftext|>": 0, **{w: i + 1 for i, w in enumerate(words)}}))
    (folder / "merges.txt").write_text("#version: 0.2\n")
    return {"BertTokenizer": BertTokenizer(str(folder / "vocab.txt")),
            "GPT2Tokenizer": GPT2Tokenizer(str(folder / "vocab.json"), str(folder / "merges.txt"))}


@pytest.mark.parametrize("words", [(), ("a", "picture", "of", "cat")], ids=["specials_alone", "words"])
def test_a_cached_vocabulary_of_special_tokens_alone_is_missing(words, tmp_path, monkeypatch) -> None:
    """Where the vocabulary is not cached, `transformers` 5 builds a tokenizer of its special tokens alone instead
    of raising (5.5.0: a `BertTokenizer` of length 5, a `GPT2Tokenizer` of length 1; `scripts/tokenizer_probe.py`
    prints what a machine's cache gives), which decodes every id to ''. The port counts it as missing: `caption`
    and `enhance` raise, as without the package. A vocabulary that holds words loads."""
    built = _vocabulary_tokenizers(tmp_path, list(words))
    fake = types.SimpleNamespace(**{k: types.SimpleNamespace(from_pretrained=lambda *a, _t=t, **k: _t)
                                    for k, t in built.items()})
    monkeypatch.setitem(sys.modules, "transformers", fake)
    blip = TB.BLIPAPI(device="cpu", **dict(BLIP, vision_depth=1, text_depth=1))
    enhance = TPR.PromptEnhanceAPI(num_layers=1, device="cpu")
    if words:
        assert blip.tokenizer is built["BertTokenizer"] and enhance.tokenizer is built["GPT2Tokenizer"]
        assert blip.tokenizer.decode(blip.tokenizer("a picture of cat").input_ids, skip_special_tokens=True) == (
            "a picture of cat")
        return
    assert len(built["BertTokenizer"]) == 5 and len(built["GPT2Tokenizer"]) == 1
    assert built["BertTokenizer"].decode(built["BertTokenizer"]("a cat").input_ids, skip_special_tokens=True) == ""
    assert blip.tokenizer is None and enhance.tokenizer is None
    with pytest.raises(RuntimeError, match="bert-base-uncased"):
        blip.caption(np.zeros((32, 32, 3), np.uint8))
    with pytest.raises(RuntimeError, match="distilgpt2"):
        enhance.enhance("a cat")


def _official_blip(params, seed):
    """A seeded state dict in the official BLIP caption checkpoint's layout
    for the JAX net of `params` (what `convert_blip` reads), with the HF
    decoder's token-type table, `position_ids` buffer and tied bias."""
    rng = np.random.RandomState(seed)
    sd = {}

    def put(key, shape, scale=0.1):
        sd[key] = (rng.randn(*shape) * scale).astype(np.float32)

    def linear(theirs, ours):
        i, o = params[f"{ours}/kernel/value"].shape
        put(f"{theirs}.weight", (o, i))
        put(f"{theirs}.bias", (o,))

    def ln(theirs, ours):
        put(f"{theirs}.weight", params[f"{ours}/scale/value"].shape)
        put(f"{theirs}.bias", params[f"{ours}/scale/value"].shape)

    v = "visual_encoder"
    put(f"{v}.cls_token", params[f"{v}/cls_token/value"].shape)
    put(f"{v}.pos_embed", params[f"{v}/pos_embed/value"].shape)
    kh, kw, ci, co = params[f"{v}/patch_embed/kernel/value"].shape
    put(f"{v}.patch_embed.proj.weight", (co, ci, kh, kw))
    put(f"{v}.patch_embed.proj.bias", (co,))
    for i in range(BLIP["vision_depth"]):
        bp, bo = f"{v}.blocks.{i}", f"{v}/blocks/{i}"
        ln(f"{bp}.norm1", f"{bo}/norm1")
        ln(f"{bp}.norm2", f"{bo}/norm2")
        for theirs, ours in (("attn.qkv", "qkv"), ("attn.proj", "proj"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            linear(f"{bp}.{theirs}", f"{bo}/{ours}")
    ln(f"{v}.norm", f"{v}/norm")
    emb, t = "text_decoder.bert.embeddings", "text_decoder"
    put(f"{emb}.word_embeddings.weight", params[f"{t}/word_embeddings/embedding/value"].shape)
    put(f"{emb}.position_embeddings.weight", params[f"{t}/position_embeddings/embedding/value"].shape)
    put(f"{emb}.token_type_embeddings.weight", (2, BLIP["dim"]))
    sd[f"{emb}.position_ids"] = np.arange(512)[None]
    ln(f"{emb}.LayerNorm", f"{t}/emb_ln")
    for i in range(BLIP["text_depth"]):
        lp, lo = f"text_decoder.bert.encoder.layer.{i}", f"{t}/layers/{i}"
        for attn in ("attention", "crossattention"):
            for part in ("query", "key", "value"):
                linear(f"{lp}.{attn}.self.{part}", f"{lo}/{attn}/{part}")
            linear(f"{lp}.{attn}.output.dense", f"{lo}/{attn}/out")
            ln(f"{lp}.{attn}.output.LayerNorm", f"{lo}/{attn}/out_ln")
        linear(f"{lp}.intermediate.dense", f"{lo}/inter")
        linear(f"{lp}.output.dense", f"{lo}/output")
        ln(f"{lp}.output.LayerNorm", f"{lo}/output_ln")
    cls = "text_decoder.cls.predictions"
    linear(f"{cls}.transform.dense", f"{t}/transform")
    ln(f"{cls}.transform.LayerNorm", f"{t}/transform_ln")
    linear(f"{cls}.decoder", f"{t}/decoder")
    sd[f"{cls}.bias"] = sd[f"{cls}.decoder.bias"]
    return sd


def test_convert_blip_from_the_official_layout(blip) -> None:
    jm, tm = blip
    params = npd(jm)
    official = _official_blip(params, 54)
    converted = JB.convert_blip(official)
    assert set(converted) == set(params)
    ref = B.blip_state_dict(converted)
    got = TB.convert_blip(official)
    assert set(got) == set(ref) == set(tm.state_dict())
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    loaded = TB.load_blip(state_dict={"model": official}, device="cpu", **BLIP)
    assert all(torch.equal(loaded.state_dict()[k], ref[k]) for k in ref)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        TB.load_blip(state_dict={**official, "text_decoder.stray.weight": np.zeros(1, np.float32)}, device="cpu",
                     **BLIP)


# ---- GPT-2 ----


@pytest.fixture(scope="module")
def gpt2():
    jm = fast_build(lambda: JPR.GPT2LMHead(rngs=nnx.Rngs(0), **GPT2), seed=60)
    return jm, bridged(jm, TPR.GPT2LMHead(**GPT2))


def test_gpt2_logits(gpt2) -> None:
    jm, tm = gpt2
    tokens = np.random.RandomState(61).randint(0, GPT2["vocab_size"], (2, 11)).astype(np.int32)
    mask = np.ones((2, 11), bool)
    mask[1, 7:] = False
    for m in (None, mask):
        ref = nnx.jit(lambda net, t, k: net(t, k))(jm, jnp.asarray(tokens), None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got = tm(torch.from_numpy(tokens).long(), None if m is None else torch.from_numpy(m))
        _check(got, ref)


PROMPT = np.asarray([5, 7, 11, 13])


def test_sample_tokens_top_k_1_is_exact_without_a_hook(gpt2) -> None:
    jm, tm = gpt2
    kw = dict(max_length=18, top_k=1, eos_token=119, num_return_sequences=3)
    ref = JPR.sample_tokens(jm, PROMPT, key=jax.random.PRNGKey(5), **kw)
    got = TPR.sample_tokens(tm, PROMPT, **kw)
    assert got.dtype == np.int32 and np.array_equal(got, ref)
    assert np.array_equal(TPR.sample_tokens(tm, PROMPT, generator=torch.Generator().manual_seed(9), **kw), got)


def _jax_draws(key, n, shape):
    """The Gumbel noise `jax.random.categorical` adds at each of `n` steps of
    `sample_tokens`' scan (the carried key split in two, the second drawn)."""
    draws = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))
    return draws


def test_sample_tokens_at_the_defaults_with_the_jax_draws(gpt2) -> None:
    jm, tm = gpt2
    config = TPR.PromptConfig(num_return_sequences=4, max_length=24)
    kw = dict(max_length=config.max_length, temperature=config.temperature, top_k=config.top_k,
              repetition_penalty=config.repitition_penalty, num_return_sequences=config.num_return_sequences,
              eos_token=119)
    assert JPR.PromptConfig(num_return_sequences=4, max_length=24) == tuple(config)
    key = jax.random.PRNGKey(7)
    ref = JPR.sample_tokens(jm, PROMPT, key=key, **kw)
    draws = _jax_draws(key, config.max_length - len(PROMPT), (4, GPT2["vocab_size"]))
    got = TPR.sample_tokens(tm, PROMPT, gumbel=lambda shape: torch.from_numpy(draws.pop(0)), **kw)
    assert np.array_equal(got, ref) and not draws
    assert len({tuple(row) for row in got}) == 4  # four different samples


def test_repetition_penalty_marks_eos_as_seen(gpt2) -> None:
    """At every step the positions from `pos` on hold `eos_token`, so the penalty hits it though no row drew it:
    with the prompt's most likely next id as `eos_token`, a strong penalty makes the first draw another id."""
    jm, tm = gpt2
    with torch.no_grad():
        logits = tm(torch.from_numpy(PROMPT)[None].long())[0, -1]
    top2 = logits.topk(2)
    eos = int(top2.indices[0])
    assert eos not in PROMPT and float(top2.values[1]) > 0
    for penalty, first_is_eos in ((1.0, True), (1e4, False)):
        kw = dict(max_length=8, top_k=1, eos_token=eos, repetition_penalty=penalty)
        ref = JPR.sample_tokens(jm, PROMPT, **kw)
        got = TPR.sample_tokens(tm, PROMPT, **kw)
        assert np.array_equal(got, ref) and (got[0, 4] == eos) == first_is_eos
        assert first_is_eos == (got[0, 4:] == eos).all()


@pytest.mark.parametrize("missing", ["package", "vocabulary"])
def test_enhance_raises_without_a_tokenizer(missing, monkeypatch) -> None:
    _no_transformers(monkeypatch, missing, "GPT2Tokenizer")
    api = TPR.PromptEnhanceAPI(num_layers=1, device="cpu")
    assert api.tokenizer is None and len(api.m.blocks) == 1
    with pytest.raises(RuntimeError, match="distilgpt2"):
        api.enhance("a cat")


def test_convert_gpt2_from_the_hf_layout(gpt2) -> None:
    jm, tm = gpt2
    params = npd(jm)
    hf = {"transformer.wte.weight": params["wte/embedding/value"], "transformer.wpe.weight": params["wpe/embedding/value"],
          "transformer.ln_f.weight": params["ln_f/scale/value"], "transformer.ln_f.bias": params["ln_f/bias/value"],
          "lm_head.weight": params["wte/embedding/value"]}
    for i in range(GPT2["num_layers"]):
        for theirs, ours in (("ln_1", "ln_1"), ("ln_2", "ln_2")):
            hf[f"transformer.h.{i}.{theirs}.weight"] = params[f"blocks/{i}/{ours}/scale/value"]
            hf[f"transformer.h.{i}.{theirs}.bias"] = params[f"blocks/{i}/{ours}/bias/value"]
        for theirs, ours in (("attn.c_attn", "c_attn"), ("attn.c_proj", "c_proj"), ("mlp.c_fc", "mlp_fc"),
                             ("mlp.c_proj", "mlp_proj")):
            hf[f"transformer.h.{i}.{theirs}.weight"] = params[f"blocks/{i}/{ours}/kernel/value"]  # Conv1D: (in, out)
            hf[f"transformer.h.{i}.{theirs}.bias"] = params[f"blocks/{i}/{ours}/bias/value"]
        hf[f"transformer.h.{i}.attn.bias"] = np.tril(np.ones((64, 64), bool))[None, None]
        hf[f"transformer.h.{i}.attn.masked_bias"] = np.asarray(-1e4, np.float32)
    back = JPR.convert_gpt2(hf)
    assert all(np.array_equal(back[k], params[k]) for k in params)
    got = TPR.convert_gpt2(hf)
    ref = tm.state_dict()
    assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) for k in ref)
    loaded = TPR.load_gpt2(state_dict=hf, device="cpu", **GPT2)
    assert all(torch.equal(loaded.state_dict()[k], ref[k]) for k in ref)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        TPR.load_gpt2(state_dict={**hf, "transformer.h.0.stray": np.zeros(1, np.float32)}, device="cpu", **GPT2)
