"""The CLIP tokenizers (counterpart of `cflearn_tpu/modules/nlp/tokenizers.py`,
numpy only), with the `ITokenizer` registry: `CLIPTokenizer` ("clip") and
`ChineseCLIPTokenizer` ("chinese_clip").

The CLIP BPE is implemented here: byte-pair merges over the standard CLIP
vocab. The merges load from a local file (`bpe_path`), then from
`bpe_simple_vocab_16e6.txt.gz` in `OPT.cache_dir`, then from an installed
`transformers` cache, in that order; without any of them a deterministic
byte-level fallback keeps the pipeline runnable offline (random weights,
where exact token ids do not matter). `provenance` says which one is in use.
"""

import gzip
import html
import os
import re
from functools import lru_cache
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ...parameters import OPT
from ...toolkit.registry import WithRegister

MERGES_FILE = "bpe_simple_vocab_16e6.txt.gz"


def cached_tokenizer(class_name: str, name: str) -> Optional[Any]:
    """`transformers.<class_name>.from_pretrained(name)` from the local
    cache only, or None where the package does not import, the load raises,
    or the tokenizer knows no token besides its special ones: where the
    vocabulary is not cached, `transformers` 5 builds such a tokenizer
    without raising (`BertTokenizer`: its 5 special tokens;
    `GPT2Tokenizer`: 1), which maps every word to `[UNK]` and decodes
    every id to ''."""
    try:
        import transformers  # type: ignore

        tok = getattr(transformers, class_name).from_pretrained(name, local_files_only=True)
    except Exception:  # noqa: BLE001 — not installed, or the vocabulary is not cached
        return None
    return tok if len(tok) > len(set(tok.all_special_ids)) else None


class ITokenizer(WithRegister):
    """The tokenizers' registry: `ITokenizer.make("clip")`."""

    d: Dict[str, type] = {}

    def tokenize(self, texts: Any, **kwargs: Any) -> np.ndarray:
        raise NotImplementedError


# the reference's name of the CLIP tokenizers' base
ICLIPTokenizer = ITokenizer


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


@ITokenizer.register("clip")
class CLIPTokenizer(ITokenizer):
    """CLIP byte-pair encoding (context length 77, SOT/EOT tokens)."""

    context_length = 77

    def __init__(self, bpe_path: Optional[str] = None, *, truncate: bool = True) -> None:
        self.truncate = truncate
        self.byte_encoder = _bytes_to_unicode()
        merges = self._load_merges(bpe_path)
        # "byte-fallback" must never pass for real tokenized prompts
        self.provenance = "byte-fallback" if merges is None else "bpe-merges"
        if merges is None:
            merges = []  # deterministic fallback: byte-level vocab only, no merges
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]
        # CLIP's pre-tokenization: letter runs stay together, each digit is
        # its own token, everything else (non-space) groups
        try:
            import regex

            self.pat = regex.compile(
                r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
                regex.IGNORECASE,
            )
        except ImportError:  # stdlib approximation of the unicode classes
            self.pat = re.compile(
                r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                r"|[^\W\d_]+|\d|[^\s\w]+|_+",
                re.IGNORECASE,
            )

    @staticmethod
    def _load_merges(bpe_path: Optional[str]) -> Optional[List[Tuple[str, str]]]:
        candidates = [p for p in (bpe_path, os.path.join(OPT.cache_dir, MERGES_FILE)) if p]
        for path in candidates:
            if os.path.isfile(path):
                opener = gzip.open if path.endswith(".gz") else open
                with opener(path, "rt", encoding="utf-8") as f:  # type: ignore[operator]
                    lines = f.read().split("\n")
                lines = lines[1 : 49152 - 256 - 2 + 1]
                return [tuple(line.split()) for line in lines if line]
        # an installed transformers cache, read without network
        try:
            from transformers.utils import cached_file  # type: ignore

            path = cached_file("openai/clip-vit-base-patch32", "merges.txt", local_files_only=True)
            with open(path, "r", encoding="utf-8") as f:
                lines = f.read().split("\n")[1:]
            return [tuple(line.split()) for line in lines if line][: 49152 - 256 - 2]
        except Exception:  # noqa: BLE001 — not installed, or nothing cached
            return None

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs or not self.bpe_ranks:
            # no merges loaded: per-character symbols are in the base vocab,
            # a whole-word symbol like 'hello</w>' is not
            if not self.bpe_ranks and len(word) > 1:
                return " ".join(word)
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token_bytes = token.encode("utf-8")
            token_trans = "".join(self.byte_encoder[b] for b in token_bytes)
            tokens.extend(self.encoder[t] for t in self.bpe(token_trans).split(" ") if t in self.encoder)
        return tokens

    def tokenize(self, texts: Any) -> np.ndarray:
        """(B, 77) int32 ids: SOT, the text's tokens, EOT, zero padding; a
        longer text is cut to 77 with EOT last (or raises without
        `truncate`)."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), self.context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(tokens) > self.context_length:
                if not self.truncate:
                    raise ValueError(f"text too long: {text}")
                tokens = tokens[: self.context_length]
                tokens[-1] = self.eot_token
            result[i, : len(tokens)] = tokens
        return result


@ITokenizer.register("chinese_clip")
class ChineseCLIPTokenizer(ITokenizer):
    """ChineseCLIP's BERT word pieces (context length 52): `transformers`'
    `AutoTokenizer` for `name` from its local cache only; where the package
    or the vocabulary is missing, the deterministic character path
    (`_char_tokenize`), which keeps random-weight pipelines running offline."""

    context_length = 52

    def __init__(self, name: str = "OFA-Sys/chinese-clip-vit-base-patch16") -> None:
        self.name = name
        self._tok: Any = None

    def tokenize(self, texts: Any, **kwargs: Any) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        if self._tok is None:
            self._tok = cached_tokenizer("AutoTokenizer", self.name) or "char"
        if self._tok == "char":
            return self._char_tokenize(texts)
        out = self._tok(texts, padding="max_length", truncation=True, max_length=self.context_length,
                        return_tensors="np")
        return out["input_ids"].astype(np.int32)

    def _char_tokenize(self, texts: List[str]) -> np.ndarray:
        """(B, 52) int32: [CLS] = 101, one id a character (1000 + its code
        point modulo 21128 - 1106, inside BERT's word-piece range), [SEP] =
        102, zero padding; a text is cut to 50 characters. Not the ids of
        the pretrained vocabulary."""
        cls_id, sep_id, vocab = 101, 102, 21128
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [cls_id] + [1000 + ord(ch) % (vocab - 1106) for ch in text[: self.context_length - 2]] + [sep_id]
            out[i, : len(ids)] = ids
        return out
