#!/usr/bin/env python3
"""The cached `bert-base-uncased` and `distilgpt2` tokenizers alone, without
the port: whether they round-trip a prompt.

    python3 scripts/tokenizer_probe.py

`BLIPAPI.caption` and `PromptEnhanceAPI.enhance` load these two from
`transformers`' local cache (`local_files_only=True`) and decode their ids
with them. This script loads each the same way and prints, for each: the
`transformers` version, the class, `len(tokenizer)`, `vocab_size`, the
files it was built from with their sizes, the first entries of its
vocabulary, a prompt's ids, their tokens and `decode` of them (with and
without `skip_special_tokens`, and of the same ids as a numpy int32 row, as
the APIs hand them). It writes the same as JSON to
`chiprun_out/tokenizer_probe.json`. Exits 0 whether or not a tokenizer
loads: what loads is the finding.
"""

import json
import os
import sys

PROMPT = "a picture of a cat sitting on a chair"


def probe(name: str, cls_name: str) -> dict:
    import numpy as np
    import transformers

    rec = {"name": name, "transformers": transformers.__version__}
    try:
        cls = getattr(transformers, cls_name)
        tok = cls.from_pretrained(name, local_files_only=True)
    except Exception as e:  # noqa: BLE001 — a failed load is a finding, reported verbatim
        rec["error"] = f"{type(e).__name__}: {e}"
        return rec
    rec["class"] = f"{type(tok).__module__}.{type(tok).__qualname__}"
    rec["len"] = len(tok)
    rec["vocab_size"] = tok.vocab_size
    files = {}
    for key, path in getattr(tok, "vocab_files_names", {}).items():
        full = getattr(tok, key, None) or tok.init_kwargs.get(key)
        if isinstance(full, str) and os.path.isfile(full):
            files[key] = {"file": os.path.basename(full), "bytes": os.path.getsize(full)}
    rec["files"] = files
    vocab = tok.get_vocab()
    rec["vocab_first"] = sorted(vocab.items(), key=lambda kv: kv[1])[:12]
    rec["vocab_sample"] = [tok.convert_ids_to_tokens(i) for i in (1000, 2000, 4937, 8000)]
    ids = tok(PROMPT).input_ids
    rec["ids"] = list(map(int, ids))
    rec["tokens"] = tok.convert_ids_to_tokens(ids)
    rec["decode"] = tok.decode(ids)
    rec["decode_skip_special"] = tok.decode(ids, skip_special_tokens=True)
    rec["decode_numpy_int32"] = tok.decode(np.asarray(ids, np.int32), skip_special_tokens=True)
    rec["round_trips"] = rec["decode_skip_special"].strip() == PROMPT
    return rec


def main() -> int:
    try:
        import transformers  # noqa: F401
    except ImportError as e:
        print(f"tokenizers: transformers does not import: {e}")
        return 0
    out = [probe("bert-base-uncased", "BertTokenizer"), probe("distilgpt2", "GPT2Tokenizer")]
    for rec in out:
        if "error" in rec:
            print(f"tokenizer {rec['name']}: not loaded: {rec['error']}")
            continue
        print(f"tokenizer {rec['name']}: {rec['class']}, len {rec['len']}, vocab_size {rec['vocab_size']}, files "
              f"{json.dumps(rec['files'])}, first vocabulary entries {rec['vocab_first']}, ids {rec['ids']}, tokens "
              f"{rec['tokens']}, decode {rec['decode']!r}, skipping specials {rec['decode_skip_special']!r}, from an "
              f"int32 row {rec['decode_numpy_int32']!r}; round-trips: {rec['round_trips']}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "tokenizer_probe.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
