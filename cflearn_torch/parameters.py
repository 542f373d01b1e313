"""Process-global settings (counterpart of `cflearn_tpu/parameters.py`):
`OPT`, read from the JSON in the `CFLEARN_TORCH_ENV` environment variable
over the defaults, and overridden in place (`update`) or for a block
(`opt_context`).

- `cache_dir` (`~/.cache/cflearn_torch`): checkpoints are served from
  `cache_dir/download/<file name>` and their converted tensors cached in
  `cache_dir/converted/`; the CLIP tokenizer's merges file is looked for here;
- `sd_weights_pool_limit`: how many SD state dicts a `Weights` pool keeps
  (-1: no bound).

A malformed JSON in the environment variable is ignored, as in the JAX
package.
"""

import json
import os
from pathlib import Path
from typing import Any, Dict


class OPTClass:
    env_key = "CFLEARN_TORCH_ENV"

    def __init__(self) -> None:
        self._defaults: Dict[str, Any] = dict(
            cache_dir=os.path.join(str(Path.home()), ".cache", "cflearn_torch"),
            sd_weights_pool_limit=-1,
        )
        self._overrides: Dict[str, Any] = {}
        env = os.environ.get(self.env_key)
        if env:
            try:
                self._overrides.update(json.loads(env))
            except json.JSONDecodeError:
                pass

    def __getattr__(self, key: str) -> Any:
        defaults = object.__getattribute__(self, "_defaults")
        overrides = object.__getattribute__(self, "_overrides")
        if key in overrides:
            return overrides[key]
        if key in defaults:
            return defaults[key]
        raise AttributeError(key)

    def update(self, **kwargs: Any) -> None:
        self._overrides.update(kwargs)

    class _Ctx:
        def __init__(self, opt: "OPTClass", settings: Dict[str, Any]) -> None:
            self.opt = opt
            self.settings = settings
            self.backup: Dict[str, Any] = {}

        def __enter__(self) -> None:
            self.backup = dict(self.opt._overrides)
            self.opt._overrides.update(self.settings)

        def __exit__(self, *args: Any) -> None:
            self.opt._overrides = self.backup

    def opt_context(self, settings: Dict[str, Any]) -> "OPTClass._Ctx":
        """The settings overridden inside the block, restored after it."""
        return OPTClass._Ctx(self, settings)

    @property
    def cache_dir_path(self) -> Path:
        return Path(self.cache_dir)


OPT = OPTClass()
