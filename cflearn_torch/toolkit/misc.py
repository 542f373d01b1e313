"""Small helpers (counterpart of part of `cflearn_tpu/toolkit/misc.py`):
`seed_everything`, `slerp`, the `jax.checkpoint_policies` names as selective-checkpoint
policies (`resolve_checkpoint_policy`, `checkpoint_context_fn`), and the
framework's `check_is_ci`, `timestamp`, `sort_dict_by_value` and
`truncate_string_to_length`; and the download cache (`download`,
`download_json`, `download_checkpoint`, `compute_sha`, `check_sha_with`,
`get_download_cache_dir`); the JAX toolkit's helpers on tensors (`get_seed`,
`new_generator` for `new_rng_key`, `np_batch_to_tensor` / `tensor_batch_to_np`
for the JAX batch converters, AdaIN, `WeightsStrategy`, `ScalarEMA`, parameter
counts, copies and diffs by name, file info)."""

import functools
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..parameters import OPT

np_dict_type = Dict[str, Union[np.ndarray, Any]]


_seed: Optional[int] = None


def seed_everything(seed: int) -> int:
    """Seed Python's, numpy's and PyTorch's global generators with `seed`,
    and remember it (`maybe_initialize_distributed` then keeps it)."""
    import random

    global _seed
    _seed = int(seed)
    random.seed(_seed)
    np.random.seed(_seed)
    torch.manual_seed(_seed)
    return _seed


def check_is_ci() -> bool:
    """The `CI` environment flag, which turns a fit into a one-step debug run."""
    return bool(int(os.environ.get("CI", "0")))


def timestamp(*, simplify: bool = False, ensure_different: bool = False) -> str:
    """The local time as "%Y-%m-%d_%H-%M-%S"; with `ensure_different`, and a
    microsecond suffix."""
    s = time.strftime("%Y-%m-%d_%H-%M-%S", time.localtime())
    if not simplify and ensure_different:
        s = f"{s}-{int((time.time() % 1) * 1e6):06d}"
    return s


def sort_dict_by_value(d: Dict[Any, Any], *, reverse: bool = False) -> Dict[Any, Any]:
    return dict(sorted(d.items(), key=lambda kv: kv[1], reverse=reverse))


def truncate_string_to_length(string: str, length: int) -> str:
    if len(string) <= length:
        return string
    half = (length - 3) // 2
    return string[:half] + "..." + string[-half:]


def slerp(
    x1: torch.Tensor,
    x2: torch.Tensor,
    r1: Union[float, torch.Tensor],
    r2: Optional[Union[float, torch.Tensor]] = None,
    *,
    dot_threshold: float = 0.9995,
) -> torch.Tensor:
    """Spherical interpolation per sample (the leading axis): r1 of `x1`
    and r2 (default 1 - r1) of `x2`; nearly parallel samples are lerped."""
    if r2 is None:
        r2 = 1.0 - r1
    b = x1.shape[0]
    x1f, x2f = x1.reshape(b, -1), x2.reshape(b, -1)
    low_norm = x1f / torch.linalg.norm(x1f, dim=1, keepdim=True)
    high_norm = x2f / torch.linalg.norm(x2f, dim=1, keepdim=True)
    dot = (low_norm * high_norm).sum(dim=1, keepdim=True)
    omega = torch.arccos(dot.clamp(-1.0, 1.0))
    so = torch.sin(omega)
    lerped = r1 * x1f + r2 * x2f
    slerped = (torch.sin(r1 * omega) / so) * x1f + (torch.sin(r2 * omega) / so) * x2f
    return torch.where(dot.abs() > dot_threshold, lerped, slerped).reshape(x1.shape)


# --------------------------------------------------------------------------
# selective activation checkpointing: the `jax.checkpoint_policies` names
# --------------------------------------------------------------------------

# JAX's `dot_general` as PyTorch's dispatcher sees it: the 2-D products of a
# `Linear` (`mm`, `addmm`: no batch dimension) and the batched ones (`bmm`,
# `baddbmm`, and the library attention of the short-kv calls, whose JAX
# counterpart is a pair of batched `dot_general`s). A conv is no dot in
# either package.
_NO_BATCH_DOTS = ("mm.default", "addmm.default")
_BATCH_DOTS = (
    "bmm.default", "baddbmm.default", "_scaled_dot_product_flash_attention_for_cpu.default",
    "_scaled_dot_product_efficient_attention.default", "_scaled_dot_product_flash_attention.default",
    "_scaled_dot_product_cudnn_attention.default",
)
# policy factories: a name of one of them, given where a policy is expected,
# is called with the operation's arguments and fails
_POLICY_FACTORIES = (
    "offload_dot_with_no_batch_dims", "save_and_offload_only_these_names", "save_any_names_but_these",
    "save_anything_except_these_names", "save_from_both_policies", "save_only_these_names",
)


def _aten_ops(names: Any) -> frozenset:
    """The aten overloads named "op.overload" that this PyTorch build has."""
    ops = []
    for name in names:
        packet, overload = name.rsplit(".", 1)
        packet = getattr(torch.ops.aten, packet, None)
        if packet is not None and overload in packet.overloads():
            ops.append(getattr(packet, overload))
    return frozenset(ops)


def _save_ops(names: Any) -> Callable:
    """A policy that keeps the outputs of the aten ops `names` (None: of
    every op) and recomputes the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    saved = None if names is None else _aten_ops(names)

    def policy(ctx: Any, op: Any, *args: Any, **kwargs: Any) -> Any:
        return CheckpointPolicy.MUST_SAVE if saved is None or op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _factory(name: str) -> Callable:
    def policy(ctx: Any, op: Any, *args: Any, **kwargs: Any) -> Any:
        raise TypeError(
            f"{name}() is a policy factory, not a policy: it takes the names to save and returns the "
            f"policy (called here with the operation {op})"
        )

    return policy


# the direct names: the aten ops whose outputs each keeps (None: every op's)
_SAVED_OPS: Dict[str, Optional[Tuple[str, ...]]] = {
    "everything_saveable": None,
    "nothing_saveable": (),
    "dots_saveable": _NO_BATCH_DOTS + _BATCH_DOTS,
    "checkpoint_dots": _NO_BATCH_DOTS + _BATCH_DOTS,
    "dots_with_no_batch_dims_saveable": _NO_BATCH_DOTS,
    "checkpoint_dots_with_no_batch_dims": _NO_BATCH_DOTS,
}
CHECKPOINT_POLICY_NAMES = tuple(sorted(list(_SAVED_OPS) + list(_POLICY_FACTORIES)))


def resolve_checkpoint_policy(name: str) -> Callable:
    """The selective-checkpoint policy of a `jax.checkpoint_policies` name,
    for `torch.utils.checkpoint.create_selective_checkpoint_contexts`: a
    function (ctx, op, *args, **kwargs) -> `CheckpointPolicy`.

    - `everything_saveable` keeps every output, `nothing_saveable` none
      (what `use_checkpoint=True` does);
    - `dots_saveable` (alias `checkpoint_dots`) keeps the products: `mm`,
      `addmm`, `bmm`, `baddbmm` and the library attention;
    - `dots_with_no_batch_dims_saveable` (alias
      `checkpoint_dots_with_no_batch_dims`) keeps only `mm` and `addmm`, the
      2-D products of a `Linear`;
    - the six factory names resolve, as in JAX, to a policy that fails when
      it is first applied (at the first step with a gradient): in JAX the
      factory itself is called with the primitive's parameters.

    The hand-written kernels' forwards are operations of their own
    (`ops.attention`, `ops.group_norm`): no name keeps them but
    `everything_saveable`, as no JAX name but it keeps a `pallas_call`'s
    outputs. An unknown name raises `ValueError` with the valid names."""
    if name in _SAVED_OPS:
        return _save_ops(_SAVED_OPS[name])
    if name in _POLICY_FACTORIES:
        return _factory(name)
    raise ValueError(
        f"unknown remat policy {name!r}; valid jax.checkpoint_policies names: {list(CHECKPOINT_POLICY_NAMES)}"
    )


def checkpoint_context_fn(name: str) -> Callable:
    """`context_fn` for `torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`
    under the policy of `name`."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return functools.partial(create_selective_checkpoint_contexts, resolve_checkpoint_policy(name))


def is_local_rank_0() -> bool:
    """True in a single process, and in the process of rank 0 of an
    initialised `torch.distributed` group."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def random_hash() -> str:
    """A short unique id (for temporary registrations)."""
    import uuid

    return uuid.uuid4().hex


def make_indices_visualization_map(indices: Any) -> np.ndarray:
    """Each index rendered as a 28 x 28 white tile with its number drawn in
    the centre (a VQ-VAE codebook's visualisation), as float NHWC in
    [-1, 1]. Needs PIL."""
    from PIL import Image, ImageDraw

    tiles = []
    for idx in np.asarray(indices).reshape(-1):
        img = Image.new("L", (28, 28), 255)
        draw = ImageDraw.Draw(img)
        text = str(int(idx))
        bbox = draw.textbbox((0, 0), text)
        tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
        draw.text(((28 - tw) / 2 - bbox[0], (28 - th) / 2 - bbox[1]), text, fill=0)
        tiles.append(np.asarray(img, np.float32) / 127.5 - 1.0)
    return np.stack(tiles)[..., None]


# ---- the download cache ----


def compute_sha(path: str) -> str:
    """The sha256 hex digest of a file, read in 1 MiB chunks."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def check_sha_with(path: str, tgt_sha: str) -> bool:
    return compute_sha(path) == tgt_sha


def get_download_cache_dir() -> Path:
    """`OPT.cache_dir/download`, where `download` looks for a file first."""
    folder = Path(OPT.cache_dir) / "download"
    folder.mkdir(parents=True, exist_ok=True)
    return folder


# (path, sha, sha_prefix, min_size) of the files verified in this process: a multi-GB checkpoint is hashed once
_verified_downloads: set = set()


def _tofu_sha_file(dst_folder: Path) -> Path:
    return dst_folder / ".sha256.json"


def _tofu_get(dst_folder: Path, fname: str) -> Optional[str]:
    f = _tofu_sha_file(dst_folder)
    if not f.is_file():
        return None
    try:
        return json.loads(f.read_text()).get(fname)
    except (OSError, ValueError):  # an unreadable sidecar pins nothing
        return None


def _tofu_put(dst_folder: Path, fname: str, sha: str) -> None:
    f = _tofu_sha_file(dst_folder)
    try:
        d = json.loads(f.read_text()) if f.is_file() else {}
    except (OSError, ValueError):
        d = {}
    d[fname] = sha
    f.write_text(json.dumps(d, indent=2, sort_keys=True))


def download(
    url: str,
    *,
    name: Optional[str] = None,
    folder: Optional[str] = None,
    sha: Optional[str] = None,
    sha_prefix: Optional[str] = None,
    min_size: Optional[int] = None,
    retries: int = 2,
) -> Path:
    """The file `name` (the URL's last part by default) in `folder` (the
    download cache by default), fetched from `url` when it is not there.

    A file already in the cache is checked against `sha` where the index
    records one, else against the sha256 pinned in the folder's
    `.sha256.json` at its first use (trust on first use); a file with neither
    is hashed and pinned. `min_size` (a byte floor: a truncated transfer, an
    error page) and `sha_prefix` (the first hex digits of the sha256 that a
    torch-hub file name carries) are checked too. A file is verified once a
    process. A cached file that fails its sha is fetched again, and the fetch
    must match the sha or the pin: offline, that fetch fails, and the error
    names the path where the file goes. The same outcomes as the JAX
    package's `download` on the same files.
    """
    import urllib.request

    def weak_checks(p: Path, digest: Optional[str]) -> None:
        if min_size is not None and p.stat().st_size < min_size:
            raise IOError(
                f"{p.name} is {p.stat().st_size} bytes — smaller than the "
                f"recorded minimum {min_size} (truncated download?)"
            )
        if sha_prefix is not None and digest is not None and not digest.startswith(sha_prefix):
            raise IOError(
                f"sha mismatch for {p.name}: digest {digest[:16]}… does not "
                f"start with the filename-recorded prefix {sha_prefix}"
            )

    dst_folder = Path(folder) if folder is not None else get_download_cache_dir()
    dst_folder.mkdir(parents=True, exist_ok=True)
    fname = name or url.split("/")[-1]
    path = dst_folder / fname
    if path.is_file():
        verify_key = (str(path), sha, sha_prefix, min_size)
        if verify_key in _verified_downloads:
            return path
        pinned = sha or _tofu_get(dst_folder, fname)
        if pinned is None:
            digest = compute_sha(str(path))
            weak_checks(path, digest)
            _tofu_put(dst_folder, fname, digest)
            _verified_downloads.add(verify_key)
            return path
        if check_sha_with(str(path), pinned):
            weak_checks(path, pinned)
            _verified_downloads.add(verify_key)
            return path
        # a corrupted or replaced file: fetched again below
    err: Optional[Exception] = None
    pinned = sha or _tofu_get(dst_folder, fname)
    attempts = max(1, retries)
    for i in range(attempts):
        try:
            urllib.request.urlretrieve(url, str(path))
            got = compute_sha(str(path))
            if pinned is not None and got != pinned:
                raise IOError(f"sha mismatch for {fname}")
            weak_checks(path, got)
            _tofu_put(dst_folder, fname, got)
            return path
        except Exception as e:  # noqa: BLE001
            err = e
            if i + 1 < attempts:
                time.sleep(1)
    raise IOError(f"failed to download {url}: {err}; without a network, put the file at {path}")


def download_json(url: str, **kwargs: Any) -> Dict[str, Any]:
    with open(download(url, **kwargs), "r") as f:
        return json.load(f)


def download_checkpoint(tag: str, *, check_sha: bool = False) -> Path:
    """The checkpoint of the index entry `tag` from the cache (`download`),
    held to the entry's recorded sha when `check_sha`."""
    from ..zoo.common import resolve_download

    info = resolve_download(tag)
    return download(info["url"], name=info.get("name"), sha=info.get("sha") if check_sha else None)


# ---- seeds, batches, the JAX toolkit's helpers ----

tensor_dict_type = Dict[str, Union[torch.Tensor, Any]]
# the reference's type aliases: a parameter, and a loss (one tensor or a dict of them)
param_type = torch.Tensor
losses_type = Union[torch.Tensor, tensor_dict_type]


def get_seed() -> int:
    """The seed `seed_everything` last set, 0 before any."""
    return _seed if _seed is not None else 0


def new_generator(seed: Optional[int] = None, device: Any = None) -> torch.Generator:
    """A `torch.Generator` on `device` (default: the CPU) seeded with `seed`,
    by default `get_seed()`: the port's `new_rng_key`, a seeded stream a
    module draws from."""
    return torch.Generator(device=device or "cpu").manual_seed(get_seed() if seed is None else int(seed))


def np_batch_to_tensor(batch: np_dict_type, device: Any = "cpu") -> tensor_dict_type:
    """A numpy dict batch as tensors on `device`; object arrays and other
    values are kept (the port's `np_batch_to_jax`, carefree-learn's name).
    Dtypes are kept: `to_device_dtype` is the narrowing a device move does."""
    return {
        k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) and v.dtype != object else v
        for k, v in batch.items()
    }


def tensor_batch_to_np(batch: tensor_dict_type) -> np_dict_type:
    """A tensor dict batch as numpy arrays on the host (the port's
    `jax_batch_to_np`, carefree-learn's name)."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in batch.items()}


def to_device_dtype(x: np.ndarray) -> np.ndarray:
    """The dtype an array takes on the device (the port's `to_jax_dtype`):
    f64 becomes f32; integers keep theirs (PyTorch indexes with i64, where
    the JAX package narrows i64 to i32)."""
    return x.astype(np.float32) if x.dtype == np.float64 else x


def mean_std(x: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The spatial mean and std (population variance + eps) of each (sample,
    channel) of NHWC features."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return mean, torch.sqrt(var + eps)


def adain_with_params(src: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """`src` normalised per (sample, channel), then given `mean` and `std`."""
    src_mean, src_std = mean_std(src)
    return std * (src - src_mean) / src_std + mean


def adain_with_tgt(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """`src` given the spatial statistics of `tgt` (AdaIN)."""
    return adain_with_params(src, *mean_std(tgt))


class WeightsStrategy:
    """Sample-weight schedules over `num` samples by name: `linear_decay`,
    `radius_decay`, `log_decay`, `sigmoid_decay`; None gives None."""

    def __init__(self, strategy: Optional[str]) -> None:
        self.strategy = strategy

    def __call__(self, num: int) -> Optional[np.ndarray]:
        if self.strategy is None:
            return None
        return getattr(self, self.strategy)(num)

    def linear_decay(self, num: int) -> np.ndarray:
        return np.linspace(0, 1, num + 1)[1:]

    def radius_decay(self, num: int) -> np.ndarray:
        return np.sin(np.arccos(1.0 - np.linspace(0, 1, num + 1)[1:]))

    def log_decay(self, num: int) -> np.ndarray:
        return np.log(np.arange(num) + np.e)

    def sigmoid_decay(self, num: int) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-np.linspace(-5.0, 5.0, num)))


class ScalarEMA:
    """A host-side exponential moving average of scalars: the first value as
    it is, then decay * average + (1 - decay) * value."""

    def __init__(self, decay: float = 0.9) -> None:
        self.decay = decay
        self._value: Optional[float] = None

    def update(self, value: float) -> float:
        if self._value is None:
            self._value = value
        else:
            self._value = self.decay * self._value + (1.0 - self.decay) * value
        return self._value

    @property
    def value(self) -> Optional[float]:
        return self._value


def fix_denormal_states(states: Dict[str, Any], *, eps: float = 1e-32) -> Dict[str, Any]:
    """A state dict with the floating values below `eps` in magnitude set to
    0 (numpy arrays or tensors, dtypes kept)."""
    out = {}
    for k, v in states.items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            v = torch.where(v.abs() < eps, torch.zeros_like(v), v)
        elif isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.floating):
            v = np.where(np.abs(v) < eps, 0.0, v).astype(v.dtype)
        out[k] = v
    return out


def prod(iterable: Any) -> int:
    out = 1
    for v in iterable:
        out *= int(v)
    return out


def get_num_params(params: Any) -> int:
    """The number of values in a module's parameters, or in the tensors of a
    dict or sequence."""
    if isinstance(params, torch.nn.Module):
        params = list(params.parameters())
    elif isinstance(params, dict):
        params = list(params.values())
    return sum(int(np.prod(p.shape)) for p in params if hasattr(p, "shape"))


def get_latest_workspace(root: Union[str, Path]) -> Optional[Path]:
    """The most recently modified run folder under a workspace root, None
    when it has none."""
    root = Path(root)
    if not root.is_dir():
        return None
    candidates = [p for p in root.iterdir() if p.is_dir()]
    return max(candidates, key=lambda p: p.stat().st_mtime) if candidates else None


def hash_code(code: str) -> str:
    """The first 8 hex digits of `code`'s md5."""
    return hashlib.md5(code.encode()).hexdigest()[:8]


class FileInfo(tuple):
    """(sha256, st_size) of a file."""

    def __new__(cls, sha: str, st_size: int) -> "FileInfo":
        return super().__new__(cls, (sha, st_size))

    @property
    def sha(self) -> str:
        return self[0]

    @property
    def st_size(self) -> int:
        return self[1]


def get_file_info(path: Union[str, Path]) -> FileInfo:
    """The sha256 and the size of a file."""
    return FileInfo(compute_sha(str(path)), os.path.getsize(path))


def show_or_return(return_canvas: bool) -> Optional[np.ndarray]:
    """Show matplotlib's current figure, or return it as an RGBA array
    (needs matplotlib, and PIL for the array)."""
    import matplotlib.pyplot as plt

    if not return_canvas:
        plt.show()
        return None
    import io

    from PIL import Image

    buf = io.BytesIO()
    plt.savefig(buf, format="png")
    plt.close()
    buf.seek(0)
    return np.array(Image.open(buf))


def to_2d(arr: Any) -> Any:
    """Array-likes as 2-D columns: a flat list becomes a list of one-item
    lists, a 1-D array (numpy or tensor) a column; None and strings give None;
    anything else is returned as it is."""
    if arr is None or isinstance(arr, str):
        return None
    if isinstance(arr, (list, tuple)) and arr and not isinstance(arr[0], (list, tuple)):
        return [[x] for x in arr]
    a = arr if isinstance(arr, (np.ndarray, torch.Tensor)) else np.asarray(arr)
    if a.ndim == 1:
        return a.reshape(-1, 1)
    return arr if isinstance(arr, (list, tuple)) else a


def inject_parameters(
    src: torch.nn.Module,
    tgt: torch.nn.Module,
    *,
    strict: bool = True,
    src_filter_fn: Optional[Callable[[str], bool]] = None,
    tgt_filter_fn: Optional[Callable[[str], bool]] = None,
    custom_mappings: Optional[Dict[str, str]] = None,
    states_callback: Optional[Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]] = None,
) -> None:
    """Copy `src`'s parameters into `tgt` by name (`named_parameters`),
    filtered by name on either side, renamed by `custom_mappings` and then
    passed through `states_callback`. With `strict` (and no target filter)
    every parameter of `tgt` must be filled and every given one used."""
    states = {k: v.detach() for k, v in src.named_parameters()}
    if src_filter_fn is not None:
        states = {k: v for k, v in states.items() if src_filter_fn(k)}
    if custom_mappings:
        states = {custom_mappings.get(k, k): v for k, v in states.items()}
    if states_callback is not None:
        states = states_callback(states)
    targets = dict(tgt.named_parameters())
    if tgt_filter_fn is not None:
        targets = {k: v for k, v in targets.items() if tgt_filter_fn(k)}
        states = {k: v for k, v in states.items() if k in targets}
    if strict and tgt_filter_fn is None:
        missing, unused = sorted(set(targets) - set(states)), sorted(set(states) - set(targets))
        if missing or unused:
            raise KeyError(f"inject_parameters: target parameters not filled {missing[:8]}, given ones unused "
                           f"{unused[:8]}")
    with torch.no_grad():
        for k, v in states.items():
            if k in targets:
                targets[k].copy_(v)


def has_batch_norms(module: torch.nn.Module) -> bool:
    """Whether any submodule is a batch norm."""
    return any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm) for m in module.modules())


def get_tensors(inp: Any) -> Dict[str, np.ndarray]:
    """A checkpoint as a flat {name: ndarray}: a path (`.safetensors`, `.pt`,
    `.ckpt`, `.pth`), a state dict, or a dict holding one under
    "state_dict"."""
    if isinstance(inp, (str, Path)):
        from ..zoo.convert import load_torch_state_dict

        return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
                for k, v in load_torch_state_dict(str(inp)).items()}
    if isinstance(inp, dict):
        d = inp.get("state_dict", inp)
        return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in d.items()}
    raise ValueError(f"cannot extract tensors from `{type(inp)}`")


class Diffs(tuple):
    """(names, diffs) of `sorted_param_diffs`."""

    def __new__(cls, names: List[str], diffs: List[float]) -> "Diffs":
        return super().__new__(cls, (names, diffs))

    @property
    def names(self) -> List[str]:
        return self[0]

    @property
    def diffs(self) -> List[float]:
        return self[1]


def sorted_param_diffs(m1: torch.nn.Module, m2: torch.nn.Module) -> Diffs:
    """The largest absolute difference of each parameter between two modules
    of the same structure, largest first."""
    d1, d2 = dict(m1.named_parameters()), dict(m2.named_parameters())
    if d1.keys() != d2.keys():
        raise ValueError("parameter structures differ")
    pairs = sorted(((k, (d1[k].detach().float() - d2[k].detach().float()).abs().max().item()) for k in d1),
                   key=lambda kv: -kv[1])
    return Diffs([k for k, _ in pairs], [v for _, v in pairs])
