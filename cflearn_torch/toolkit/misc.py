"""Small helpers (counterpart of part of `cflearn_tpu/toolkit/misc.py`):
`slerp`, the `jax.checkpoint_policies` names as selective-checkpoint
policies (`resolve_checkpoint_policy`, `checkpoint_context_fn`), and the
framework's `check_is_ci`, `timestamp`, `sort_dict_by_value` and
`truncate_string_to_length`; and the download cache (`download`,
`download_json`, `download_checkpoint`, `compute_sha`, `check_sha_with`,
`get_download_cache_dir`)."""

import functools
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..parameters import OPT

np_dict_type = Dict[str, Union[np.ndarray, Any]]


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
