"""Build and load the hand-written CUDA kernels.

Each source under `cflearn_torch/csrc/` is compiled by `nvcc` for `sm_90a`
into a shared library with a plain C interface and loaded with `ctypes`.
Libraries are built at first use into `cflearn_torch/_build/` (ignored by
git), named by a hash of the sources and flags so that an edited source is
rebuilt. `build()` starts one `nvcc` per source, all at once.

Nothing here runs at import: the CPU tests import every module, and there is
no `nvcc` there.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {
    "flash_attention": "flash_attention.cu",
    "conv3x3": "conv3x3.cu",
    "flash_fwd_lse": "flash_fwd_lse.cu",
    "flash_bwd_fused": "flash_bwd_fused.cu",
    "flash_bwd_dq": "flash_bwd_dq.cu",
    "flash_bwd_dkv": "flash_bwd_dkv.cu",
    "conv3x3_wgrad": "conv3x3_wgrad.cu",
    "group_norm": "group_norm.cu",
    "conv3x3_w8a8": "conv3x3_w8a8.cu",
    "conv3x3_fold": "conv3x3_fold.cu",
    "quantize_w8a8": "quantize_w8a8.cu",
}
_HEADERS = (
    "mma_common.cuh", "flash_fwd.cuh", "flash_bwd.cuh", "conv3x3_igemm.cuh", "sm90.cuh", "flash_fwd_sm90.cuh",
    "flash_fwd_sm90_wide.cuh", "flash_bwd_sm90.cuh", "host.cuh",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# forward: dtype, q, k, v, o, lse, 12 strides, batch, heads, q_len, kv_len, d, causal, scale, then the
# planner's kernel (0 = mma.sync, 1 = wgmma + TMA, 2 = the wide-head wgmma + TMA), q rows a CTA, kv rows a
# block, ring stages, K steps of 16 over the head dim, kv splits, the splits' f32 workspace, and stream
_FWD = [_I] + [_P] * 5 + [_L] * 12 + [_I] * 6 + [ctypes.c_float] + [_I] * 6 + [_P] * 2
# backward: dtype, q, k, v, dO, lse, delta, dq, dk, dv, 12 strides, batch, heads, q_len, kv_len, d, causal,
# scale, then the planner's kernel (0 = mma.sync, 1 = wgmma + TMA), outer rows a CTA, inner rows a tile, ring
# stages, K steps of 16 over the head dim, and stream
_BWD = [_I] + [_P] * 9 + [_L] * 12 + [_I] * 6 + [ctypes.c_float] + [_I] * 5 + [_P]
_SIGNATURES = {
    "flash_attention": ("cflearn_flash_attention_fwd", _FWD),
    # dtype, x, w, bias, y, B, H, W, C, Co, box rows, box columns, output channels per tile, CTAs, stream
    "conv3x3": ("cflearn_conv3x3_fwd", [_I, _P, _P, _P, _P] + [_I] * 9 + [_P]),
    "flash_fwd_lse": ("cflearn_flash_fwd_lse", _FWD),
    "flash_bwd_fused": ("cflearn_flash_bwd_fused", _BWD),
    "flash_bwd_dq": ("cflearn_flash_bwd_dq", _BWD),
    "flash_bwd_dkv": ("cflearn_flash_bwd_dkv", _BWD),
    # dtype, x, dy, workspace, out, B, H, W, C, Co, splits, stream
    "conv3x3_wgrad": ("cflearn_conv3x3_wgrad", [_I, _P, _P, _P, _P] + [_I] * 6 + [_P]),
    # x dtype, parameter dtype, x, w, bias, y, slab sums, B, S, C, G, eps, silu, then the planner's slabs per
    # sample, rows per slab, rows kept in shared memory, samples per wave, CTAs, and stream
    "group_norm": (
        "cflearn_group_norm",
        [_I, _I] + [_P] * 5 + [_I, _L, _I, _I, ctypes.c_float, _I, _I, _L, _L, _I, _I, _P],
    ),
    # the three-launch yardstick: x dtype, parameter dtype, x, w, bias, y, partial sums, stats, B, S, C, G, eps,
    # silu, slabs, rows per slab, stream
    "group_norm_slabs": (
        "cflearn_group_norm_slabs",
        [_I, _I] + [_P] * 6 + [_I, _L, _I, _I, ctypes.c_float, _I, _I, _L, _P],
    ),
    # output dtype, x (int8), w (int8), scale (f32), bias, y, B, H, W, C, Co, box rows, box columns, CTAs, stream
    "conv3x3_w8a8": ("cflearn_conv3x3_w8a8", [_I] + [_P] * 5 + [_I] * 8 + [_P]),
    # the mma.sync yardstick: output dtype, x, w, scale, bias, y, B, H, W, C, Co, stream
    "conv3x3_w8a8_mma_sync": ("cflearn_conv3x3_w8a8_mma_sync", [_I] + [_P] * 5 + [_I] * 5 + [_P]),
    # dtype, x, w, x8, w8, scale, per-CTA maxima, 16-byte chunks of x, Co, chunks of a weight row, CTAs, stream
    "quantize_w8a8": ("cflearn_quantize_w8a8", [_I] + [_P] * 6 + [_L, _I, _I, _I, _P]),
    # dtype, x, w, bias, y, B, H, W, C, Co, box rows, box columns, output channels per tile, CTAs, stream
    "conv3x3_fold": ("cflearn_conv3x3_fold_fwd", [_I, _P, _P, _P, _P] + [_I] * 9 + [_P]),
    # the mma.sync yardstick: dtype, x, w, bias, y, B, H, W, C, Co, stream
    "conv3x3_fold_mma_sync": ("cflearn_conv3x3_fold_mma_sync", [_I, _P, _P, _P, _P] + [_I] * 5 + [_P]),
}
# entry points that live in another entry's library (one library per TPU kernel)
_LIBRARY_OF = {
    "group_norm_slabs": "group_norm",
    "conv3x3_fold_mma_sync": "conv3x3_fold",
    "conv3x3_w8a8_mma_sync": "conv3x3_w8a8",
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for fname in (SOURCES[name],) + _HEADERS:
        h.update((CSRC / fname).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    `nvcc` process per source, all started together. Returns the seconds
    each build took (0.0 for a library already on disk)."""
    names = list(names or SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds: Dict[str, float] = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log[-4000:]}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str):
    """The C entry point `name` (a kernel, or another entry of a kernel's
    library), its library built on first use, with its argument types
    declared."""
    lib_name = _LIBRARY_OF.get(name, name)
    with _lock:
        lib = _loaded.get(lib_name)
        if lib is None:
            path = library_path(lib_name)
            if not path.exists():
                build([lib_name])
            lib = ctypes.CDLL(str(path))
            _loaded[lib_name] = lib
    symbol, argtypes = _SIGNATURES[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """One more launch on `wrapper.launches`, under a lock: threads that
    launch at once lose no count."""
    with _count_lock:
        wrapper.launches += 1


def error_text(name: str, err: int) -> str:
    """What error `err`, returned on this thread by entry point `name`, was:
    the driver's CUresult for a failed driver call, else the runtime's name
    and description (`csrc/host.cuh` `cflearn_error_text`)."""
    fn = _loaded[_LIBRARY_OF.get(name, name)].cflearn_error_text
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode(errors="replace")


def check(err: int, name: str, detail: Optional[str] = None) -> None:
    """Raise if entry point `name` returned error `err`, with its text;
    `detail` (the kernel the plan chose) goes beside the name."""
    if err != 0:
        what = name if detail is None else f"{name} ({detail})"
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}: {error_text(name, err)}")
