"""Ops layer of the port: attention and 3x3-conv dispatchers with their
hand-written CUDA kernels, and GroupNorm. `launch_counts()` reads every
kernel wrapper's launch counter. `flash_attention`, `sdp_attn` and
`xla_attention` are the JAX package's names here; its `group_norm` function
is `group_norm.group_norm_silu`: the name `group_norm` stays the module's."""

from typing import Dict

from .attention import flash_attention, sdp_attn, xla_attention


def launch_counts() -> Dict[str, int]:
    """{kernel: launches so far} of every kernel wrapper (the counters that
    the wrappers, or their operations' CUDA implementations, bump once a
    launch)."""
    from . import attention, conv, group_norm

    counters = dict(attention._WRAPPERS)
    counters.update(conv3x3=conv._WRAPPER, conv3x3_fold=conv._FOLD_WRAPPER, conv3x3_wgrad=conv._WGRAD_WRAPPER,
                    conv3x3_w8a8=conv._W8A8_WRAPPER, quantize_w8a8=conv._QUANT_WRAPPER,
                    group_norm=group_norm._WRAPPER)
    return {name: fn.launches for name, fn in counters.items()}
