"""ToMe: token merging for the SD transformer blocks (counterpart of
`cflearn_tpu/modules/core/tome.py`).

Merge similar tokens before the self-attention and unmerge after, cutting
the attention's length by the merged share at the highest resolution. As in
the JAX package, the dst anchor of each sy x sx cell is its top-left token
(no random offset) and the number of merged tokens r is a static function of
N and `ratio`.

The dst / src index sets depend only on (h, w): they are built on the host
with numpy and cached per (h, w, sx, sy, device), so no `nonzero` on a CUDA
tensor synchronises the host. The src tokens are ranked by a stable
descending sort, which puts the lower index first among equal scores as
`jax.lax.top_k` does; `argmax` takes the first maximum in both frameworks.
`match_tokens` makes the matching; `bipartite_soft_matching_random2d` builds
the merge and unmerge from it.
"""

import math
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

_INDEX_CACHE: Dict[Tuple[int, int, int, int, str], Tuple[torch.Tensor, torch.Tensor]] = {}


def dst_src_indices(h: int, w: int, sx: int, sy: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dst, src) token indices of an h x w grid: dst = the top-left token of
    each sy x sx cell (a partial cell at the edge still has one), src = the
    rest, both ascending."""
    key = (h, w, sx, sy, str(device))
    found = _INDEX_CACHE.get(key)
    if found is None:
        is_dst = ((np.arange(h)[:, None] % sy) == 0) & ((np.arange(w)[None, :] % sx) == 0)
        is_dst = is_dst.reshape(-1)
        assert int(is_dst.sum()) == math.ceil(h / sy) * math.ceil(w / sx)
        found = (
            torch.as_tensor(np.nonzero(is_dst)[0], dtype=torch.long, device=device),
            torch.as_tensor(np.nonzero(~is_dst)[0], dtype=torch.long, device=device),
        )
        _INDEX_CACHE[key] = found
    return found


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, i], :] for a (B, K) index."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


class Matching(NamedTuple):
    """One bipartite matching: each src token's most similar dst token
    (`best_dst`, (B, num_src)), the src tokens in descending order of that
    similarity (`merge_order`, positions into the src indices), the number
    merged (`r`: the first r of the order) and the scores, (B, num_src,
    num_dst)."""

    best_dst: torch.Tensor
    merge_order: torch.Tensor
    r: int
    scores: torch.Tensor


def match_tokens(metric: torch.Tensor, h: int, w: int, *, ratio: float = 0.5, sx: int = 2, sy: int = 2) -> Matching:
    """The matching of `bipartite_soft_matching_random2d`: cosine scores of
    every src token against every dst token, each src's argmax (the first
    maximum) and the src tokens ranked by their best score, lower index first
    among ties."""
    n = metric.shape[1]
    assert n == h * w
    dst_idx, src_idx = dst_src_indices(h, w, sx, sy, metric.device)
    r = min(src_idx.numel(), int(n * ratio))
    metric_n = metric / (torch.linalg.vector_norm(metric, dim=-1, keepdim=True) + 1e-6)
    scores = metric_n[:, src_idx] @ metric_n[:, dst_idx].transpose(1, 2)  # (B, num_src, num_dst)
    best_score = scores.amax(dim=-1)
    merge_order = torch.sort(best_score, dim=-1, descending=True, stable=True).indices
    return Matching(scores.argmax(dim=-1), merge_order, r, scores)


def bipartite_soft_matching_random2d(
    metric: torch.Tensor,
    h: int,
    w: int,
    *,
    ratio: float = 0.5,
    sx: int = 2,
    sy: int = 2,
) -> Tuple[Callable[[torch.Tensor], torch.Tensor], Callable[[torch.Tensor], torch.Tensor], int]:
    """Build (merge, unmerge) for (B, N, C) token tensors from the (B, N, C)
    similarity `metric` (`match_tokens`). Returns (merge_fn, unmerge_fn,
    num_remaining)."""
    n = metric.shape[1]
    dst_idx, src_idx = dst_src_indices(h, w, sx, sy, metric.device)
    num_dst = dst_idx.numel()
    best_dst, merge_order, r, _ = match_tokens(metric, h, w, ratio=ratio, sx=sx, sy=sy)
    merged_src_pos = merge_order[:, :r]  # positions into src_idx
    kept_src_pos = merge_order[:, r:]
    merged_tgt = torch.gather(best_dst, 1, merged_src_pos)  # (B, r)
    # the merge targets one-hot: the feature scatter becomes a batched matmul
    tgt_onehot = merged_tgt[..., None] == torch.arange(num_dst, device=metric.device)  # (B, r, num_dst)

    def merge(x: torch.Tensor) -> torch.Tensor:
        x_src = x[:, src_idx]
        x_dst = x[:, dst_idx]
        merged_vals = _rows(x_src, merged_src_pos)  # (B, r, C)
        oh = tgt_onehot.to(x.dtype)
        sums = x_dst + oh.transpose(1, 2) @ merged_vals
        counts = 1.0 + oh.sum(dim=1)[..., None]  # (B, num_dst, 1)
        return torch.cat([sums / counts, _rows(x_src, kept_src_pos)], dim=1)

    def unmerge(x: torch.Tensor) -> torch.Tensor:
        # every output token reads one row of the merged tensor
        bsz = x.shape[0]
        kept_global = src_idx[kept_src_pos]  # (B, num_src - r)
        merged_global = src_idx[merged_src_pos]  # (B, r)
        inv = torch.zeros((bsz, n), dtype=torch.long, device=x.device)
        inv[:, dst_idx] = torch.arange(num_dst, device=x.device)
        kept_rows = num_dst + torch.arange(kept_global.shape[1], device=x.device)
        inv.scatter_(1, kept_global, kept_rows.expand(bsz, -1))
        inv.scatter_(1, merged_global, merged_tgt)
        return _rows(x, inv)

    return merge, unmerge, n - r


def compute_merge(
    x: torch.Tensor, h: int, w: int, *, ratio: float = 0.5, min_tokens: int = 2048
) -> Tuple[Callable, Callable, bool]:
    """Merge only where the token count pays for it: at least `min_tokens`
    (2048, tomesd's max_downsample=1: only SD's 64x64 level merges)."""
    n = x.shape[1]
    if n < min_tokens or ratio <= 0.0:
        return (lambda t: t), (lambda t: t), False
    merge, unmerge, _ = bipartite_soft_matching_random2d(x, h, w, ratio=ratio)
    return merge, unmerge, True
