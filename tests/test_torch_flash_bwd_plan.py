"""The planner of the flash-attention backward kernels (`cflearn_torch/ops/attention.py`: `flash_bwd_plan`) and
the tile schedule its kernels follow, on the CPU: the kernels run only on the card (`tests/test_torch_cuda.py`),
but which kernel runs, which rows each CTA owns, which tiles its loop walks, the TMA boxes and the shared memory
are decided here, in Python.

* the UNet's shapes take the wgmma + TMA kernels, but for the fused and dk.dv kernels at d = 160, whose dK and
  dV do not fit a consumer's registers; f32, d = 512, d = 640 and `kernel="mma_sync"` take the mma.sync kernel,
  and `kernel="sm90"` raises where the wgmma kernels cannot take the shape;
* shared memory fits a block, every TMA box obeys TMA's limits, the boxes cover the head dim and the register
  tiles the design counts on fit the consumers;
* the outer tiles cover each row once, and the inner tiles each CTA walks cover every (q, kv) pair the function
  needs, causal skips included;
* the kv-outer and q-outer loops, emulated in plain PyTorch with the planned tiles and schedule, compute
  `flash_bwd_plain`'s gradients; with one planted skipped tile they do not."""

import math

import numpy as np
import pytest
import torch

from cflearn_torch.ops import attention as A

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
# (B, H, Lq, Lk, D, dtype): `chip_smoke.py`'s TRAIN_CASES (the UNet's three finetune shapes, ragged, causal,
# f32, d640, ae_mid), the UNet's shapes at the card tests' batch 2, head dims at the sm90 kernels' limits, and
# d = 96 / 128 on a grid that fills the SMs, where the fused kernel's two consumers would not fit
SHAPES = [
    (8, 8, 4096, 4096, 40, BF16), (8, 8, 1024, 1024, 80, BF16), (8, 8, 256, 256, 160, BF16),
    (1, 4, 1000, 777, 64, BF16), (1, 4, 1000, 1000, 64, BF16), (1, 4, 1000, 777, 64, F32),
    (1, 2, 512, 512, 640, BF16), (8, 1, 1024, 1024, 512, BF16),
    (2, 8, 4096, 4096, 40, BF16), (2, 8, 1024, 1024, 80, F16), (2, 8, 256, 256, 160, BF16),
    (1, 2, 300, 777, 40, BF16), (1, 2, 256, 256, 128, F16), (1, 2, 256, 256, 136, BF16), (1, 2, 200, 330, 192, BF16),
    (1, 2, 200, 330, 200, BF16), (1, 1, 200, 330, 8, BF16), (2, 8, 1024, 1024, 96, BF16),
    (2, 8, 1024, 1024, 128, BF16),
]
SMS = [132, 114]  # an H100 SXM's SMs, and a PCIe card's
SM90_MAX_REGS = 240  # what `setmaxnreg` gives each consumer thread of two consumer warpgroups


def _ids(shape):
    return "x".join(map(str, shape[:5])) + "_" + str(shape[5]).split(".")[-1]


def _cdiv(a, b):
    return -(-a // b)


def _tiles(plan, lq, lk, causal):
    """The tile schedule of a backward kernel of `plan` (`csrc/flash_bwd_sm90.cuh` and `flash_bwd.cuh`): (outer
    tile, the inner tiles its CTA walks, in order) for every outer tile, as the kernels' loops bound them. kv
    outer: every q tile, or with `causal` those from the kv tile's first row on; dq: every kv block, or with
    `causal` those up to the q tile's last row."""
    tiles = []
    for i in range(_cdiv(lq if plan.mode == "dq" else lk, plan.outer)):
        first = i * plan.outer
        if plan.mode == "dq":
            n = _cdiv(lk, plan.inner)
            if causal:
                n = min(n, (first + plan.outer - 1) // plan.inner + 1)
            tiles.append((i, list(range(n))))
        else:
            tiles.append((i, list(range(first // plan.inner if causal else 0, _cdiv(lq, plan.inner)))))
    return tiles


def _sm90_takes(d, dtype, mode) -> bool:
    return dtype in (BF16, F16) and d % 8 == 0 and d <= (192 if mode == "dq" else 128)


@pytest.mark.parametrize("mode", A.BWD_MODES)
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plan_boxes_shared_memory_and_registers_fit(shape, sms, mode) -> None:
    b, h, lq, lk, d, dtype = shape
    plan = A.flash_bwd_plan(b, h, lq, lk, d, dtype, sms, mode=mode)
    assert plan.mode == mode and 0 < plan.smem <= A.SMEM_MAX
    assert plan.kernel == ("sm90" if _sm90_takes(d, dtype, mode) else "mma_sync")
    outer_len = lq if mode == "dq" else lk
    if plan.kernel == "mma_sync":
        assert (plan.outer, plan.inner, plan.consumers, plan.ksteps, plan.boxes) == (64, 64, 0, 0, ())
        assert plan.ctas == _cdiv(outer_len, 64) * _cdiv(d, plan.head_pad) * b * h
        return
    assert plan.ctas == _cdiv(outer_len, plan.outer) * b * h
    # TMA boxes (columns, rows) of the outer and the inner tiles: 64 columns of 16-bit values, the swizzle's row
    assert plan.boxes == ((A.BOX_COLS, plan.outer), (A.BOX_COLS, plan.inner))
    for box in plan.boxes:
        assert all(1 <= e <= A.TMA_BOX_MAX for e in box)
        assert box[0] * 2 <= plan.swizzle == A.SWIZZLE_BYTES
    # S and dP in whole steps of 16 that cover d, inside boxes that cover d
    slabs = plan.head_pad // A.BOX_COLS
    assert plan.ksteps in A.SM90_BWD_KSTEPS[mode] and d <= 16 * plan.ksteps <= A.BOX_COLS * slabs
    assert plan.head_pad == A.BOX_COLS * _cdiv(16 * plan.ksteps, A.BOX_COLS)
    assert plan.outer == 64 * plan.consumers and plan.consumers in (1, 2)
    # two consumers exactly where the grid of 128-row CTAs keeps the SMs busy and their tiles fit at two stages
    two_fit = A._bwd_sm90_smem(mode, slabs, plan.ksteps, 128, plan.inner, 2) <= A.SMEM_MAX
    assert (plan.consumers == 2) == (2 * _cdiv(outer_len, 128) * b * h > sms and two_fit)
    assert 2 <= plan.stages <= A.SM90_MAX_STAGES
    if mode == "dq":
        assert plan.inner == (128 if slabs == 1 else 64)
        # a consumer thread holds dQ (32 f32 a box), S and dP (inner / 2 f32 each) and dS packed (inner / 4)
        regs = 32 * slabs + plan.inner + plan.inner // 4
    else:
        assert plan.inner == A.BWD_Q_TILE == 64
        # dK and dV (32 f32 a box each), S^T and dP^T (32 each); P^T and dS^T packed (16 each) once dP^T is done
        regs = 2 * 32 * slabs + 64
    assert regs <= SM90_MAX_REGS - 32  # room for addresses, indices and the row statistics
    # a stage more would not fit, unless the ring is at its most
    if plan.stages < A.SM90_MAX_STAGES:
        assert A._bwd_sm90_smem(mode, slabs, plan.ksteps, plan.outer, plan.inner, plan.stages + 1) > A.SMEM_MAX


@pytest.mark.parametrize("mode", A.BWD_MODES)
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_tiles_cover_every_row_once_and_every_needed_pair(shape, causal, sms, mode) -> None:
    b, h, lq, lk, d, dtype = shape
    plan = A.flash_bwd_plan(b, h, lq, lk, d, dtype, sms, mode=mode)
    tiles = _tiles(plan, lq, lk, causal)
    outer_len, inner_len = (lq, lk) if mode == "dq" else (lk, lq)
    seen = np.zeros(outer_len, dtype=np.int64)
    for i, inner in tiles:
        seen[i * plan.outer:(i + 1) * plan.outer] += 1
        assert inner == sorted(set(inner))  # a fixed order, each tile once
        assert all(0 <= j and j * plan.inner < inner_len for j in inner)  # no tile lies wholly past the rows
        covered = np.zeros(inner_len, dtype=bool)
        for j in inner:
            covered[j * plan.inner:(j + 1) * plan.inner] = True
        rows = np.arange(i * plan.outer, min((i + 1) * plan.outer, outer_len))
        # the inner rows that some outer row of this tile pairs with: all, or with `causal` kv <= q
        if not causal:
            needed = np.ones(inner_len, dtype=bool)
        elif mode == "dq":
            needed = np.arange(inner_len) <= rows.max()
        else:
            needed = np.arange(inner_len) >= rows.min()
        assert covered[needed].all()
    assert np.all(seen == 1)


@pytest.mark.parametrize(
    "shape,dtype,mode,want",
    [((8, 8, 256, 256, 160), BF16, "fused", "mma_sync"), ((8, 8, 256, 256, 160), BF16, "dkv", "mma_sync"),
     ((8, 8, 256, 256, 160), BF16, "dq", "sm90"), ((8, 1, 1024, 1024, 512), BF16, "dq", "mma_sync"),
     ((1, 2, 512, 512, 640), F16, "fused", "mma_sync"), ((1, 4, 1000, 777, 64), F32, "dkv", "mma_sync"),
     ((8, 8, 4096, 4096, 40), BF16, "fused", "sm90"), ((1, 2, 200, 330, 200), BF16, "dq", "mma_sync")],
)
def test_plan_routes_what_the_sm90_kernels_do_not_take(shape, dtype, mode, want) -> None:
    assert A.flash_bwd_plan(*shape, dtype, mode=mode).kernel == want
    assert A.flash_bwd_plan(*shape, dtype, mode=mode, kernel="mma_sync").kernel == "mma_sync"
    if want == "mma_sync":
        with pytest.raises(ValueError):
            A.flash_bwd_plan(*shape, dtype, mode=mode, kernel="sm90")
    else:
        assert A.flash_bwd_plan(*shape, dtype, mode=mode, kernel="sm90") == A.flash_bwd_plan(*shape, dtype, mode=mode)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("mode", A.BWD_MODES)
def test_unet_finetune_shapes_plan_two_consumers(mode, sms) -> None:
    """At the finetune's batch 8 every grid of 128-row CTAs keeps the SMs busy: two consumer warpgroups."""
    for lq, d in ((4096, 40), (1024, 80), (256, 160)):
        plan = A.flash_bwd_plan(8, 8, lq, lq, d, BF16, sms, mode=mode)
        if plan.kernel == "sm90":
            assert plan.consumers == 2
        else:
            assert d == 160 and mode != "dq"


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("d", [96, 128])
def test_fused_plan_takes_one_consumer_where_two_do_not_fit(d, sms) -> None:
    """Two consumers' f32 dq tiles do not fit past d = 80: the fused kernel takes one, the split pair two."""
    fused = A.flash_bwd_plan(2, 8, 1024, 1024, d, BF16, sms, mode="fused")
    assert (fused.kernel, fused.consumers, fused.outer) == ("sm90", 1, 64) and fused.smem <= A.SMEM_MAX
    for mode in ("dq", "dkv"):
        assert A.flash_bwd_plan(2, 8, 1024, 1024, d, BF16, sms, mode=mode).consumers == 2


def test_plan_refuses_an_unknown_kernel_or_mode() -> None:
    with pytest.raises(ValueError):
        A.flash_bwd_plan(2, 8, 1024, 1024, 40, BF16, kernel="triton")
    with pytest.raises(ValueError):
        A.flash_bwd_plan(2, 8, 1024, 1024, 40, BF16, mode="dk")


def _emulate(plan, q, k, v, o, lse, do, causal, drop=None):
    """The kernels' loops in plain f32 PyTorch: every outer tile of `plan` walks its inner tiles in the order
    `_tiles` gives, recomputing p, dp and ds per pair; (outer, inner) `drop` is skipped."""
    lq, lk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    delta = (do * o).sum(-1)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for i, inner in _tiles(plan, lq, lk, causal):
        for j in inner:
            if (i, j) == drop:
                continue
            if plan.mode == "dq":
                q0, k0, qn, kn = i * plan.outer, j * plan.inner, plan.outer, plan.inner
            else:
                q0, k0, qn, kn = j * plan.inner, i * plan.outer, plan.inner, plan.outer
            qs, ks = slice(q0, q0 + qn), slice(k0, k0 + kn)
            p = torch.exp(q[:, :, qs] @ k[:, :, ks].transpose(-1, -2) * scale - lse[:, :, qs, None])
            if causal:
                qpos = torch.arange(q0, min(q0 + qn, lq))[:, None]
                kpos = torch.arange(k0, min(k0 + kn, lk))[None, :]
                p = torch.where(kpos <= qpos, p, torch.zeros_like(p))
            ds = p * (do[:, :, qs] @ v[:, :, ks].transpose(-1, -2) - delta[:, :, qs, None])
            if plan.mode != "dq":
                dv[:, :, ks] += p.transpose(-1, -2) @ do[:, :, qs]
                dk[:, :, ks] += scale * ds.transpose(-1, -2) @ q[:, :, qs]
            if plan.mode != "dkv":
                dq[:, :, qs] += scale * ds @ k[:, :, ks]
    return {"fused": (dq, dk, dv), "dq": (dq,), "dkv": (dk, dv)}[plan.mode]


def _inputs(lq, lk, d, causal, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 2, n, d)).astype(np.float32)) for n in (lq, lk, lk, lq))
    o, lse = A.flash_fwd_with_lse_plain(q, k, v, causal=causal)
    return q, k, v, o, lse, do


# tiny shapes with ragged tails; sms = 1 makes the planner take two consumers (128 outer rows)
EMULATED = [(300, 200, 40, 1), (300, 200, 40, 132), (130, 333, 80, 1), (200, 200, 160, 1)]


@pytest.mark.parametrize("mode", A.BWD_MODES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", EMULATED, ids=lambda c: "x".join(map(str, c)))
def test_emulated_tile_loops_equal_the_plain_backward(case, causal, mode) -> None:
    lq, lk, d, sms = case
    if causal and lq != lk:
        lk = lq
    q, k, v, o, lse, do = _inputs(lq, lk, d, causal)
    plan = A.flash_bwd_plan(1, 2, lq, lk, d, BF16, sms, mode=mode)
    want = A.flash_bwd_plain(q, k, v, o, lse, do, causal=causal)
    want = {"fused": want, "dq": want[:1], "dkv": want[1:]}[mode]
    for got, ref in zip(_emulate(plan, q, k, v, o, lse, do, causal), want):
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("mode", A.BWD_MODES)
@pytest.mark.parametrize("causal", [False, True])
def test_a_planted_skipped_tile_fails(causal, mode) -> None:
    lq = lk = 300
    q, k, v, o, lse, do = _inputs(lq, lk, 40, causal, seed=1)
    plan = A.flash_bwd_plan(1, 2, lq, lk, 40, BF16, 1, mode=mode)
    tiles = _tiles(plan, lq, lk, causal)
    i, inner = tiles[len(tiles) // 2]
    drop = (i, inner[len(inner) // 2])
    want = A.flash_bwd_plain(q, k, v, o, lse, do, causal=causal)
    want = {"fused": want, "dq": want[:1], "dkv": want[1:]}[mode]
    got = _emulate(plan, q, k, v, o, lse, do, causal, drop=drop)
    errs = [(g - r).abs().max().item() / r.abs().max().item() for g, r in zip(got, want)]
    assert max(errs) > 2.0**-6  # beyond the card's limit (`flash_rel`) for every kernel
