"""The planner of the flash-attention forward kernels (`cflearn_torch/ops/attention.py`: `flash_plan`), on the
CPU: the kernels themselves run only on the card (`tests/test_torch_cuda.py`), but which kernel runs, which q
rows and kv blocks each CTA takes, the TMA boxes and the shared memory are decided here, in Python.

* every q row lies in exactly one tile, and the kv blocks cover kv_len once (with `causal`, every key at or
  before a tile's last row);
* every TMA box obeys TMA's limits: at most 256 elements per dimension and an inner extent of at most the
  swizzle's 128 bytes;
* shared memory fits a block (232,448 bytes), and the register tiles the design counts on fit the consumers;
* the UNet's shapes take the wgmma + TMA kernel; d = 512, d = 640 and f32 take the mma.sync kernels;
* the VQ latent-diffusion UNets' shapes (d = 32, 64, 96, 128) take the wgmma + TMA kernel, in the fewest steps
  of 16 that cover d."""

import numpy as np
import pytest
import torch

from cflearn_torch.ops import attention as A

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
# (B, H, Lq, Lk, D, dtype): `chip_smoke.py`'s FLASH_CASES and TRAIN_CASES, then the card tests' shapes
SHAPES = [
    (2, 8, 4096, 4096, 40, BF16), (2, 8, 2048, 2048, 40, BF16), (2, 8, 1024, 1024, 80, BF16),
    (2, 8, 256, 256, 160, BF16), (1, 1, 4096, 4096, 512, BF16), (1, 4, 1000, 777, 64, BF16),
    (1, 4, 1000, 1000, 64, BF16), (1, 4, 1000, 777, 64, F32), (1, 2, 512, 512, 640, BF16),
    (8, 1, 1024, 1024, 512, BF16), (8, 8, 4096, 4096, 40, BF16), (8, 8, 1024, 1024, 80, BF16),
    (8, 8, 256, 256, 160, BF16),
    (2, 8, 1024, 1024, 40, F16), (1, 2, 300, 777, 40, BF16), (1, 2, 300, 777, 80, F16), (1, 3, 200, 333, 160, BF16),
    (1, 1, 512, 512, 512, F16), (1, 2, 256, 256, 256, BF16), (1, 2, 256, 256, 160, F32), (1, 1, 200, 330, 640, F16),
    # the VQ latent-diffusion UNets served through `DiffusionAPI` (batch 1): ldm_inpainting at 64x64 and 96x96
    # latents (d 64, 96), ldm_semantic's mid block (d 128), sr on ldm_vq (32 channels a head), and the f4 decoder's
    # mid attention at 128x128 latents
    (1, 8, 1024, 1024, 64, BF16), (1, 8, 256, 256, 96, BF16), (1, 8, 2304, 2304, 64, BF16), (1, 8, 576, 576, 96, BF16),
    (1, 8, 1024, 1024, 128, BF16), (1, 14, 4096, 4096, 32, BF16), (1, 21, 1024, 1024, 32, BF16),
    (1, 28, 256, 256, 32, BF16), (1, 1, 16384, 16384, 512, BF16),
]
# the VQ family's self-attentions, which take the wgmma + TMA kernel (d <= 256)
VQ = [(1, 8, 1024, 64), (1, 8, 256, 96), (1, 8, 2304, 64), (1, 8, 576, 96), (1, 8, 1024, 128), (1, 14, 4096, 32),
      (1, 21, 1024, 32), (1, 28, 256, 32)]
# the UNet's self-attentions: 64x64 latents (and ToMe's merged L = 2048), 32x32, 16x16; CFG batch 2 and finetune 8
UNET = [(b, 8, lq, lq, d) for b in (2, 8) for lq, d in ((4096, 40), (2048, 40), (1024, 80), (256, 160))]
SMS = [132, 114]  # an H100 SXM's SMs, and a PCIe card's


def _ids(shape):
    return "x".join(map(str, shape[:5])) + "_" + str(shape[5]).split(".")[-1]


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plan_covers_every_q_row_once_and_every_key(shape, sms) -> None:
    b, h, lq, lk, d, dtype = shape
    plan = A.flash_plan(b, h, lq, lk, d, dtype, sms)
    tiles = _cdiv(lq, plan.bq)
    seen = np.zeros(lq, dtype=np.int64)
    for t in range(tiles):
        seen[t * plan.bq:(t + 1) * plan.bq] += 1
    assert np.all(seen == 1)
    chunks = _cdiv(d, plan.head_pad) if plan.kernel == "mma_sync_chunked" else 1
    assert plan.ctas == tiles * b * h * chunks
    # the kv blocks a CTA walks (`n_kb` in the kernels): all of kv_len, or with `causal` up to its last row
    for causal in (False, True):
        for t in range(tiles):
            n_kb = _cdiv(lk, plan.bk)
            if causal:
                n_kb = min(n_kb, (t * plan.bq + plan.bq - 1) // plan.bk + 1)
            covered = min(n_kb * plan.bk, lk)
            last_row = min((t + 1) * plan.bq, lq) - 1
            assert covered >= (min(last_row + 1, lk) if causal else lk)
            assert (n_kb - 1) * plan.bk < lk  # no block lies wholly past the keys


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plan_boxes_shared_memory_and_registers_fit(shape, sms) -> None:
    b, h, lq, lk, d, dtype = shape
    plan = A.flash_plan(b, h, lq, lk, d, dtype, sms)
    assert 0 < plan.smem <= A.SMEM_MAX
    if plan.kernel != "sm90":
        assert plan.boxes == () and plan.consumers == 0 and plan.ksteps == 0
        assert plan.head_pad >= min(d, 128)
        return
    # TMA boxes (columns, rows) of q and of k / v: 64 columns of 16-bit values, the 128-byte swizzle's row
    assert plan.boxes == ((A.BOX_COLS, plan.bq), (A.BOX_COLS, plan.bk))
    for box in plan.boxes:
        assert all(1 <= e <= A.TMA_BOX_MAX for e in box)
        assert box[0] * 2 <= plan.swizzle == A.SWIZZLE_BYTES
    # S = Q K^T in whole steps of 16 that cover d, inside the boxes; P.V's N is the boxes' width
    slabs = plan.head_pad // A.BOX_COLS
    assert plan.ksteps in A.SM90_KSTEPS and 16 * plan.ksteps >= d and plan.ksteps <= 4 * slabs
    assert plan.head_pad == A.BOX_COLS * _cdiv(16 * plan.ksteps, A.BOX_COLS) >= d
    assert plan.bq == 64 * plan.consumers and plan.consumers in (1, 2, 3)
    assert plan.consumers < 3 or slabs == 1  # three consumers only where one box holds the head dim
    assert plan.bk in (64, 128) and 2 <= plan.stages <= A.SM90_MAX_STAGES
    assert plan.smem == 1024 + slabs * 128 * (plan.bq + 2 * plan.stages * plan.bk) + 8 * (1 + 4 * A.SM90_MAX_STAGES)
    # a consumer thread holds the P.V accumulator (32 f32 a box), S (bk / 2 f32) and P (bk / 4 registers):
    # under the registers that `setmaxnreg` gives it (232 with two consumers, 160 with three), with room for
    # addresses and softmax state
    assert 32 * slabs + plan.bk // 2 + plan.bk // 4 <= (128 if plan.consumers == 3 else 176)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", UNET, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [BF16, F16])
def test_unet_shapes_take_the_sm90_kernel(shape, dtype, sms) -> None:
    b, h, lq, lk, d = shape
    plan = A.flash_plan(b, h, lq, lk, d, dtype, sms)
    assert plan.kernel == "sm90"
    # ping-ponged consumers where the 128-row grid keeps half the SMs busy (B2 H8 L256, 32 such CTAs, takes
    # one); three of them only at d = 40, where one box holds the head dim
    assert plan.consumers in ((1,) if (b, lq) == (2, 256) else (2,) if d > 64 else (2, 3))
    # the mma.sync kernel stays reachable by name, as the yardstick
    assert A.flash_plan(b, h, lq, lk, d, dtype, sms, kernel="mma_sync").kernel == "mma_sync"


@pytest.mark.parametrize(
    "shape,dtype,want",
    [((1, 1, 4096, 4096, 512), BF16, "mma_sync"), ((8, 1, 1024, 1024, 512), F16, "mma_sync"),
     ((1, 2, 512, 512, 640), BF16, "mma_sync_chunked"), ((1, 4, 1000, 777, 64), F32, "mma_sync_chunked"),
     ((2, 8, 1024, 1024, 80), F32, "mma_sync_chunked"), ((1, 2, 256, 256, 256), BF16, "sm90"),
     ((1, 2, 256, 256, 264), BF16, "mma_sync")],
)
def test_plan_routes_what_the_sm90_kernel_does_not_take(shape, dtype, want) -> None:
    assert A.flash_plan(*shape, dtype).kernel == want
    forced = A.flash_plan(*shape, dtype, kernel="mma_sync").kernel
    assert forced == ("mma_sync" if want == "sm90" else want)
    if want != "sm90":
        with pytest.raises(ValueError):
            A.flash_plan(*shape, dtype, kernel="sm90")


@pytest.mark.parametrize(
    "shape,sms,want",
    [((2, 8, 4096, 4096, 40), 132, 3),  # 352 CTAs of 192 rows: 3 waves, against 4 of 128 rows
     ((2, 8, 2048, 2048, 40), 132, 2),  # 176 CTAs of 192 rows take 2 waves, as 256 of 128 rows do
     ((8, 8, 4096, 4096, 40), 132, 3), ((2, 8, 1024, 1024, 80), 132, 2)],
)
def test_plan_takes_three_consumers_where_their_waves_finish_sooner(shape, sms, want) -> None:
    assert A.flash_plan(*shape, BF16, sms).consumers == want


def test_plan_refuses_an_unknown_kernel() -> None:
    with pytest.raises(ValueError):
        A.flash_plan(2, 8, 1024, 1024, 40, BF16, kernel="triton")


def test_unet_transposed_views_reach_the_kernel_without_a_copy() -> None:
    """The UNet hands q, k, v over as transposed views of (B, L, H, D) storage: their strides are multiples of
    8 elements, so the tensor maps read them in place."""
    x = torch.randn((2, 64, 8, 40), dtype=BF16).transpose(1, 2)
    assert A._kernel_view(x) is x
    # an expanded (stride 0) or odd-strided view is copied
    assert A._kernel_view(torch.randn((1, 1, 64, 40), dtype=BF16).expand(2, 8, 64, 40)).is_contiguous()
    assert A._kernel_view(torch.randn((2, 8, 64, 44), dtype=BF16)[..., :40]).is_contiguous()


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", VQ, ids=lambda s: "x".join(map(str, s)))
def test_vq_family_shapes_take_the_wgmma_kernel(shape, sms) -> None:
    b, h, l, d = shape
    plan = A.flash_plan(b, h, l, l, d, BF16, sms)
    assert plan.kernel == "sm90"
    assert plan.ksteps == {32: 2, 64: 4, 96: 6, 128: 8}[d] and 16 * plan.ksteps == d
    assert plan.head_pad == A.BOX_COLS * -(-d // A.BOX_COLS)
    assert plan.bk == 128 and plan.ctas == -(-l // plan.bq) * b * h
