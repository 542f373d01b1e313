"""The tile planner of the Hopper conv kernels (`cflearn_torch/ops/conv.py`:
`conv3x3_plan`, `wgrad_plan`, `box_pixels`), on the CPU: the kernels
themselves run only on the card (`tests/test_torch_cuda.py`), but which
pixels, channels and K steps each CTA takes is decided here, in Python.

* every output pixel of the forward is stored by exactly one tile, and the
  persistent CTAs walk every tile once;
* every K step of the weight gradient lies in exactly one split, every split
  is non-empty, and the K steps' boxes cover every pixel once;
* every box obeys TMA's limits: at most 256 elements per dimension, an inner
  extent of at most 128 bytes under the 128-byte swizzle, and the kernels'
  fixed pixel counts per box."""

import numpy as np
import pytest

from cflearn_torch.ops import conv as C

# (B, H, W, C, Co): the VAE decoder's convs at 512px, the autoencoder step's forward and dx shapes at
# batch 8, the two odd shapes of `chip_smoke.py`, and the card tests' narrow and ragged ones
SHAPES = [
    (1, 64, 64, 512, 512), (1, 128, 128, 512, 512), (1, 256, 256, 512, 512), (1, 256, 256, 512, 256),
    (1, 256, 256, 256, 256), (1, 512, 512, 256, 256), (1, 512, 512, 256, 128), (1, 512, 512, 128, 128),
    (8, 256, 256, 128, 128), (8, 256, 256, 256, 128), (8, 128, 128, 128, 256), (8, 128, 128, 256, 256),
    (8, 128, 128, 512, 256), (8, 64, 64, 512, 512), (2, 129, 131, 64, 96), (3, 33, 47, 64, 136),
    (3, 20, 131, 24, 72), (2, 9, 40, 72, 24), (2, 128, 128, 64, 264), (1, 7, 131, 72, 264), (2, 5, 7, 96, 64),
]
SMS = [132, 114]  # an H100 SXM's SMs, and a PCIe card's


def _coverage(b, h, w, th, tw, boxes):
    seen = np.zeros((b, h, w), dtype=np.int64)
    for m in range(boxes):
        for p in C.box_pixels(h, w, th, tw, m):
            seen[p] += 1
    return seen


def _ids(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_conv_plan_stores_every_output_pixel_once(shape) -> None:
    b, h, w, c, co = shape
    plan = C.conv3x3_plan(b, h, w, c, co)
    assert plan.m_tiles == b * -(-h // plan.th) * -(-w // plan.tw)
    assert np.all(_coverage(b, h, w, plan.th, plan.tw, plan.m_tiles) == 1)
    # output channels: n tiles of bn cover [0, co) once, the last one ragged at most
    assert plan.n_tiles == -(-co // plan.bn) and (plan.n_tiles - 1) * plan.bn < co


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_conv_plan_persistent_ctas_walk_every_tile_once(shape, sms) -> None:
    plan = C.conv3x3_plan(*shape, sms=sms)
    tiles = plan.m_tiles * plan.n_tiles
    assert 1 <= plan.ctas <= min(tiles, sms)
    walked = sorted(t for cta in range(plan.ctas) for t in range(cta, tiles, plan.ctas))
    assert walked == list(range(tiles))
    # 256 output channels per tile only where the grid still fills the card
    assert plan.bn in (128, 256) and (plan.bn == 128 or plan.m_tiles * plan.n_tiles >= sms)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_wgrad_plan_splits_cover_every_k_step_once(shape, sms) -> None:
    b, h, w, c, co = shape
    plan = C.wgrad_plan(b, h, w, c, co, sms=sms)
    assert plan.k_tiles == b * h * -(-w // C.WGRAD_PIXELS)
    assert plan.units == 3 * -(-co // C.WGRAD_BM) * -(-c // C.WGRAD_BN)
    ranges = [range(s * plan.per, min(plan.k_tiles, (s + 1) * plan.per)) for s in range(plan.splits)]
    assert all(len(r) > 0 for r in ranges)  # every split non-empty
    assert sorted(k for r in ranges for k in r) == list(range(plan.k_tiles))
    # at most two waves of CTAs, and where there are K steps enough they keep 90% of the SMs busy
    ctas = plan.units * plan.splits
    waves = -(-ctas // sms)
    assert waves <= 2 or plan.splits == 1
    if plan.k_tiles >= 8 * 2 * sms:
        assert ctas / (waves * sms) >= 0.9


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_wgrad_plan_k_steps_cover_every_pixel_once(shape) -> None:
    b, h, w, c, co = shape
    plan = C.wgrad_plan(b, h, w, c, co)
    assert np.all(_coverage(b, h, w, 1, C.WGRAD_PIXELS, plan.k_tiles) == 1)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_boxes_obey_tma_limits(shape) -> None:
    b, h, w, c, co = shape
    conv, wgrad = C.conv3x3_plan(b, h, w, c, co), C.wgrad_plan(b, h, w, c, co)
    # 16-bit channels-last boxes (64 channels, tw, th, 1), the forward's weight box (64, 1, bn), and the
    # weight gradient's dy box of one image row and its x box two pixels wider (its three taps dj)
    boxes = [(C.BOX_CHANNELS, conv.tw, conv.th, 1), (C.BOX_CHANNELS, 1, conv.bn), (C.BOX_CHANNELS, C.WGRAD_PIXELS, 1, 1),
             (C.BOX_CHANNELS, C.WGRAD_PIXELS + 2, 1, 1)]
    for box in boxes:
        assert all(1 <= e <= C.TMA_BOX_MAX for e in box)
        assert box[0] * 2 <= 128  # the inner extent under the 128-byte swizzle
    assert conv.th * conv.tw == C.CONV_PIXELS
    assert conv.tw >= 8 and conv.tw & (conv.tw - 1) == 0
    assert wgrad.k_tiles >= 1 and 1 <= wgrad.splits <= wgrad.k_tiles
    # TMA's global strides are multiples of 16 bytes exactly when the wrapper's C % 8 == 0 and Co % 8 == 0 hold
    assert (c * 2) % 16 == 0 and (co * 2) % 16 == 0


@pytest.mark.parametrize("h,w,want", [(64, 64, (2, 64)), (256, 256, (1, 128)), (129, 131, (8, 16)), (1, 257, (1, 128))])
def test_pixel_box_takes_the_fewest_boxes(h, w, want) -> None:
    assert C.pixel_box(h, w, 128) == want
