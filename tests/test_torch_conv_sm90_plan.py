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
import torch

from cflearn_torch.ops import conv as C

# (B, H, W, C, Co): the VAE decoder's convs at 512px, the autoencoder step's forward and dx shapes at
# batch 8, the two odd shapes of `chip_smoke.py`, and the card tests' narrow and ragged ones
SHAPES = [
    (1, 64, 64, 512, 512), (1, 128, 128, 512, 512), (1, 256, 256, 512, 512), (1, 256, 256, 512, 256),
    (1, 256, 256, 256, 256), (1, 512, 512, 256, 256), (1, 512, 512, 256, 128), (1, 512, 512, 128, 128),
    (8, 256, 256, 128, 128), (8, 256, 256, 256, 128), (8, 128, 128, 128, 256), (8, 128, 128, 256, 256),
    (8, 128, 128, 512, 256), (8, 64, 64, 512, 512), (2, 129, 131, 64, 96), (3, 33, 47, 64, 136),
    (3, 20, 131, 24, 72), (2, 9, 40, 72, 24), (2, 128, 128, 64, 264), (1, 7, 131, 72, 264), (2, 5, 7, 96, 64),
    # the VQ latent-diffusion paths' new shapes (batch 1): the f4 encoders and decoders at 256px and 384px, the
    # ldm_semantic UNet at 128x128 (a 640-channel skip concatenation) and the sr UNet at 128x128, whose 224- and
    # 672-channel convs are not multiples of 64
    (1, 128, 128, 128, 128), (1, 128, 128, 128, 256), (1, 128, 128, 256, 128), (1, 128, 128, 256, 256),
    (1, 128, 128, 512, 256), (1, 128, 128, 640, 128), (1, 128, 128, 224, 224), (1, 128, 128, 448, 224),
    (1, 128, 128, 448, 448), (1, 128, 128, 672, 224), (1, 192, 192, 128, 256), (1, 192, 192, 256, 256),
    (1, 192, 192, 512, 256), (1, 192, 192, 512, 512), (1, 256, 256, 128, 128), (1, 256, 256, 256, 128),
    (1, 384, 384, 128, 128), (1, 384, 384, 256, 128), (1, 384, 384, 256, 256),
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


# ---- the dj-folded kernel (`conv3x3_fold_plan`) ----

# the VAE decoder's convs at 512px (`chip_smoke.py`'s CONV_CASES, which the fold decode runs), then C % 64 != 0
# (a 64-channel slice past C in each dj tap), narrow and ragged images, and the card tests' shapes
FOLD_SHAPES = SHAPES[:8] + [(2, 129, 131, 64, 96), (2, 33, 47, 64, 136), (2, 9, 7, 40, 24), (3, 20, 131, 24, 72),
                            (1, 5, 130, 72, 16), (1, 128, 128, 256, 128)]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", FOLD_SHAPES, ids=_ids)
def test_fold_plan_boxes_and_stages(shape, sms) -> None:
    b, h, w, c, co = shape
    plan = C.conv3x3_fold_plan(b, h, w, c, co, sms=sms)
    assert plan.kernel == "sm90" and (plan.th, plan.tw) in C.FOLD_BOXES and plan.th * plan.tw == C.CONV_PIXELS
    # the x box: 64 channels, two columns wider than the tile (the halo of dj = 0 and 2), th rows
    assert plan.x_box == (C.BOX_CHANNELS, plan.tw + 2, plan.th)
    assert all(1 <= e <= C.TMA_BOX_MAX for e in plan.x_box) and plan.x_box[0] * 2 == 128
    box_rows = plan.th * (plan.tw + 2)
    assert box_rows * 128 <= C.FOLD_A_STRIDE and C.FOLD_A_STRIDE % C.SWIZZLE_ATOM == 0
    # each consumer's 64 rows at tap dj are 64 consecutive rows of the box: the pixels of one image row
    for g in (0, 1):
        row0 = C.fold_x_row0(g, plan.tw)
        assert row0 + 2 + 63 < box_rows
        for dj in range(3):
            for m in (0, 63):
                r = g * 64 + m  # the tile's pixel (r // tw, r % tw) reads box pixel (r // tw, r % tw + dj)
                assert row0 + dj + m == (r // plan.tw) * (plan.tw + 2) + r % plan.tw + dj
    # the rings and the weight tiles (64 channels, one tap, bn output channels) fit shared memory
    assert plan.a_stages >= 2 and plan.b_stages >= 2 and plan.smem <= 232448
    assert plan.smem >= plan.a_stages * C.FOLD_A_STRIDE + plan.b_stages * plan.bn * 128
    assert plan.k_slices == -(-c // C.BOX_CHANNELS)
    # pixels stored once, persistent CTAs walking every tile once
    assert np.all(_coverage(b, h, w, plan.th, plan.tw, plan.m_tiles) == 1)
    tiles = plan.m_tiles * plan.n_tiles
    assert plan.n_tiles == -(-co // plan.bn) and 1 <= plan.ctas <= min(tiles, sms)
    assert plan.bn == 128 or plan.m_tiles * plan.n_tiles >= sms


def test_fold_plan_yardstick_and_boxes() -> None:
    old = C.conv3x3_fold_plan(1, 64, 64, 512, 512, kernel="mma_sync")
    assert old.kernel == "mma_sync" and old.ctas == old.m_tiles * old.n_tiles == 32 * 4
    with pytest.raises(ValueError):
        C.conv3x3_fold_plan(1, 64, 64, 512, 512, kernel="nope")
    # 64^2 takes two rows of 64 (32 boxes), 512^2 one row of 128 (2048)
    assert (C.conv3x3_fold_plan(1, 64, 64, 512, 512).th, C.conv3x3_fold_plan(1, 512, 512, 128, 128).th) == (2, 1)


def _fold_walk(x, w_ohwi, bias, plan, shift=True):
    """The fold kernel's K walk in f32, from the plan: per tile and row tap di one x box
    two columns wider (zero outside the image); per 64-channel slice (zero past C) and
    tap dj each consumer's operand is its 64 box rows from `fold_x_row0` + dj (+ 0 for
    every dj where `shift` is False, a planted fault)."""
    b, h, wd, c = x.shape
    co = w_ohwi.shape[0]
    kc = plan.k_slices
    xp = torch.zeros((b, h + 2 + plan.th, wd + 2 + plan.tw, kc * 64))
    xp[:, 1 : h + 1, 1 : wd + 1, :c] = x
    wp = torch.zeros((co, 3, 3, kc * 64))
    wp[..., :c] = w_ohwi
    y = torch.zeros((b, h, wd, co))
    rows_t, cols_t = -(-h // plan.th), -(-wd // plan.tw)
    for m in range(plan.m_tiles):
        j0, i0, bi = (m % cols_t) * plan.tw, (m // cols_t % rows_t) * plan.th, m // (cols_t * rows_t)
        acc = torch.zeros((128, co))
        for di in range(3):
            # the box at (j0 - 1, i0 + di - 1): padded coordinates shift by one
            box = xp[bi, i0 + di : i0 + di + plan.th, j0 : j0 + plan.tw + 2].reshape(-1, kc * 64)
            for kk in range(kc):
                for dj in range(3):
                    for g in (0, 1):
                        r0 = C.fold_x_row0(g, plan.tw) + (dj if shift else 0)
                        a = box[r0 : r0 + 64, kk * 64 : (kk + 1) * 64]
                        acc[g * 64 : g * 64 + 64] += a @ wp[:, di, dj, kk * 64 : (kk + 1) * 64].T
        for r in range(128):
            i, j = i0 + r // plan.tw, j0 + r % plan.tw
            if i < h and j < wd:
                y[bi, i, j] = acc[r] + bias
    return y


@pytest.mark.parametrize("shape", [(1, 3, 70, 40, 24), (2, 2, 130, 72, 16), (1, 4, 64, 64, 8)], ids=_ids)
def test_fold_walk_emulated_matches_the_plain_version(shape) -> None:
    """The box rows, the dj shift and the per-tap channel padding (C % 64 != 0: 40 and
    72 channels) give the fold's function; without the dj shift they do not."""
    b, h, w, c, co = shape
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((b, h, w, c), generator=gen)
    wt = torch.randn((co, 3, 3, c), generator=gen) * (9 * c) ** -0.5
    bias = torch.randn((co,), generator=gen) * 0.1
    plan = C.conv3x3_fold_plan(b, h, w, c, co)
    ref = C.conv3x3_fold_plain(x, wt, bias)
    got = _fold_walk(x, wt, bias, plan)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    bad = _fold_walk(x, wt, bias, plan, shift=False)
    assert (bad - ref).abs().max().item() > 2.0**-6 * ref.abs().max().item()
