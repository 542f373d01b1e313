"""The W8A8 route's host side on the CPU (`cflearn_torch/ops/conv.py`): the
tile planner of the s8 wgmma + TMA int8 conv (`conv3x3_w8a8_plan`), its K
walk, and the arithmetic of the one-launch quantiser (`quantize_w8a8`). The
kernels run only on the card (`tests/test_torch_cuda.py`); which pixels,
channels and K slices each CTA takes, and which constants and orderings the
quantiser relies on, are held here.

* every output pixel is stored by exactly one tile, and the persistent CTAs
  walk every tile once;
* every box obeys TMA's limits: an inner box of 128 int8 channels (128
  bytes, the 128-byte swizzle's row), at most 256 elements per dimension;
* the kernel's K walk (tap-major, 128-channel slices zero-filled past C,
  the halo outside the image, each consumer's 64-row groups), emulated with
  exact integer sums, gives `conv3x3_int8_plain` bit for bit, and planted
  faults do not;
* the quantiser's scale constants and arithmetic equal `_quant_scale`, its
  maximum over 16-bit patterns equals the maximum of |x|, and both of its
  passes over x visit every 16-byte chunk once."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cflearn_torch.ops import conv as C

# (B, H, W, C, Co): the VAE decoder's eight conv shapes at 512px, then odd ones: H != W with C != Co, C = 144 (a
# second 128-channel slice zero-filled past C), an image narrower than a box, and narrow channel counts
DECODER = [
    (1, 64, 64, 512, 512), (1, 128, 128, 512, 512), (1, 256, 256, 512, 512), (1, 256, 256, 512, 256),
    (1, 256, 256, 256, 256), (1, 512, 512, 256, 256), (1, 512, 512, 256, 128), (1, 512, 512, 128, 128),
]
SHAPES = DECODER + [
    (3, 33, 47, 64, 136), (3, 33, 47, 144, 136), (2, 129, 131, 64, 96), (1, 7, 300, 16, 8), (2, 5, 7, 96, 64),
]
SMS = [132, 114, 1]  # an H100 SXM's SMs, a PCIe card's, and one SM (every tile in one CTA)
CSRC = Path(C.__file__).resolve().parent.parent / "csrc"


def _ids(shape):
    return "x".join(map(str, shape))


def _coverage(b, h, w, th, tw, boxes):
    seen = np.zeros((b, h, w), dtype=np.int64)
    for m in range(boxes):
        for p in C.box_pixels(h, w, th, tw, m):
            seen[p] += 1
    return seen


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_w8a8_plan_stores_every_output_pixel_once(shape, sms) -> None:
    b, h, w, c, co = shape
    plan = C.conv3x3_w8a8_plan(b, h, w, c, co, sms)
    assert plan.th * plan.tw == 128
    assert plan.m_tiles == b * -(-h // plan.th) * -(-w // plan.tw)
    assert np.all(_coverage(b, h, w, plan.th, plan.tw, plan.m_tiles) == 1)
    # output channels: n tiles of bn cover [0, co) once, the last one ragged at most
    assert plan.n_tiles == -(-co // plan.bn) and (plan.n_tiles - 1) * plan.bn < co


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_w8a8_plan_persistent_ctas_walk_every_tile_once(shape, sms) -> None:
    plan = C.conv3x3_w8a8_plan(*shape, sms=sms)
    tiles = plan.m_tiles * plan.n_tiles
    assert 1 <= plan.ctas <= min(tiles, sms)
    walked = sorted(t for cta in range(plan.ctas) for t in range(cta, tiles, plan.ctas))
    assert walked == list(range(tiles))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_w8a8_plan_boxes_obey_tma_limits(shape, sms) -> None:
    b, h, w, c, co = shape
    plan = C.conv3x3_w8a8_plan(b, h, w, c, co, sms)
    # the x box (128 channels, tw, th, 1) and the weight box (128 channels, 1 tap, bn): 128 bytes innermost
    assert C.W8A8_BOX_CHANNELS * 1 == 128
    assert max(plan.th, plan.tw, plan.bn) <= C.TMA_BOX_MAX and plan.bn == 128
    assert plan.k_slices == -(-c // 128) and plan.k_slices * 128 >= c
    # the ring: at least two stages of 1024-byte aligned boxes, and the consumers' two staged output tiles (128
    # pixels by 128 16-bit channels, two 64-channel boxes each), within a CTA's 227 KB
    stage = (plan.th * plan.tw + plan.bn) * 128
    out = plan.th * plan.tw * plan.bn * 2
    assert stage % C.SWIZZLE_ATOM == 0 and out % C.SWIZZLE_ATOM == 0 and plan.stages >= 2
    assert plan.smem == plan.stages * stage + 2 * out + 16 * plan.stages + C.SWIZZLE_ATOM <= 232448


def test_w8a8_plan_is_the_kernels_layout() -> None:
    """The planner's ring depth and shared memory are the constants the kernel is compiled with."""
    src = (CSRC / "conv3x3_w8a8.cu").read_text()
    plan = C.conv3x3_w8a8_plan(1, 64, 64, 512, 512)
    assert re.search(r"constexpr int STAGES = (\d+);", src).group(1) == str(plan.stages)
    assert re.search(r"constexpr int SMEM = .*// ([\d,]+) bytes", src).group(1).replace(",", "") == str(plan.smem)


def test_w8a8_plan_boxes() -> None:
    """The 64^2 level takes boxes of two rows of 64 (32 tiles x 4), 512^2 one row of 128; a CTA an SM."""
    p64, p512 = C.conv3x3_w8a8_plan(1, 64, 64, 512, 512), C.conv3x3_w8a8_plan(1, 512, 512, 128, 128)
    assert (p64.th, p64.tw, p64.m_tiles * p64.n_tiles, p64.ctas) == (2, 64, 128, 128)
    assert (p512.th, p512.tw, p512.m_tiles, p512.ctas) == (1, 128, 2048, 132)


def _ring(tiles: int, ctas: int, ksteps: int, stages: int):
    """Each CTA's ring, filled by its producer tile after tile: (consumer, tile, ring index) of every K step,
    with the stage and phase each consumer computes from its tile's place among the CTA's tiles."""
    out = []
    for cta in range(ctas):
        for j, tile in enumerate(range(cta, tiles, ctas)):
            first = j * ksteps
            stage, phase = first % stages, first // stages % 2
            for ks in range(ksteps):
                out.append((cta, j % 2, tile, first + ks, stage, phase))
                stage, phase = (0, phase ^ 1) if stage + 1 == stages else (stage + 1, phase)
    return out


@pytest.mark.parametrize("shape", [(1, 64, 64, 512, 512), (1, 512, 512, 128, 128), (3, 33, 47, 144, 136)], ids=_ids)
def test_w8a8_pingpong_consumers_take_every_other_tile_and_find_their_stages(shape) -> None:
    """Consumer g takes a CTA's tiles g, g + 2, ...; the stage and phase it computes for its tile's K steps
    are those the producer fills them in (ring index i at stage i % stages, phase i // stages % 2), every
    ring index once."""
    b, h, w, c, co = shape
    plan = C.conv3x3_w8a8_plan(b, h, w, c, co)
    ring = _ring(plan.m_tiles * plan.n_tiles, plan.ctas, 9 * plan.k_slices, plan.stages)
    assert sorted(t for _, _, t, i, _, _ in ring if i % (9 * plan.k_slices) == 0) == list(
        range(plan.m_tiles * plan.n_tiles))
    for cta in range(plan.ctas):
        mine = [r for r in ring if r[0] == cta]
        assert [r[3] for r in mine] == list(range(len(mine)))
        assert all(stage == i % plan.stages and phase == i // plan.stages % 2 for _, _, _, i, stage, phase in mine)
        assert {g for _, g, _, _, _, _ in mine} <= {0, 1}


def test_w8a8_int32_sums_stay_exact_up_to_the_limit() -> None:
    """The 8-bit wgmma's int32 sums wrap: 9 * C products of at most 127^2 fit
    below 2^31 exactly up to W8A8_MAX_C."""
    assert 127 * 127 * 9 * C.W8A8_MAX_C < 2**31 <= 127 * 127 * 9 * (C.W8A8_MAX_C + 1)
    assert re.search(r"MAX_C = (\d+);", (CSRC / "conv3x3_w8a8.cu").read_text()).group(1) == str(C.W8A8_MAX_C)


def _w8a8_walk(x8, w8, scale, bias, out_dtype, plan, zero_fill=True, group_rows=64):
    """The int8 kernel's K walk with exact sums, from the plan: per tile, tap (di, dj) and 128-channel slice,
    the x box of th x tw pixels at (j0 + dj - 1, i0 + di - 1), zero outside the image and past C, and the
    weight box of bn output channels at that tap, zero past C and past Co (`zero_fill=False`, a planted
    fault: a slice runs on into the next pixel's channels of x and the next tap's of the flat (Co, 9C)
    weight row, as a copy of contiguous memory would); the tile's consumer multiplies its two groups of 64
    box rows, the second `group_rows` rows on (another offset is a planted fault); then the epilogue of
    `conv3x3_int8_plain` on the pixels inside the image."""
    b, h, wd, c = x8.shape
    co = w8.shape[0]
    kc, th, tw, bn = plan.k_slices, plan.th, plan.tw, plan.bn
    xp = torch.zeros((b, h + 2 + th, wd + 2 + tw, kc * 128), dtype=torch.int64)
    xp[:, 1 : h + 1, 1 : wd + 1, :c] = x8.to(torch.int64)
    if not zero_fill and kc * 128 > c:
        xp[:, :, :-1, c:] = xp[:, :, 1:, : kc * 128 - c]
    flat = torch.zeros((co + bn, 9 * c + kc * 128), dtype=torch.int64)
    flat[:co, : 9 * c] = w8.reshape(co, 9 * c).to(torch.int64)
    y = torch.zeros((b, h, wd, co), dtype=out_dtype)
    rows_t, cols_t = -(-h // th), -(-wd // tw)
    for tile in range(plan.m_tiles * plan.n_tiles):
        n0, m = (tile % plan.n_tiles) * bn, tile // plan.n_tiles
        j0, i0, bi = (m % cols_t) * tw, (m // cols_t % rows_t) * th, m // (cols_t * rows_t)
        acc = torch.zeros((128, bn), dtype=torch.int64)
        for tap in range(9):
            di, dj = divmod(tap, 3)
            box = xp[bi, i0 + di : i0 + di + th, j0 + dj : j0 + dj + tw].reshape(128, kc * 128)
            for kk in range(kc):
                k0 = tap * c + kk * 128
                wt = flat[n0 : n0 + bn, k0 : k0 + 128].clone()
                if zero_fill:
                    wt[:, max(0, c - kk * 128) :] = 0
                for rg in range(2):
                    r = rg * group_rows
                    acc[rg * 64 : rg * 64 + 64] += box[r : r + 64, kk * 128 : (kk + 1) * 128] @ wt.T
        for r in range(128):
            i, j = i0 + r // tw, j0 + r % tw
            if i < h and j < wd:
                cols = slice(n0, min(n0 + bn, co))
                out = (acc[r, : cols.stop - n0].float() * scale[cols].float()).to(out_dtype)
                y[bi, i, j, cols] = out if bias is None else out + bias[cols].to(out_dtype)
    return y


# small shapes: C = 144 and 40 (slices zero-filled past C), Co = 136 (two channel tiles, the second ragged), a box of
# 8 x 16 over a 9 x 20 image, and two images of 3 x 7
WALK = [(1, 5, 20, 144, 24), (1, 9, 20, 40, 136), (2, 3, 7, 16, 8), (1, 4, 33, 144, 136)]


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("shape", WALK, ids=_ids)
def test_w8a8_walk_emulated_matches_the_plain_version(shape, with_bias) -> None:
    b, h, w, c, co = shape
    gen = torch.Generator().manual_seed(0)
    x8 = torch.randint(-127, 128, (b, h, w, c), generator=gen, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (co, 3, 3, c), generator=gen, dtype=torch.int8)
    scale = torch.rand((co,), generator=gen) * 1e-3
    bias = (torch.randn((co,), generator=gen) * 0.1).bfloat16() if with_bias else None
    plan = C.conv3x3_w8a8_plan(b, h, w, c, co)
    ref = C.conv3x3_int8_plain(x8, w8, scale, bias, torch.bfloat16)
    assert torch.equal(_w8a8_walk(x8, w8, scale, bias, torch.bfloat16, plan), ref)


def test_w8a8_walk_planted_faults_fail() -> None:
    """Slices that run on into the next pixel's and tap's channels (no zero fill past C = 144), and a second
    64-row group read from the first group's rows, both miss."""
    gen = torch.Generator().manual_seed(1)
    x8 = torch.randint(-127, 128, (1, 5, 20, 144), generator=gen, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (24, 3, 3, 144), generator=gen, dtype=torch.int8)
    scale = torch.rand((24,), generator=gen) * 1e-3
    plan = C.conv3x3_w8a8_plan(1, 5, 20, 144, 24)
    ref = C.conv3x3_int8_plain(x8, w8, scale, None, torch.bfloat16)
    assert torch.equal(_w8a8_walk(x8, w8, scale, None, torch.bfloat16, plan), ref)
    assert not torch.equal(_w8a8_walk(x8, w8, scale, None, torch.bfloat16, plan, zero_fill=False), ref)
    assert not torch.equal(_w8a8_walk(x8, w8, scale, None, torch.bfloat16, plan, group_rows=0), ref)


# ---- the quantiser (`csrc/quantize_w8a8.cu`) ----


def _source_constant(name: str) -> float:
    """A float constant of the quantiser's source, written there as a hex literal."""
    m = re.search(rf"constexpr float {name} = (0x[0-9a-fA-F.p+-]+)f;", (CSRC / "quantize_w8a8.cu").read_text())
    return float.fromhex(m.group(1))


def _kernel_scale(amax: float) -> np.float32:
    """The kernel's `quant_scale`: f64(amax) * f64(INV_127) + f64(EPS), each rounded to f64, then to f32."""
    prod = np.float64(amax) * np.float64(_source_constant("INV_127"))
    return np.float32(prod + np.float64(_source_constant("EPS")))


def test_quantiser_constants_are_the_plain_versions() -> None:
    assert _source_constant("INV_127") == C._INV_127 == float(np.float32(1.0 / 127.0))
    assert _source_constant("EPS") == C._EPS == float(np.float32(1e-12))


# amax: zero, the largest bf16 and fp16 values, a bf16 and an fp16 subnormal, and values around the scale of 1
AMAX = [0.0, float(torch.finfo(torch.bfloat16).max), 65504.0, 2.0**-133, 2.0**-24, 1.0, 127.0, 3.140625, 1e-30]


@pytest.mark.parametrize("amax", AMAX)
def test_quantiser_scale_equals_quant_scale(amax) -> None:
    got = _kernel_scale(amax)
    want = C._quant_scale(torch.tensor(amax, dtype=torch.float32))
    assert got.tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_quantiser_max_of_16_bit_patterns_is_the_max_of_abs(dtype) -> None:
    """Sign bits cleared, the 16-bit patterns order as |x| does: their integer maximum, converted back, is
    max|x| at negative zeros, subnormals, +-the largest value and in the last element."""
    info = torch.finfo(dtype)
    gen = torch.Generator().manual_seed(2)
    cases = [
        torch.randn((4096,), generator=gen).to(dtype),
        torch.tensor([-0.0, 0.0, -0.0], dtype=dtype),
        torch.tensor([info.tiny / 4, -info.tiny / 2, info.tiny / 8], dtype=dtype),
        torch.cat([torch.randn((255,), generator=gen), torch.tensor([-info.max])]).to(dtype),
        torch.cat([torch.randn((255,), generator=gen), torch.tensor([info.max])]).to(dtype),
        torch.cat([torch.randn((255,), generator=gen), torch.tensor([-50.0])]).to(dtype),
    ]
    for x in cases:
        bits = x.view(torch.int16).to(torch.int32) & 0x7FFF
        amax = torch.tensor([int(bits.max())], dtype=torch.int16).view(dtype).float()
        want = torch.linalg.vector_norm(x, float("inf")).float()
        assert amax.item() == want.item() and amax.view(torch.int32).item() == want.view(torch.int32).item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_quantiser_rounding_equals_to_int8(dtype) -> None:
    """The kernel's per-value arithmetic, rint(f32 v / s) clipped to +-127 with an IEEE division, is the
    plain version's `_to_int8`, ties (k + 0.5 at s = 1) to even."""
    ties = torch.cat([torch.arange(-127, 127) + 0.5, torch.tensor([127.0])]).to(dtype)
    for x in (ties, torch.randn((4096,), generator=torch.Generator().manual_seed(3)).to(dtype) * 40):
        s = C._quant_scale(torch.linalg.vector_norm(x, float("inf")).float())
        v = x.float().numpy()
        got = np.clip(np.rint(v / np.float32(s.item())), -127, 127).astype(np.int8)
        assert np.array_equal(got, C._to_int8(x, s).numpy())


def _passes(chunks: int, ctas: int, threads: int = C.QUANT_THREADS, unroll: int = 4):
    """The chunks each pass of the quantiser visits: the unrolled strided loop, then its tail, as the kernel
    walks them; the second pass at chunks - 1 - i."""
    stride = ctas * threads
    first = [cta * threads + t for cta in range(ctas) for t in range(threads)]
    seen = []
    for i0 in first:
        i = i0
        while i + (unroll - 1) * stride < chunks:
            seen.extend(i + u * stride for u in range(unroll))
            i += unroll * stride
        while i < chunks:
            seen.append(i)
            i += stride
    return seen, [chunks - 1 - i for i in seen]


@pytest.mark.parametrize("n,co", [(64 * 64 * 512, 512), (3 * 33 * 47 * 144, 136), (2 * 5 * 8 * 48, 24), (16, 8)])
def test_quantiser_passes_visit_every_chunk_once(n, co) -> None:
    ctas = C.quantize_ctas(n, co, 4)  # four SMs keep the emulation small; the walk does not depend on it
    assert 1 <= ctas <= C.QUANT_CTAS_PER_SM * 4
    first, second = _passes(n // 8, ctas)
    assert sorted(first) == sorted(second) == list(range(n // 8))


@pytest.mark.parametrize("shape", DECODER, ids=_ids)
def test_quantiser_grid_fits_the_card(shape) -> None:
    """Two CTAs an SM at the decoder's shapes, each taking at least one 16-byte chunk a thread."""
    b, h, w, c, co = shape
    ctas = C.quantize_ctas(b * h * w * c, co, 132)
    assert ctas == 2 * 132 and b * h * w * c // 8 >= ctas * C.QUANT_THREADS
    assert math.ceil(co / ctas) <= 2  # at most two weight rows a CTA
