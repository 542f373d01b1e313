"""The planner of the one-launch GroupNorm kernel (`cflearn_torch/ops/group_norm.py`:
`gn_plan`), on the CPU: the kernel runs only on the card (`tests/test_torch_cuda.py`),
but which rows each CTA takes, what it keeps in shared memory and how many CTAs the
cooperative grid has is decided here, in Python.

* every shape of `chip_smoke.py`'s `gn_cases()` gets a route, one launch;
* the slabs of rows cover each sample once, and in each wave of samples the
  CTAs walk every slab once;
* the grid is at most one CTA per SM (all resident: the grid barrier);
* the kept rows, the sums and the statistics fit a CTA's shared memory;
* the txt2img UNet's shapes keep every row on chip; the VAE decoder's 512^2
  levels are streamed;
* the kernel's algorithm (per-slab channel sums in a fixed order, group sums,
  the slabs gathered by JG threads a group and added in order), emulated in
  plain PyTorch from the plan, matches `group_norm_silu_plain`; an emulation
  whose lanes add only their first slab does not."""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from cflearn_torch.ops import group_norm as G

SMS = [132, 114]  # an H100 SXM's SMs, and a PCIe card's


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cases():
    """(id, batch, spatial, channels, groups, itemsize) of every `gn_cases()` shape."""
    out = []
    for name, shape, groups, dtype, _silu, _per in _smoke().gn_cases():
        item = 4 if dtype == "float32" else 2
        out.append((name, shape[0], math.prod(shape[1:-1]), shape[-1], groups, item))
    return out


CASES = _cases()


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_every_shape_gets_one_launch_and_a_route(case, sms) -> None:
    _, b, s, c, g, item = case
    plan = G.gn_plan(b, s, c, g, item, sms=sms)
    assert plan.kernel == "grid" and plan.launches == 1
    assert plan.route in ("on_chip", "streamed")
    chunk = 16 // item
    assert plan.vec == (chunk if c % chunk == 0 else 1)
    # at most one CTA per SM: every CTA resident at once, as the grid barrier needs; each has a slab in the
    # first wave, which is full
    assert 1 <= plan.spw <= b
    assert 1 <= plan.ctas <= min(sms, plan.spw * plan.per_sample)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_slabs_cover_the_rows_once(case, sms) -> None:
    _, b, s, c, g, item = case
    plan = G.gn_plan(b, s, c, g, item, sms=sms)
    spans = [range(k * plan.rows, min(s, (k + 1) * plan.rows)) for k in range(plan.per_sample)]
    assert all(len(span) > 0 for span in spans)  # no empty slab
    assert sorted(i for span in spans for i in span) == list(range(s))
    for s0 in range(0, b, plan.spw):
        units = min(plan.spw, b - s0) * plan.per_sample
        walked = sorted(u for cta in range(plan.ctas) for u in range(cta, units, plan.ctas))
        assert walked == list(range(units))
    # no more slabs than slabs of 8 KB of rows would need
    assert plan.per_sample <= -(-s // -(-8192 // (c * item)))
    assert 0 <= plan.keep <= plan.rows


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_a_cta_fits_shared_memory(case) -> None:
    _, b, s, c, g, item = case
    plan = G.gn_plan(b, s, c, g, item)
    assert plan.smem == G.gn_smem(c, g, plan.vec, item, plan.keep) <= G.GN_SMEM_MAX
    assert plan.keep * c * item <= plan.smem
    if plan.route == "on_chip":
        assert plan.keep == plan.rows and min(plan.spw, b) * plan.per_sample == plan.ctas
    else:
        # streamed: shared memory is full (one more row would not fit), or a CTA has several slabs of a wave
        full = G.gn_smem(c, g, plan.vec, item, plan.keep + 1) > G.GN_SMEM_MAX
        assert full or plan.ctas < min(plan.spw, b) * plan.per_sample


def test_routes_of_the_main_paths() -> None:
    """The txt2img UNet's norms (batch 2) and the VAE decoder's up to 128^2 keep every row on
    chip; the decoder's 512^2 levels are streamed."""
    for name, b, s, c, g, item in CASES:
        route = G.gn_plan(b, s, c, g, item).route
        if name.startswith("vae_b1_512x512"):
            assert route == "streamed", name
        if name.startswith(("unet_b2_", "vae_b1_64x64", "vae_b1_128x128")):
            assert route == "on_chip", name


def test_slabs_yardstick_plan() -> None:
    plan = G.gn_plan(2, 4096, 320, 32, 2, kernel="slabs")
    slabs, rows = G.kernel_plan(2, 4096, 320, 2)
    assert (plan.kernel, plan.launches, plan.per_sample, plan.rows, plan.ctas) == ("slabs", 3, slabs, rows, 2 * slabs)
    assert slabs * rows >= 4096
    with pytest.raises(ValueError):
        G.gn_plan(2, 4096, 320, 32, 2, kernel="nope")


def _emulate(x, w, b, groups, eps, silu, plan, gather_only_first=False):
    """The kernel's arithmetic in f32, from the plan: each slab sums its rows per channel
    (the rows strided by the threads along them, each thread's rows in order), folds the
    channels into groups; after the barrier thread j of a group's JG adds a sample's
    slabs j, j + JG, ... and the JG sums are added in order; then y = x * (rstd w) + (b -
    mean rstd w). `gather_only_first` plants a fault: each thread adds only its first slab."""
    bsz, s, c = x.shape
    cg = c // groups
    _, _, ty_n = G._tiling(c, plan.vec, G.GN_THREADS)
    lanes = G.group_threads(groups)
    y = torch.empty_like(x)
    count = float(s * cg)
    for smp in range(bsz):
        parts = []
        for k in range(plan.per_sample):
            xs = x[smp, k * plan.rows : min(s, (k + 1) * plan.rows)]
            s1 = torch.stack([xs[ty::ty_n].sum(0) for ty in range(ty_n)]).sum(0)
            s2 = torch.stack([xs[ty::ty_n].square().sum(0) for ty in range(ty_n)]).sum(0)
            parts.append((s1.reshape(-1, cg).sum(1), s2.reshape(-1, cg).sum(1)))
        step = plan.per_sample if gather_only_first else lanes
        a = sum(sum(parts[k][0] for k in range(j, plan.per_sample, step)) for j in range(lanes))
        q = sum(sum(parts[k][1] for k in range(j, plan.per_sample, step)) for j in range(lanes))
        mean = a / count
        rstd = torch.rsqrt(torch.clamp(q / count - mean * mean, min=0.0) + eps)
        scale = rstd.repeat_interleave(cg) * w
        shift = b - mean.repeat_interleave(cg) * scale
        out = x[smp] * scale + shift
        y[smp] = out * torch.sigmoid(out) if silu else out
    return y


@pytest.mark.parametrize(
    "shape,groups,item",
    [((2, 300, 96), 32, 2), ((1, 4096, 64), 32, 2), ((3, 37, 36), 4, 2), ((2, 70, 40), 8, 4), ((1, 65536, 16), 4, 2),
     ((2, 4096, 320), 32, 2)],
)
def test_emulated_kernel_matches_the_plain_version(shape, groups, item) -> None:
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen) * 2 + 0.5
    w = 1 + 0.2 * torch.randn(shape[-1], generator=gen)
    b = 0.2 * torch.randn(shape[-1], generator=gen)
    plan = G.gn_plan(shape[0], shape[1], shape[2], groups, item)
    ref = G.group_norm_silu_plain(x, w, b, num_groups=groups, eps=1e-6, apply_silu=True)
    got = _emulate(x, w, b, groups, 1e-6, True, plan)
    assert (got - ref).abs().max().item() <= 2.0**-16 * ref.abs().max().item()
    if plan.per_sample > G.group_threads(groups):
        bad = _emulate(x, w, b, groups, 1e-6, True, plan, gather_only_first=True)
        assert (bad - ref).abs().max().item() > 2.0**-6 * ref.abs().max().item()
