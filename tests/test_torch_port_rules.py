"""Rules the port keeps: it imports no JAX, and its entry points run on the
CUDA card unless the caller asks for another device."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import cflearn_torch
from cflearn_torch.device import resolve_device
from cflearn_torch.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cflearn_tpu")
# the package's sources (`_build/` holds build outputs only and is not part of it), and the scripts
# that drive it on the card
PORT_FILES = sorted(
    p for p in (ROOT / "cflearn_torch").rglob("*.py") if "_build" not in p.relative_to(ROOT).parts
) + [ROOT / "chip_smoke.py"] + [ROOT / "scripts" / f"{name}.py" for name in (
    "profile_torch_txt2img", "ae_parity_runs", "f32_flash_3xtf32", "profiler_event_probe")]


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_files_found() -> None:
    assert len(PORT_FILES) > 20


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path: Path) -> None:
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _imported_at_import(path: Path):
    """The modules a file imports when it is imported: its top-level
    statements, and those inside a top-level `if` / `try`, not function bodies."""
    body = list(ast.parse(path.read_text(), filename=str(path)).body)
    while body:
        node = body.pop()
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, (ast.If, ast.Try)):
            body.extend(node.body + node.orelse + getattr(node, "finalbody", []))
            body.extend(stmt for handler in getattr(node, "handlers", []) for stmt in handler.body)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_transformers_at_import(path: Path) -> None:
    """The tokenizer may look for a `transformers` cache inside a function;
    importing the port never imports it."""
    bad = [m for m in _imported_at_import(path) if m.split(".")[0] == "transformers"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} at import"


def test_serving_modules_are_scanned() -> None:
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in ("cflearn_torch/modules/nlp/tokenizers.py", "cflearn_torch/modules/core/tome.py",
                "cflearn_torch/toolkit/quality.py", "cflearn_torch/losses/__init__.py", "cflearn_torch/losses/lpips.py",
                "cflearn_torch/schedulers.py", "cflearn_torch/api/multimodal/diffusion.py",
                "cflearn_torch/modules/core/lora.py", "cflearn_torch/toolkit/misc.py"):
        assert rel in names


def _no_cuda(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(monkeypatch) -> None:
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_sd_raises_without_cuda(monkeypatch) -> None:
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        cflearn_torch.build_sd("v1")


def _tiny(device=None):
    return cflearn_torch.build(
        cflearn_torch.LDM, device=device, img_size=8, num_timesteps=50,
        condition_model=CLIPTextConditionModel(latent_dim=32, num_layers=1, num_heads=2),
        unet_config=dict(start_channels=32, num_res_blocks=1, channel_multipliers=(1, 2),
                         attention_downsample_rates=(1,), num_heads=4, context_dim=32),
        first_stage_config=dict(img_size=32, inner_channels=32, channel_multipliers=[1, 2],
                                num_res_blocks=1),
    )


def test_build_raises_without_cuda(monkeypatch) -> None:
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        _tiny()


def test_txt2img_runs_on_cpu_when_asked(monkeypatch) -> None:
    _no_cuda(monkeypatch)
    model = _tiny("cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    tokens = np.random.RandomState(0).randint(0, 1000, (1, 77))
    z = np.random.RandomState(1).randn(1, 8, 8, 4).astype(np.float32)
    images = cflearn_torch.txt2img(model, tokens, np.zeros_like(tokens), num_steps=2, z=z)
    assert images.shape == (1, 16, 16, 3) and images.dtype == torch.uint8


def test_kernel_wrappers_refuse_other_devices() -> None:
    from cflearn_torch.ops import attention, conv

    q = torch.empty((1, 1, 256, 64), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        attention.flash_attention(q, q, q)
    x = torch.empty((1, 8, 8, 64), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        conv.conv3x3(x, torch.empty((64, 3, 3, 64), device="meta"))


@pytest.mark.parametrize("name", ["flash_fwd_lse", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"])
def test_training_kernel_wrappers_refuse_other_devices(name) -> None:
    """Only a CPU tensor takes a plain version; any other device launches the
    kernel or raises, and a refused call counts no launch."""
    from cflearn_torch.ops import attention

    fn = getattr(attention, name)
    q = torch.empty((1, 1, 256, 64), device="meta")
    lse = torch.empty((1, 1, 256), device="meta")
    args = (q, q, q) if name == "flash_fwd_lse" else (q, q, q, q, lse, q)
    before = fn.launches
    with pytest.raises(RuntimeError, match="no kernel"):
        fn(*args)
    assert fn.launches == before


def test_conv_wgrad_wrapper_refuses_other_devices_and_dtypes() -> None:
    from cflearn_torch.ops import conv

    x = torch.empty((1, 8, 8, 64), device="meta", dtype=torch.bfloat16)
    before = conv.conv3x3_wgrad.launches
    with pytest.raises(RuntimeError, match="no kernel"):
        conv.conv3x3_wgrad(x, x)
    assert conv.conv3x3_wgrad.launches == before
    # on the CPU the plain version takes any floating dtype, in x's dtype and the kernel's layout
    xc = torch.zeros((1, 4, 4, 8), dtype=torch.float64)
    out = conv.conv3x3_wgrad(xc, torch.zeros((1, 4, 4, 16), dtype=torch.float64))
    assert out.shape == (16, 3, 3, 8) and out.dtype == torch.float64


def test_conv_wgrad_checks_come_before_any_launch(monkeypatch) -> None:
    """What the kernel does not take is refused by the wrapper (dtype, shape,
    channel multiple), not by the library: a CUDA tensor's checks run before
    the kernel is built or loaded."""
    from cflearn_torch.ops import _native, conv

    def no_library(name):
        raise AssertionError(f"library({name!r}) reached")

    monkeypatch.setattr(_native, "library", no_library)

    class OnCard(torch.Tensor):
        """A meta tensor that says it lies on a CUDA card."""

        @property
        def device(self):  # type: ignore[override]
            return torch.device("cuda", 0)

    def card(shape, dtype):
        return torch.empty(shape, device="meta", dtype=dtype).as_subclass(OnCard)

    with pytest.raises(TypeError, match="bf16/fp16"):
        conv.conv3x3_wgrad(card((1, 8, 8, 64), torch.float32), card((1, 8, 8, 64), torch.float32))
    with pytest.raises(TypeError, match="one dtype"):
        conv.conv3x3_wgrad(card((1, 8, 8, 64), torch.bfloat16), card((1, 8, 8, 64), torch.float16))
    with pytest.raises(ValueError, match="dy"):
        conv.conv3x3_wgrad(card((1, 8, 8, 64), torch.bfloat16), card((1, 8, 9, 64), torch.bfloat16))
    with pytest.raises(ValueError, match="% 8"):
        conv.conv3x3_wgrad(card((1, 8, 8, 60), torch.bfloat16), card((1, 8, 8, 64), torch.bfloat16))
    from cflearn_torch.ops import group_norm as gn

    w = card((64,), torch.float32)
    with pytest.raises(TypeError, match="bf16/fp16/f32"):
        gn.group_norm_silu(card((1, 8, 8, 64), torch.float64), w, w)
    with pytest.raises(TypeError, match="bf16/fp16/f32"):
        gn.group_norm_silu(card((1, 8, 8, 64), torch.bfloat16), w, card((64,), torch.bfloat16))
    with pytest.raises(ValueError, match="groups"):
        gn.group_norm_silu(card((1, 8, 8, 64), torch.bfloat16), w, w, num_groups=5)
    with pytest.raises(ValueError, match="x "):
        gn.group_norm_silu(card((1, 8, 8, 64), torch.bfloat16), card((32,), torch.float32), w)


def test_group_norm_wrapper_refuses_other_devices() -> None:
    from cflearn_torch.ops import group_norm as gn

    x = torch.empty((1, 8, 8, 64), device="meta")
    w = torch.empty((64,), device="meta")
    before = gn.group_norm_silu.launches
    with pytest.raises(RuntimeError, match="no kernel"):
        gn.group_norm_silu(x, w, w)
    assert gn.group_norm_silu.launches == before
    # the modules' dispatcher sends only CUDA tensors to the kernel
    xc = torch.randn(1, 4, 4, 32)
    out = gn.module_call(xc, torch.ones(32), torch.zeros(32), num_groups=8, eps=1e-6)
    assert out.shape == xc.shape and gn.group_norm_silu.launches == before


def test_conv3x3_needs_no_function_on_the_cpu() -> None:
    """On a CPU tensor `conv3x3` is the plain version and autograd runs
    through it; `Conv3x3Function` launches kernels and refuses the CPU."""
    from cflearn_torch.ops import conv

    x = torch.randn(1, 4, 4, 8, requires_grad=True)
    w = torch.randn(8, 3, 3, 8, requires_grad=True)
    conv.conv3x3(x, w).sum().backward()
    assert x.grad is not None and w.grad is not None
    with pytest.raises(RuntimeError, match="no kernel"):
        conv.Conv3x3Function.apply(x, w, None)


def test_train_autoencoder_raises_without_cuda(monkeypatch) -> None:
    _no_cuda(monkeypatch)
    config = dict(img_size=16, inner_channels=32, channel_multipliers=[1, 2], num_res_blocks=1, use_perceptual=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cflearn_torch.build_ae(config)
    model = cflearn_torch.build_ae(config, device="cpu")
    assert all(p.device.type == "cpu" and p.dtype == torch.float32 for p in model.parameters())
    images = np.random.RandomState(0).randn(2, 16, 16, 3).astype(np.float32).clip(-1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        cflearn_torch.train_autoencoder(model, images)
    out = cflearn_torch.train_autoencoder(model, images, num_steps=2, device="cpu")
    assert len(out["losses"]) == 2
    for losses in out["losses"]:
        assert set(losses) == {"core_loss", "core_l1", "core_kl", "core_g", "discriminator_loss", "discriminator_d"}
        assert all(torch.isfinite(v) for v in losses.values())
    # the same seed gives the same steps: the posterior noise comes from the generator
    again = cflearn_torch.train_autoencoder(
        cflearn_torch.build_ae(config, device="cpu"), images, num_steps=2, device="cpu"
    )
    assert all(torch.equal(a[k], b[k]) for a, b in zip(out["losses"], again["losses"]) for k in a)


def test_finetune_unet_raises_without_cuda(monkeypatch) -> None:
    _no_cuda(monkeypatch)
    model = cflearn_torch.build(
        cflearn_torch.DDPM, device="cpu", img_size=8, num_timesteps=50,
        unet_config=dict(start_channels=32, num_res_blocks=1, channel_multipliers=(1, 2),
                         attention_downsample_rates=(1,), num_heads=4, context_dim=32),
    )
    x0 = np.random.RandomState(0).randn(1, 8, 8, 4).astype(np.float32)
    cond = np.random.RandomState(1).randn(1, 5, 32).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        cflearn_torch.finetune_unet(model, x0, cond)
    out = cflearn_torch.finetune_unet(model, x0, cond, num_steps=1, device="cpu")
    assert torch.isfinite(out["losses"]).all()


def test_w8a8_and_fold_wrappers_refuse_other_devices() -> None:
    from cflearn_torch.ops import conv

    x = torch.empty((1, 8, 8, 64), device="meta", dtype=torch.bfloat16)
    w = torch.empty((64, 3, 3, 64), device="meta", dtype=torch.bfloat16)
    before = conv.conv3x3_w8a8.launches, conv.conv3x3_fold.launches
    with pytest.raises(RuntimeError, match="no kernel"):
        conv.conv3x3_w8a8(x, w)
    with pytest.raises(RuntimeError, match="no kernel"):
        conv.conv3x3(x, w, fold=True)
    assert (conv.conv3x3_w8a8.launches, conv.conv3x3_fold.launches) == before


def test_w8a8_checks_come_before_any_launch(monkeypatch) -> None:
    """What the int8 kernel does not take is refused by the wrapper: the
    channel multiple of 16, the output dtype, the scale, a C whose int32 sums
    could overflow, and inputs that need a gradient."""
    from cflearn_torch.ops import _native, conv

    def no_library(name):
        raise AssertionError(f"library({name!r}) reached")

    monkeypatch.setattr(_native, "library", no_library)

    class OnCard(torch.Tensor):
        @property
        def device(self):  # type: ignore[override]
            return torch.device("cuda", 0)

    def card(shape, dtype):
        return torch.empty(shape, device="meta", dtype=dtype).as_subclass(OnCard)

    i8, f32, bf16 = torch.int8, torch.float32, torch.bfloat16
    with pytest.raises(ValueError, match="% 16"):
        conv.conv3x3_int8(card((1, 8, 8, 72), i8), card((64, 3, 3, 72), i8), card((64,), f32), None, bf16)
    with pytest.raises(TypeError, match="bf16/fp16"):
        conv.conv3x3_int8(card((1, 8, 8, 64), i8), card((64, 3, 3, 64), i8), card((64,), f32), None, f32)
    with pytest.raises(TypeError, match="one dtype"):
        conv.conv3x3_int8(card((1, 8, 8, 64), bf16), card((64, 3, 3, 64), i8), card((64,), f32), None, bf16)
    with pytest.raises(ValueError, match="scale"):
        conv.conv3x3_int8(card((1, 8, 8, 64), i8), card((64, 3, 3, 64), i8), card((32,), f32), None, bf16)
    big = conv.W8A8_MAX_C + 16 - conv.W8A8_MAX_C % 16
    with pytest.raises(ValueError, match="int32"):
        conv.conv3x3_int8(card((1, 2, 2, big), i8), card((8, 3, 3, big), i8), card((8,), f32), None, bf16)
    assert 127 * 127 * 9 * conv.W8A8_MAX_C < 2**31 <= 127 * 127 * 9 * (conv.W8A8_MAX_C + 1)
    with pytest.raises(RuntimeError, match="gradient"):
        conv.conv3x3_w8a8(card((1, 8, 8, 64), bf16), card((64, 3, 3, 64), bf16).requires_grad_())
    with pytest.raises(ValueError, match="% 8"):
        conv.conv3x3_fold(card((1, 8, 8, 60), bf16), card((64, 3, 3, 60), bf16))


def test_device_batcher_defaults_to_the_card(monkeypatch) -> None:
    """`DeviceBatcher(loader)` and its reference alias `TensorBatcher` put
    batches on the card, as the JAX batcher puts them on the default
    device: without CUDA they raise; `device="cpu"` works."""
    from cflearn_torch.data import ArrayData

    _no_cuda(monkeypatch)
    x = np.arange(12, dtype=np.float64).reshape(6, 2)
    loader = ArrayData.init().fit(x, x[:, :1]).get_loaders()[0]
    for batcher in (cflearn_torch.DeviceBatcher, cflearn_torch.TensorBatcher):
        with pytest.raises(RuntimeError, match="CUDA"):
            batcher(loader)
        batches = list(batcher(loader, device="cpu"))
        assert batches and all(b["input"].device.type == "cpu" and b["input"].dtype == torch.float32 for b in batches)


def test_launch_counts_lose_nothing_across_threads() -> None:
    """`_native.count_launch` is what every wrapper bumps its counter
    through: 16 threads, more than the cores, each adding 2,000 with the
    interpreter switching threads every microsecond, lose no count."""
    import sys
    import threading
    from types import SimpleNamespace

    from cflearn_torch.ops import _native

    counter = SimpleNamespace(launches=0)
    threads = [threading.Thread(target=lambda: [_native.count_launch(counter) for _ in range(2000)])
               for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and counter.launches == 16 * 2000
