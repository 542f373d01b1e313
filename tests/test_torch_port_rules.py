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
PORT_FILES = sorted((ROOT / "cflearn_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
