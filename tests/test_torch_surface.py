"""The port's public surface against the JAX package's, `__init__.py` by
`__init__.py`: every public name of each `cflearn_tpu/**/__init__.py`
(read by AST: imported names, assigned aliases, definitions) exists in the
port's counterpart module, as an attribute or an importable submodule.

Two explicit lists say where a name may be absent:
- `RENAMES`: JAX-only names, present in the port under a PyTorch name and
  absent under the JAX one;
- `WAITING`: the names of modules not ported yet. A waiting name that the
  port has fails, so the list only shrinks; `WAITING_PACKAGES` are whole
  packages the port does not have yet. Both are empty now: the port has
  every module of the JAX package (the last ones were LaMa, ISNet, iharm,
  BLIP, the GPT-2 prompt API and ChineseCLIP), so only `RENAMES` may be
  absent.

No JAX is imported: the JAX package is read as source."""

import ast
import importlib
from pathlib import Path

import pytest

JAX_ROOT = Path(__file__).resolve().parent.parent / "cflearn_tpu"
# each JAX package by its dotted path under `cflearn_tpu` ("." for the top level)
INITS = sorted(str(p.parent.relative_to(JAX_ROOT)).replace("/", ".") for p in JAX_ROOT.rglob("__init__.py"))

# package -> {JAX name: the port's name}
RENAMES = {
    "toolkit": {
        "np_batch_to_jax": "np_batch_to_tensor",
        "jax_batch_to_np": "tensor_batch_to_np",
        "to_jax_dtype": "to_device_dtype",
        "new_rng_key": "new_generator",
    },
}
# package -> the names waiting for their modules (none: every module is ported)
WAITING: dict = {}
# packages of the waiting list that the port does not have at all
WAITING_PACKAGES: set = set()


def public_names(init: Path) -> set:
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_") and n != "*"}


def port_module_name(package: str) -> str:
    return "cflearn_torch" if package == "." else f"cflearn_torch.{package}"


def has(module, name: str) -> bool:
    """`from <module> import <name>` works: an attribute or a submodule."""
    if hasattr(module, name):
        return True
    try:
        importlib.import_module(f"{module.__name__}.{name}")
    except ModuleNotFoundError:
        return False
    return True


@pytest.mark.parametrize("package", INITS)
def test_every_public_name_of_the_jax_init_exists_in_the_port(package):
    names = public_names(JAX_ROOT.joinpath(*package.split(".")) / "__init__.py")  # "." splits into nothing
    renames, waiting = RENAMES.get(package, {}), WAITING.get(package, set())
    # the lists name only what the JAX package exports
    assert set(renames) <= names and waiting <= names
    if package in WAITING_PACKAGES:
        assert names <= waiting, sorted(names - waiting)
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(port_module_name(package))
        return
    port = importlib.import_module(port_module_name(package))
    missing = sorted(n for n in names - set(renames) - waiting if not has(port, n))
    assert not missing, f"{port.__name__} lacks {missing}"
    renamed = {old: new for old, new in renames.items() if has(port, old) or not has(port, new)}
    assert not renamed, f"{port.__name__}: a JAX name present, or its PyTorch name absent: {renamed}"
    arrived = sorted(n for n in waiting if has(port, n))
    assert not arrived, f"{port.__name__} has {arrived}: take them off the waiting list"


def test_the_lists_name_existing_packages():
    assert set(RENAMES) | set(WAITING) <= set(INITS)
    assert WAITING_PACKAGES <= set(WAITING)
