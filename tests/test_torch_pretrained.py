"""Pretrained weights from local files, held to the JAX package on the CPU:
`OPT` (defaults, the environment's JSON, `update`, `opt_context`, and the
settings that follow it: the SD weights pool's limit and the tokenizer's
merges file), the download cache (a cache hit under a recorded sha, a
first-use pin and a changed byte, a `sha_prefix` miss, a short file, a
`file://` fetch: the same outcomes on the same files in both packages), the
checkpoint reader (the `.safetensors` reader against the `safetensors`
package in f32, f16, bf16 and int64; a `.ckpt` with a `"state_dict"`),
`load_module("sr/esr.anime", pretrained=True)` end to end at its real width
from a seeded upstream-layout file (both packages' outputs on a 32² image
within 1e-5 of max|JAX|, f32 summation order; the second load from the
converted cache), the refusals of both packages (a cflearn-layout entry
and `hed` under their recorded shas, an empty cache, whose message names
the path where the file goes) and the captured-input check of
`aot_compile` on CPU tensors, beside a JAX `Compiled`'s refusal.

Both packages get their caches under `tmp_path` through their own `OPT`.
`urllib.request.urlretrieve` is patched to refuse every URL but `file://`
ones, so no test reaches for the network, and the download retries do not
sleep. Inputs and weights are drawn by numpy from a seed."""

import gzip
import hashlib
import json
import os
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge_common  # noqa: F401  (one intra-op thread; the fetch guard)
import cflearn_torch
import cflearn_tpu.zoo.common as JZ
from cflearn_torch.api.common import APIPool
from cflearn_torch.api.cv import annotator as TA
from cflearn_torch.modules.nlp.tokenizers import CLIPTokenizer
from cflearn_torch.ops.graphs import check_inputs
from cflearn_torch.parameters import OPT as TOPT
from cflearn_torch.parameters import OPTClass as TOPTClass
from cflearn_torch.toolkit import misc as TM
from cflearn_torch.zoo import common as TZ
from cflearn_torch.zoo import convert as TC
from cflearn_tpu.api.common import APIPool as JAPIPool
from cflearn_tpu.api.cv import annotator as JA
from cflearn_tpu.modules.nlp.tokenizers import CLIPTokenizer as JCLIPTokenizer
from cflearn_tpu.parameters import OPT as JOPT
from cflearn_tpu.parameters import OPTClass as JOPTClass
from cflearn_tpu.toolkit import misc as JM
from cflearn_tpu.zoo import convert as JC

URL = "https://checkpoints.invalid/weights.bin"


@pytest.fixture
def offline(monkeypatch):
    """The URLs asked for; every fetch but a `file://` one refused, no retry sleeping."""
    tried = []
    fetch = urllib.request.urlretrieve

    def guarded(url, *args, **kwargs):
        tried.append(url)
        if not str(url).startswith("file://"):
            raise OSError(f"refused in the tests: {url}")
        return fetch(url, *args, **kwargs)

    monkeypatch.setattr(urllib.request, "urlretrieve", guarded)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    return tried


@pytest.fixture
def caches(tmp_path, offline):
    """Both packages' `OPT.cache_dir` under `tmp_path`; their download folders."""
    TM._verified_downloads.clear()
    JM._verified_downloads.clear()
    with TOPT.opt_context({"cache_dir": str(tmp_path / "port")}), JOPT.opt_context({"cache_dir": str(tmp_path / "jax")}):
        yield {"port": TM.get_download_cache_dir(), "jax": JM.get_download_cache_dir()}


# ---------------------------------------------------------------- OPT


@pytest.mark.parametrize("side", ["port", "jax"])
def test_opt_defaults_env_update_and_context(side, monkeypatch, tmp_path) -> None:
    cls, name = (TOPTClass, "cflearn_torch") if side == "port" else (JOPTClass, "cflearn_tpu")
    monkeypatch.delenv(cls.env_key, raising=False)
    opt = cls()
    home = os.path.join(str(Path.home()), ".cache", name)
    assert (opt.cache_dir, opt.sd_weights_pool_limit) == (home, -1)
    assert opt.cache_dir_path == Path(home)
    with pytest.raises(AttributeError):
        opt.no_such_setting
    monkeypatch.setenv(cls.env_key, json.dumps({"cache_dir": str(tmp_path), "sd_weights_pool_limit": 3}))
    opt = cls()
    assert (opt.cache_dir, opt.sd_weights_pool_limit) == (str(tmp_path), 3)
    monkeypatch.setenv(cls.env_key, "{not json")
    assert cls().cache_dir == home  # a malformed environment JSON is ignored
    opt.update(sd_weights_pool_limit=5)
    with opt.opt_context({"sd_weights_pool_limit": 1, "cache_dir": str(tmp_path / "inner")}):
        assert (opt.sd_weights_pool_limit, opt.cache_dir) == (1, str(tmp_path / "inner"))
    assert (opt.sd_weights_pool_limit, opt.cache_dir) == (5, str(tmp_path))
    assert TOPTClass.env_key == "CFLEARN_TORCH_ENV"


def test_pool_limit_and_merges_follow_opt(tmp_path) -> None:
    merges = ["#version: 0.2", "a b", "ab c", "h e", "he llo"]
    for sub in ("port", "jax"):
        (tmp_path / sub).mkdir()
        with gzip.open(tmp_path / sub / "bpe_simple_vocab_16e6.txt.gz", "wt", encoding="utf-8") as f:
            f.write("\n".join(merges) + "\n")
    with TOPT.opt_context({"cache_dir": str(tmp_path / "port"), "sd_weights_pool_limit": 2}), \
            JOPT.opt_context({"cache_dir": str(tmp_path / "jax"), "sd_weights_pool_limit": 2}):
        assert APIPool().limit == JAPIPool().limit == 2
        got = CLIPTokenizer._load_merges(None)
        assert got == JCLIPTokenizer._load_merges(None) == [tuple(m.split()) for m in merges[1:]]
    assert APIPool().limit == JAPIPool().limit == -1


# ---------------------------------------------------------------- the download cache


def _outcome(fn):
    try:
        return ("ok", Path(fn()).read_bytes())
    except OSError as e:
        return ("OSError", "fetch" if "failed to download" in str(e) else str(e).split(" ")[-1])


def _scenario(case, folder: Path, src: Path, download, verified):
    """The outcomes of one scenario of `download` calls in `folder`."""
    blob = b"x" * 1000
    path = folder / "weights.bin"
    folder.mkdir(parents=True, exist_ok=True)
    steps = []
    if case == "recorded_sha_hit":
        path.write_bytes(blob)
        sha = hashlib.sha256(blob).hexdigest()
        steps += [_outcome(lambda: download(URL, folder=str(folder), sha=sha)) for _ in range(2)]
        path.write_bytes(blob[:-1] + b"y")
        verified.clear()
        steps.append(_outcome(lambda: download(URL, folder=str(folder), sha=sha)))
    elif case == "pin_then_changed_byte":
        path.write_bytes(blob)
        steps.append(_outcome(lambda: download(URL, folder=str(folder))))
        steps.append(json.loads((folder / ".sha256.json").read_text()))
        path.write_bytes(blob[:500] + b"y" + blob[501:])
        steps.append(_outcome(lambda: download(URL, folder=str(folder))))  # verified once a process: served
        verified.clear()
        steps.append(_outcome(lambda: download(URL, folder=str(folder))))
    elif case == "sha_prefix_miss":
        path.write_bytes(blob)
        digest = hashlib.sha256(blob).hexdigest()
        steps.append(_outcome(lambda: download(URL, folder=str(folder), sha_prefix="0" * 8 if digest[0] != "0" else "f" * 8)))
        steps.append(_outcome(lambda: download(URL, folder=str(folder), sha_prefix=digest[:8])))
    elif case == "short_file":
        path.write_bytes(blob)
        steps.append(_outcome(lambda: download(URL, folder=str(folder), min_size=2000)))
        steps.append(_outcome(lambda: download(URL, folder=str(folder), min_size=500)))
    elif case == "file_url_fetch":
        src.write_bytes(b"first download")
        url = f"file://{src}"
        steps.append(_outcome(lambda: download(url, folder=str(folder))))
        steps.append(json.loads((folder / ".sha256.json").read_text()))
        (folder / src.name).write_bytes(b"corrupted")
        verified.clear()
        steps.append(_outcome(lambda: download(url, folder=str(folder))))  # fetched again, the pin holds
        src.write_bytes(b"upstream changed")
        (folder / src.name).write_bytes(b"corrupted again")
        verified.clear()
        steps.append(_outcome(lambda: download(url, folder=str(folder))))
    elif case == "missing":
        steps.append(_outcome(lambda: download(URL, folder=str(folder), sha="0" * 64)))
    return steps


@pytest.mark.parametrize(
    "case", ["recorded_sha_hit", "pin_then_changed_byte", "sha_prefix_miss", "short_file", "file_url_fetch", "missing"]
)
def test_download_outcomes_match_jax(case, tmp_path, offline) -> None:
    got = {}
    for side, download, verified in (("port", TM.download, TM._verified_downloads),
                                      ("jax", JM.download, JM._verified_downloads)):
        verified.clear()
        got[side] = _scenario(case, tmp_path / side / "cache", tmp_path / side / f"src_{case}.bin", download, verified)
    assert got["port"] == got["jax"]
    expected_fail = {"recorded_sha_hit": 1, "pin_then_changed_byte": 1, "sha_prefix_miss": 1, "short_file": 1,
                     "file_url_fetch": 1, "missing": 1}[case]
    assert sum(1 for s in got["port"] if isinstance(s, tuple) and s[0] == "OSError") == expected_fail
    # a refused fetch is the only network the calls reach for, and only for a file that fails its checks
    assert all(u == URL or u.startswith("file://") for u in offline)


def test_download_json_and_the_path_in_the_message(tmp_path, offline) -> None:
    folder = tmp_path / "cache"
    src = tmp_path / "settings.json"
    src.write_text(json.dumps({"a": 1}))
    assert TM.download_json(f"file://{src}", folder=str(folder)) == JM.download_json(
        f"file://{src}", folder=str(tmp_path / "jcache")) == {"a": 1}
    with pytest.raises(OSError, match=f"put the file at {folder / 'weights.bin'}"):
        TM.download(URL, folder=str(folder))


# ---------------------------------------------------------------- reading checkpoints


def _arrays(dtype: str, seed: int):
    rng = np.random.default_rng(seed)
    if dtype == "int64":
        return {"w": torch.from_numpy(rng.integers(-9, 9, (3, 4))), "b": torch.from_numpy(rng.integers(0, 5, (7,)))}
    out = {"w": rng.standard_normal((3, 4, 2)), "b": rng.standard_normal((5,)), "s": np.array(rng.standard_normal())}
    return {k: torch.from_numpy(v.astype(np.float32)).to(getattr(torch, dtype)) for k, v in out.items()}


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16", "int64"])
def test_safetensors_reader_matches_the_package(dtype, tmp_path) -> None:
    st = pytest.importorskip("safetensors.torch")
    tensors = _arrays(dtype, seed=3)
    st.save_file(tensors, str(tmp_path / "lib.safetensors"))
    got = TC.read_safetensors(tmp_path / "lib.safetensors")
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    # one mapping of the file: the tensors are views of one storage, not copies
    assert len({t.untyped_storage().data_ptr() for t in got.values() if t.numel()}) == 1
    TC.write_safetensors(tmp_path / "port.safetensors", tensors)
    back = st.load_file(str(tmp_path / "port.safetensors"))
    assert all(back[k].dtype == t.dtype and torch.equal(back[k], t) for k, t in tensors.items())
    assert TC.load_torch_state_dict(str(tmp_path / "port.safetensors")).keys() == tensors.keys()


def test_ckpt_state_dict_is_unwrapped_as_in_jax(tmp_path) -> None:
    tensors = _arrays("float32", seed=4)
    torch.save({"state_dict": tensors, "epoch": 3}, tmp_path / "model.ckpt")
    got = TC.load_torch_state_dict(tmp_path / "model.ckpt")
    ref = JC.load_torch_state_dict(str(tmp_path / "model.ckpt"))
    assert set(got) == set(ref) == set(tensors)
    assert all(np.array_equal(got[k].numpy(), ref[k]) for k in tensors)


# ---------------------------------------------------------------- one entry end to end, at its real width


def _seeded_upstream(module, mapping, seed: int):
    """A seeded upstream-layout state dict for `module`'s parameters (numpy: N(0, 1 / fan_in), 1-D N(0, 0.1^2))."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, p in module.named_parameters():
        shape = tuple(p.shape)
        std = 0.1 if len(shape) == 1 else float(np.prod(shape[1:])) ** -0.5
        params[name] = torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))
    return TC.invert(mapping, params)


def test_esr_anime_from_the_cache_matches_jax(caches) -> None:
    meta = cflearn_torch.zoo.esr_anime(device="meta")
    upstream = _seeded_upstream(meta, TC.build_esrgan_mapping(num_blocks=6), seed=5)
    entry = TZ.get_available()["checkpoints"]["esr_anime"]
    name = entry["url"].split("/")[-1]
    for folder in caches.values():
        torch.save(upstream, folder / name)
    size = (caches["port"] / name).stat().st_size
    assert size > entry["min_size"] and len(upstream) == 2 * (1 + 6 * 15 + 5)
    tm = TZ.load_module("sr/esr.anime", pretrained=True, device="cpu")
    jm = JZ.load_module("sr/esr.anime", pretrained=True)
    x = np.random.default_rng(6).random((1, 32, 32, 3), dtype=np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    ref = np.asarray(jm(jnp.asarray(x)))
    assert got.shape == ref.shape == (1, 128, 128, 3)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    params = dict(tm.named_parameters())
    assert all(torch.equal(params[name], upstream[key]) for key, name, _ in TC.build_esrgan_mapping(num_blocks=6))
    # the second load comes from the converted cache: neither the file nor the converter is read again
    assert TZ.converted_cache_path("esr_anime").is_file()
    calls = []
    saved = TC.load_torch_state_dict
    TC.load_torch_state_dict = lambda *a: calls.append(a) or saved(*a)
    try:
        again = TZ.load_module("sr/esr.anime", pretrained=True, device="cpu")
    finally:
        TC.load_torch_state_dict = saved
    assert not calls and all(torch.equal(a, b) for a, b in zip(tm.parameters(), again.parameters()))
    assert json.loads((caches["port"] / ".sha256.json").read_text())[name] == TM.compute_sha(str(caches["port"] / name))


# ---------------------------------------------------------------- refusals, on both sides


def test_recorded_shas_refuse_synthetic_files(caches, offline) -> None:
    """A cflearn-layout entry and `hed` hold their files to the recorded sha: a synthetic file under the name
    is fetched again, which fails here, in both packages (the JAX test routes the same entry the same way)."""
    index = TZ.get_available()["checkpoints"]
    for tag in ("cflearn_esr_anime", "hed"):
        name = index[tag]["url"].split("/")[-1]
        for folder in caches.values():
            torch.save({"w": torch.zeros(2)}, folder / name)
    with pytest.raises(OSError, match="put the file at"):
        TZ.load_states("cflearn_esr_anime")
    with pytest.raises(OSError):
        JZ.load_states("cflearn_esr_anime", None)
    with pytest.raises(OSError, match="put the file at"):
        TA._resolve_annotator_ckpt(None, True, "hed")
    with pytest.raises(OSError):
        JA._resolve_annotator_ckpt(None, True, "hed")
    with pytest.raises(OSError, match="ControlNetHED.pth"):
        TA.Annotator.make("softedge", {"pretrained": True, "device": "cpu"})
    assert set(offline) == {index["cflearn_esr_anime"]["url"], index["hed"]["url"]}


def test_an_empty_cache_names_the_path(caches, offline) -> None:
    path = caches["port"] / "v1-5-pruned-emaonly.safetensors"
    with pytest.raises(OSError, match=f"put the file at {path}"):
        cflearn_torch.zoo.load_sd("v1", pretrained=True, device="cpu")
    with pytest.raises(OSError):
        JZ.load_states("sd_v1.5", "sd")
    with pytest.raises(OSError, match=str(caches["port"] / "RealESRGAN_x4plus.pth")):
        cflearn_torch.TranslatorAPI.from_esr(pretrained=True, device="cpu")
    with pytest.raises(ValueError, match="not 'meta'"):
        cflearn_torch.zoo.load_control_net("depth", pretrained=True, device="meta")
    with pytest.raises(ValueError, match="no pretrained ControlNet"):
        cflearn_torch.zoo.load_control_net("scribble", pretrained=True, device="cpu")
    assert not list(caches["port"].iterdir()) and len(offline) == 6  # two attempts a fetch


# ---------------------------------------------------------------- aot_compile's captured inputs


def test_captured_inputs_are_checked() -> None:
    static = {"x": torch.zeros(4, 3), "cond": {"a": torch.zeros(2, dtype=torch.long)}}
    check_inputs(static, {"x": torch.ones(4, 3), "cond": {"a": torch.ones(2, dtype=torch.long)}})
    with pytest.raises(TypeError, match=r"'x': captured for shape \(4, 3\) and dtype torch.float32, given shape \(1, 3\)"):
        check_inputs(static, {"x": torch.ones(1, 3)})
    with pytest.raises(TypeError, match=r"'x': .* given shape \(4, 3\) and dtype torch.float16"):
        check_inputs(static, {"x": torch.ones(4, 3, dtype=torch.float16)})
    with pytest.raises(TypeError, match=r"'cond.a'"):
        check_inputs(static, {"cond": {"a": torch.ones(2)}})
    with pytest.raises(TypeError, match="captured a dict"):
        check_inputs(static, {"cond": {"b": torch.ones(2, dtype=torch.long)}})
    with pytest.raises(TypeError, match="was not captured"):
        check_inputs(static, {"y": torch.ones(4, 3)})


def test_aot_compile_refuses_another_batch_as_jax_does() -> None:
    m = cflearn_torch.IDLModel.from_config(cflearn_torch.DLConfig(
        model="common", module_name="clf", loss_name="cross_entropy", module_config=dict(
            img_size=16, in_channels=3, num_classes=5, encoder="vit", latent_dim=16,
            encoder_config=dict(patch_size=4, num_layers=1, num_heads=2))), device="cpu")
    x = np.random.default_rng(7).random((4, 16, 16, 3), dtype=np.float32)
    compiled = cflearn_torch.aot_compile(m, {"input": torch.from_numpy(x)})
    assert compiled({"input": torch.from_numpy(x)})["predictions"].shape == (4, 5)
    for bad in (x[:1], x.astype(np.float64)):
        with pytest.raises(TypeError, match="captured for shape"):
            compiled({"input": torch.from_numpy(bad)})
    # the JAX package's `aot_compile` is `jax.jit(...).lower(...).compile()`: its `Compiled` refuses the same
    fn = jax.jit(lambda a: a.sum(axis=1)).lower(jnp.asarray(x)).compile()
    for bad in (x[:1], x.astype(np.float16)):
        with pytest.raises(TypeError):
            fn(jnp.asarray(bad))


# ---------------------------------------------------------------- LPIPS from the download cache


def test_lpips_auto_loads_what_the_cache_holds(caches, monkeypatch) -> None:
    """`LPIPSLoss("auto")` loads the VGG16 tower and the lin heads when both are in the download cache (no
    warning), as `load_lpips(pretrained=True)` does in both packages (the distances of nets loaded from the same
    files agree with the JAX package's in `tests/test_torch_ae_defaults.py`). The index's `lpips` entry records the sha of the real file, which a
    synthetic one cannot match: both packages' indexes drop it here, and the real sha refuses the file
    (`test_recorded_shas_refuse_synthetic_files` shows that refusal for other entries)."""
    from cflearn_torch.losses.lpips import LPIPS, VGG16_CFG, VGG16_TORCH_CONV_IDS, LPIPSLoss, load_lpips
    from cflearn_tpu.losses import lpips as JL

    rng = np.random.default_rng(14)
    vgg, ch = {}, 3
    for ti, co in zip(VGG16_TORCH_CONV_IDS, [c for c in VGG16_CFG if c != "M"]):
        vgg[f"features.{ti}.weight"] = torch.from_numpy((rng.standard_normal((co, ch, 3, 3)) * (2.0 / (9 * ch)) ** 0.5).astype(np.float32))
        vgg[f"features.{ti}.bias"] = torch.from_numpy((rng.standard_normal(co) * 0.1).astype(np.float32))
        ch = co
    lins = {f"lin{i}.model.1.weight": torch.from_numpy(np.abs(rng.standard_normal((1, c, 1, 1))).astype(np.float32) * 0.1)
            for i, c in enumerate(LPIPS.feature_channels)}
    index = json.loads(TZ.AVAILABLE_FILE.read_text())
    index["checkpoints"]["lpips"]["sha"] = None
    monkeypatch.setattr(TZ, "get_available", lambda: index)
    monkeypatch.setattr(JZ, "get_available", lambda: index)
    with pytest.warns(UserWarning, match="neither given nor in the download cache"):
        LPIPSLoss()
    for folder in caches.values():
        torch.save(vgg, folder / "vgg16-397923af.pth")
        torch.save(lins, folder / "lpips.pt")
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        auto = LPIPSLoss()
    ref = load_lpips(pretrained=True)
    assert all(torch.equal(a, b) for a, b in zip(auto.net.parameters(), ref.parameters()))
    assert torch.equal(auto.net.vgg.convs[0].weight, vgg["features.0.weight"])
    # the JAX package reads the same cache entries: its tower's first conv and last head are the files' (HWIO)
    jl = JL.load_lpips(pretrained=True)
    assert np.array_equal(np.asarray(jl.vgg.convs[0].kernel[...]), vgg["features.0.weight"].numpy().transpose(2, 3, 1, 0))
    assert np.array_equal(np.asarray(jl.lins[4].kernel[...]), lins["lin4.model.1.weight"].numpy().transpose(2, 3, 1, 0))
