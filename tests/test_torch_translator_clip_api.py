"""The CLIP and ESRGAN APIs in the port against the JAX package's, on the CPU
at tiny widths: `RRDBNet` (f32, 1e-5 of max|ref|); `TranslatorAPI.sr` on
RGB, RGBA, float and path inputs, in f32 and with bf16 weights;
`CLIPExtractor` on uint8, [0, 1], [-1, 1] and PIL inputs, texts, paths and
a folder, and its zero-shot classes; `clip_score`; `read_image`; the path
and PIL inputs of `DiffusionAPI` against the same calls on arrays; `IAPI`'s
precision and offloading, `APIPool` and `Weights`.

uint8 outputs (the host's `(clip(out, 0, 1) * 255).round()`, half to even in
both) may differ by one level where the f32 result sits on a rounding
boundary: at most one level, on at most 1% of the values. Embeddings within
1e-5 of max|ref|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from PIL import Image

import cflearn_torch
from _torch_api_common import image as smooth_image
from _torch_api_common import mask as centre_mask
from _torch_bridge_common import bridged, rel_err
from cflearn_torch.api import APIPool, CLIPExtractor, IAPI, TranslatorAPI, Weights
from cflearn_torch.api.multimodal import diffusion as TD
from cflearn_torch.api.multimodal import utils as TU
from cflearn_torch.modules.cv.classifier import RRDBNet as TRRDBNet
from cflearn_torch.modules.multimodal.clip import CLIP as TCLIP
from cflearn_torch.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel as TCLIPText
from cflearn_torch.toolkit import quality as TQ
from cflearn_tpu.api.cv.translator import TranslatorAPI as JTranslatorAPI
from cflearn_tpu.api.multimodal import utils as JU
from cflearn_tpu.api.multimodal.clip import CLIPExtractor as JCLIPExtractor
from cflearn_tpu.modules.cv.classifier import RRDBNet
from cflearn_tpu.modules.multimodal.clip import CLIP
from cflearn_tpu.toolkit import quality as JQ

TOL = 1e-5
MAX_SHARE = 0.01
RRDB = dict(latent_channels=16, growth_channels=8, num_blocks=2)
TINY_CLIP = dict(
    img_size=32, latent_dim=24, vision_latent_dim=32, vision_patch_size=8, vision_num_layers=2, vision_num_heads=2,
    vocab_size=600, context_length=77, text_latent_dim=32, text_num_layers=2, text_num_heads=2,
)
TEXTS = ["a photo of a cat", "a red car", "two dogs"]


def _uint8(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def _close_uint8(got, ref) -> None:
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= MAX_SHARE, (diff.max(), (diff > 0).mean())


# ---- ESRGAN ----


@pytest.fixture(scope="module")
def rrdb():
    jm = RRDBNet(rngs=nnx.Rngs(0), **RRDB)
    return jm, bridged(jm, cflearn_torch.build(TRRDBNet, device="cpu", **RRDB))


def test_rrdbnet(rrdb) -> None:
    jm, tm = rrdb
    x = np.random.RandomState(1).rand(2, 8, 8, 3).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 32, 32, 3)
    assert rel_err(got, nnx.jit(lambda m, v: m(v))(jm, jnp.asarray(x))) < TOL


@pytest.fixture(scope="module")
def translators(rrdb):
    jm, tm = rrdb
    return JTranslatorAPI(jm), TranslatorAPI(tm, device="cpu")


@pytest.mark.parametrize("kind", ["rgb", "rgba", "float_batch"])
def test_sr(translators, kind) -> None:
    japi, tapi = translators
    if kind == "rgb":
        x = _uint8(2, (8, 8, 3))
    elif kind == "rgba":
        x = np.concatenate([_uint8(3, (8, 8, 3)), _uint8(4, (8, 8, 1))], axis=-1)
    else:
        x = np.random.RandomState(5).rand(2, 8, 8, 3).astype(np.float32)
    got, ref = tapi.sr(x), japi.sr(x)
    _close_uint8(got, ref)
    assert got.shape == ((2,) if kind == "float_batch" else ()) + (32, 32, 4 if kind == "rgba" else 3)


def test_sr_with_bf16_weights(rrdb) -> None:
    """`use_bf16` casts the weights only: the f32 image meets bf16-rounded weights in f32, as in the JAX package."""
    jm, tm = rrdb
    japi = JTranslatorAPI(nnx.clone(jm), use_bf16=True)
    tapi = TranslatorAPI(bridged(jm, cflearn_torch.build(TRRDBNet, device="cpu", **RRDB)), use_bf16=True, device="cpu")
    assert tapi.dtype == torch.bfloat16 and all(p.dtype == torch.bfloat16 for p in tapi.m.parameters())
    x = _uint8(6, (8, 8, 3))
    _close_uint8(tapi.sr(x), japi.sr(x))


def test_sr_paths_export_and_limits(translators, tmp_path) -> None:
    japi, tapi = translators
    rgba = np.concatenate([_uint8(7, (8, 8, 3)), _uint8(8, (8, 8, 1))], axis=-1)
    path = str(tmp_path / "in.png")
    Image.fromarray(rgba).save(path)
    out_path = str(tmp_path / "out.png")
    got = tapi.sr(path, export_path=out_path)
    _close_uint8(got, japi.sr(path))
    assert got.shape == (32, 32, 4)
    np.testing.assert_array_equal(np.asarray(Image.open(out_path)), got)
    _close_uint8(tapi.sr(Image.open(path)), got)
    with pytest.raises(ValueError, match="too large"):
        tapi.sr(_uint8(9, (8, 12, 3)), max_wh=10)


# ---- CLIP ----


@pytest.fixture(scope="module")
def extractors():
    jm = CLIP(rngs=nnx.Rngs(0), **TINY_CLIP)
    return JCLIPExtractor(jm), CLIPExtractor(bridged(jm, cflearn_torch.build(TCLIP, device="cpu", **TINY_CLIP)),
                                             device="cpu")


def _pils(seed, side=40):
    return [Image.fromarray(_uint8(seed + i, (side, side, 3))) for i in range(3)]


@pytest.mark.parametrize("kind", ["uint8", "unit", "signed", "pil"])
def test_image_latent(extractors, kind) -> None:
    """uint8, floats in [0, 1] and in [-1, 1] (told apart by their minimum), and PIL images resized to the
    model's 32px by PIL's default resample."""
    japi, tapi = extractors
    x = {"uint8": lambda: _uint8(10, (3, 32, 32, 3)),
         "unit": lambda: np.random.RandomState(11).rand(3, 32, 32, 3).astype(np.float32),
         "signed": lambda: np.random.RandomState(12).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32),
         "pil": lambda: _pils(13)}[kind]()
    got = tapi.get_image_latent(x, batch_size=2)
    assert got.shape == (3, 24) and got.dtype == np.float32
    assert rel_err(got, japi.get_image_latent(x, batch_size=2)) < TOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_text_latent_and_zero_shot(extractors) -> None:
    japi, tapi = extractors
    got = tapi.get_text_latent(TEXTS)
    assert rel_err(got, japi.get_text_latent(TEXTS)) < TOL
    np.testing.assert_array_equal(tapi.get_texts_latent(TEXTS), got)
    images = _uint8(14, (3, 32, 32, 3))
    np.testing.assert_array_equal(tapi.zero_shot_classify(images, TEXTS), japi.zero_shot_classify(images, TEXTS))


def test_paths_and_folder_latent(extractors, tmp_path) -> None:
    japi, tapi = extractors
    paths = []
    for i, pil in enumerate(_pils(15)):
        paths.append(str(tmp_path / f"{i}.png"))
        pil.save(paths[-1])
    (tmp_path / "notes.txt").write_text("not an image")
    got = tapi.get_paths_latent(paths)
    assert rel_err(got, japi.get_paths_latent(paths)) < TOL
    np.testing.assert_array_equal(tapi.get_folder_latent(str(tmp_path)), got)


def test_clip_score(extractors) -> None:
    japi, tapi = extractors
    images = _uint8(16, (3, 32, 32, 3))
    got = TQ.clip_score(images, TEXTS, extractor=tapi)
    assert got == pytest.approx(JQ.clip_score(images, TEXTS, extractor=japi), rel=TOL, abs=TOL)
    one = TQ.clip_score(images, "a red car", extractor=tapi)
    assert one == pytest.approx(JQ.clip_score(images, "a red car", extractor=japi), rel=TOL, abs=TOL)
    e = np.random.RandomState(17).randn(4, 8)
    assert TQ.clip_score_from_embeddings(e, -e) == 0.0 and TQ.clip_score_from_embeddings(e, 3 * e) == pytest.approx(100)
    assert TQ.clip_score_from_embeddings(e, e[::-1]) == JQ.clip_score_from_embeddings(e, e[::-1])
    with pytest.raises(ValueError, match="texts"):
        TQ.clip_score(images, TEXTS[:2], extractor=tapi)


def test_without_weights_or_a_known_model_it_raises(extractors) -> None:
    # without an extractor: the zoo's pretrained ViT-B/32, which loads onto the card only
    with pytest.raises(RuntimeError, match="none is available"):
        TQ.clip_score(_uint8(18, (1, 32, 32, 3)), "x")
    with pytest.raises(ValueError, match="not 'meta'"):
        CLIPExtractor.from_zoo(version="large", pretrained=True, device="meta")
    with pytest.raises(ValueError, match="unknown CLIP zoo version"):
        CLIPExtractor.from_zoo(version="huge", pretrained=False, device="meta")
    with pytest.raises(ValueError, match="not 'meta'"):
        TranslatorAPI.from_esr(pretrained=True, device="meta")
    with pytest.raises(NotImplementedError, match="ChineseCLIP"):
        CLIPExtractor(cflearn_torch.build(TCLIP, device="meta", **dict(TINY_CLIP, context_length=512)), device="cpu")


# ---- read_image and the path inputs of DiffusionAPI ----


@pytest.mark.parametrize(
    "case", ["path_rgba", "pil_rgb_max_wh", "array_float", "mask", "gray_bilinear", "raw_pixels"]
)
def test_read_image(tmp_path, case) -> None:
    rgba = np.concatenate([_uint8(19, (50, 70, 3)), _uint8(20, (50, 70, 1))], axis=-1)
    path = str(tmp_path / "x.png")
    Image.fromarray(rgba).save(path)
    args, kw = {
        "path_rgba": ((path, None), {}),
        "pil_rgb_max_wh": ((Image.fromarray(rgba[..., :3]), 48), dict(anchor=16)),
        "array_float": ((rgba[..., :3].astype(np.float32) / 255.0, None), dict(anchor=None)),
        "mask": ((path, None), dict(anchor=None, to_mask=True)),
        "gray_bilinear": ((path, None), dict(to_gray=True, resample="bilinear")),
        "raw_pixels": ((Image.fromarray(rgba[..., :3]), None), dict(normalize=False)),
    }[case]
    got, ref = TU.read_image(*args, **kw), JU.read_image(*args, **kw)
    np.testing.assert_array_equal(got.image, ref.image)
    assert (got.alpha is None) == (ref.alpha is None) and got.original_size == ref.original_size == (70, 50)
    if got.alpha is not None:
        np.testing.assert_array_equal(got.alpha, ref.alpha)
    assert TU.restrict_wh(300, 200, 150) == JU.restrict_wh(300, 200, 150) == (150, 100)
    assert [TU.get_suitable_size(n, 64) for n in (10, 96, 97, 130)] == [JU.get_suitable_size(n, 64) for n in
                                                                        (10, 96, 97, 130)]
    assert np.asarray(TU.to_alpha_channel(rgba)).tolist() == np.asarray(JU.to_alpha_channel(rgba)).tolist()


@pytest.fixture(scope="module")
def tiny_ldm_api():
    from _torch_api_common import CLIP as CLIP_COND, FIRST_STAGE, UNET

    tm = cflearn_torch.build(
        cflearn_torch.LDM, device="cpu", img_size=8, in_channels=4, out_channels=4, num_timesteps=50,
        condition_model=TCLIPText(**CLIP_COND), unet_config=UNET, first_stage_config=FIRST_STAGE,
    )
    return cflearn_torch.DiffusionAPI(tm, device="cpu")


def test_diffusion_api_takes_paths_and_pil(tiny_ldm_api, tmp_path) -> None:
    """img2img, inpainting (image and mask) and `outpainting(txt, rgba)` on a path or a PIL image equal the same
    calls on the arrays that `read_image` reads from them."""
    api = tiny_ldm_api
    img = smooth_image(21)[0]
    img_path, mask_path, rgba_path = (str(tmp_path / n) for n in ("img.png", "mask.png", "rgba.png"))
    Image.fromarray(img).save(img_path)
    m = centre_mask()
    Image.fromarray((m * 255).astype(np.uint8)).save(mask_path)
    kw = dict(num_steps=2, seed=3)
    np.testing.assert_array_equal(api.img2img(img_path, fidelity=0.5, **kw), api.img2img(img, fidelity=0.5, **kw))
    np.testing.assert_array_equal(api.inpainting(img_path, mask_path, **kw), api.inpainting(img, m, **kw))
    rgba = np.concatenate([img, np.where(m > 0, 0, 255).astype(np.uint8)[..., None]], axis=-1)
    Image.fromarray(rgba).save(rgba_path)
    np.testing.assert_array_equal(api.outpainting("", rgba_path, **kw), api.outpainting("", rgba, **kw))
    with pytest.raises(ValueError, match="RGBA"):
        api.outpainting("", Image.fromarray(img), **kw)
    # a side off the 64px grid: read_image snaps it, the result comes back at the original size
    Image.fromarray(smooth_image(22, 72)[0]).save(img_path)
    assert api.img2img(img_path, fidelity=0.5, **kw).shape == (1, 72, 72, 3)


# ---- IAPI, APIPool, Weights ----


def test_iapi_precision_and_offload(rrdb) -> None:
    """bf16 casts the parameters only; offload moves every tensor to the host and restore brings it back bit for
    bit (on the CPU both are host tensors: the card's freeing is checked by `chip_smoke.py`)."""
    _, tm = rrdb
    api = IAPI(bridged(rrdb[0], cflearn_torch.build(TRRDBNet, device="cpu", **RRDB)), device="cpu")
    assert api.dtype == torch.float32
    api.m.register_buffer("stat", torch.ones(3))
    api.to_bf16()
    assert api.dtype == torch.bfloat16 and api.m.stat.dtype == torch.float32
    before = {k: v.clone() for k, v in api.m.state_dict().items()}
    api.offload()
    assert api.offloaded and all(v.device.type == "cpu" for v in api.m.state_dict().values())
    api.restore()
    assert not api.offloaded
    after = api.m.state_dict()
    assert all(torch.equal(before[k], after[k]) and before[k].dtype == after[k].dtype for k in before)
    api.to_f32()
    assert all(p.dtype == torch.float32 for p in api.m.parameters())


def test_api_pool_offloads_what_it_evicts() -> None:
    class Api(IAPI):
        def __init__(self):
            super().__init__(torch.nn.Linear(2, 2), device="cpu")

    assert APIPool().limit == -1
    pool = APIPool(limit=2)
    a, b = pool.get("a", Api), pool.get("b", Api)
    assert pool.get("a") is a and "b" in pool
    c = pool.get("c", Api)
    assert b.offloaded and not a.offloaded and not c.offloaded and "b" not in pool
    assert pool.get("zz") is None
    weights = Weights(limit=2)
    for key in ("x", "y", "x", "z"):
        weights.register(key, {"w": key})
    assert list(weights.keys()) == ["x", "z"] and weights.get("x") == {"w": "x"} and "y" not in weights
    assert TD.Weights is Weights
