"""The port's CV data against the JAX package's, on the CPU: every CV block
on the same seeded uint8 batches (the resizes within 1e-5 of the output's
max, every other block exact); `prepare_image_folder` on a seeded PNG folder
in both formats (npz shards and rcache stores), with equal labels, splits,
meta and loader batches, the images equal but where the two f32 resizes
land on either side of a uint8 step; a folder packed by either package read
by the other; `ExternalData`'s batches and its per-process shards."""

import json
import os

import numpy as np
import pytest
import torch

import cflearn_torch
import cflearn_tpu.native as jnative
from cflearn_torch.constants import INPUT_KEY, LABEL_KEY
from cflearn_torch.data.blocks import cv as TB
from cflearn_torch.data.cv import image_folder as TF
from cflearn_torch.data import external as TE
from cflearn_tpu.data.blocks import cv as JB
from cflearn_tpu.data.cv import image_folder as JF
from cflearn_tpu.data import external as JE
from cflearn_tpu.schema.data import DataConfig as JDataConfig

RESIZE_REL = 1e-5


def _batch(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def _run(block, item, for_inference=False):
    return block.postprocess_item({k: np.array(v, copy=True) for k, v in item.items()}, for_inference)


# (name, kwargs, input shape, exact)
BLOCK_CASES = [
    ("to_numpy", {}, (2, 6, 7, 3), True),
    ("to_rgb", {}, (2, 6, 7, 1), True),
    ("to_rgb", {}, (6, 7, 4), True),
    ("to_rgb", {}, (6, 7), True),
    ("to_hwc", {}, (2, 3, 6, 7), True),
    ("to_hwc", {}, (3, 6, 7), True),
    ("hwc_to_chw", {}, (2, 6, 7, 3), True),
    ("hwc_to_chw", {}, (6, 7, 3), True),
    ("flatten", {}, (2, 6, 7, 3), True),
    ("flatten", {}, (6, 7, 3), True),
    ("static_normalize", {}, (2, 6, 7, 3), True),
    ("static_normalize", {"div": 127.5}, (2, 6, 7, 3), True),
    ("affine_normalize", {"center": 127.5, "scale": 127.5}, (2, 6, 7, 3), True),
    ("imagenet_normalize", {}, (2, 6, 7, 3), True),
    ("resize", {"size": 16}, (2, 10, 12, 3), False),
    ("resize", {"size": [5, 9]}, (2, 20, 30, 3), False),
    ("resize", {"size": 4, "interpolation": "nearest"}, (9, 11, 3), True),
    ("resize", {"size": 7, "interpolation": "bicubic"}, (2, 13, 10, 3), False),
    ("anchored_resize", {"anchor": 8}, (2, 12, 20, 3), False),
    ("anchored_resize", {"anchor": 16}, (10, 7, 3), False),
    ("center_crop", {"size": 8}, (2, 12, 20, 3), True),
    ("center_crop", {"size": [5, 9]}, (13, 10, 3), True),
]


@pytest.mark.parametrize("name,kwargs,shape,exact", BLOCK_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(BLOCK_CASES)])
def test_cv_block_matches_jax(name, kwargs, shape, exact) -> None:
    item = {INPUT_KEY: _batch(shape), LABEL_KEY: np.arange(2)[:, None]}
    mine = cflearn_torch.schema.data.IDataBlock.make(name, dict(kwargs))
    ref = JB.IDataBlock.make(name, dict(kwargs))
    assert type(mine).__name__ == type(ref).__name__ and mine.to_info() == ref.to_info()
    got, want = _run(mine, item)[INPUT_KEY], np.asarray(_run(ref, item)[INPUT_KEY])
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= RESIZE_REL * np.abs(want).max()


@pytest.mark.parametrize("for_inference", [False, True])
def test_random_crop_draws_as_jax(for_inference) -> None:
    """Both blocks draw their offsets from numpy's global generator: one seed,
    one crop; the inference crop is the centre."""
    item = {INPUT_KEY: _batch((2, 15, 19, 3))}
    crops = []
    for block in (TB.RandomCropBlock(size=7), JB.RandomCropBlock(size=7)):
        np.random.seed(11)
        crops.append([_run(block, item, for_inference)[INPUT_KEY] for _ in range(4)])
    for got, want in zip(*crops):
        np.testing.assert_array_equal(got, want)
    if for_inference:
        np.testing.assert_array_equal(crops[0][0], item[INPUT_KEY][:, 4:11, 6:13])
    else:
        assert len({c.tobytes() for c in crops[0]}) > 1


def test_tuple_to_batch() -> None:
    x, y = _batch((3, 4)), np.arange(3)
    got = TB.TupleToBatchBlock().postprocess_item((x, y), False)
    want = JB.TupleToBatchBlock().postprocess_item((x, y), False)
    assert set(got) == set(want) == {INPUT_KEY, LABEL_KEY}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def png_folder(tmp_path_factory):
    """Two classes of seeded PNG images of mixed sizes (10 to 14 px)."""
    from PIL import Image

    src = tmp_path_factory.mktemp("pngs")
    rs = np.random.RandomState(5)
    for cls in ("cat", "dog"):
        os.makedirs(src / cls)
        for i in range(7):
            arr = rs.randint(0, 256, (10 + i % 5, 14 - i % 3, 3)).astype(np.uint8)
            Image.fromarray(arr).save(src / cls / f"{i}.png")
    return str(src)


def _prepare(side, src, dst, native):
    np.random.seed(3)
    if side == "jax":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jnative, "has_native", lambda: native)
            if native:
                assert jnative.rcache.has_native(), "the JAX package's rcache library does not build here"
            return JF.prepare_image_folder(src, dst, preparation=JF.ResizedPreparation(8), valid_split=0.25,
                                           shard_size=4, num_jobs=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TF, "has_native", lambda: native)
        return TF.prepare_image_folder(src, dst, preparation=TF.ResizedPreparation(8), valid_split=0.25,
                                       shard_size=4, num_jobs=2)


def _jax_float_resize(path, size):
    """The JAX preparation's f32 resize before its uint8 truncation."""
    import jax
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)
    return np.asarray(jax.image.resize(img.astype(np.float32), (size, size, 3), "bilinear"))


@pytest.mark.parametrize("native", [False, True], ids=["npz", "rcache"])
def test_prepare_image_folder_matches_jax(png_folder, tmp_path, native) -> None:
    mine = _prepare("port", png_folder, str(tmp_path / "port"), native)
    ref = _prepare("jax", png_folder, str(tmp_path / "jax"), native)
    assert sorted(os.listdir(mine)) == sorted(os.listdir(ref))
    with open(os.path.join(mine, "meta.json")) as f, open(os.path.join(ref, "meta.json")) as g:
        assert json.load(f) == json.load(g)
    # the images in the split order: the same paths in both (one permutation from one seed)
    paths = []
    for root, _, files in os.walk(png_folder):
        paths += [os.path.join(root, f) for f in sorted(files)]
    np.random.seed(3)
    order = np.random.permutation(len(paths))
    offset = 0
    for split in ("valid", "train"):
        got, want = TF.PackedImageDataset(mine, split), JF.PackedImageDataset(ref, split)
        assert len(got) == len(want) > 0
        idx = np.arange(len(got))
        a, b = got[idx], want[idx]
        np.testing.assert_array_equal(a[LABEL_KEY], b[LABEL_KEY])
        assert a[INPUT_KEY].shape == b[INPUT_KEY].shape == (len(got), 8, 8, 3)
        # equal images, but where the two f32 resizes straddle a uint8 step: there one level apart, and the
        # JAX value within 1e-4 of the step
        floats = np.stack([_jax_float_resize(paths[i], 8) for i in order[offset : offset + len(got)]])
        offset += len(got)
        np.testing.assert_array_equal(np.clip(floats, 0, 255).astype(np.uint8), b[INPUT_KEY])
        diff = a[INPUT_KEY].astype(np.int16) - b[INPUT_KEY].astype(np.int16)
        assert np.abs(diff).max() <= 1
        near_step = np.abs(floats - np.round(floats)) <= 1e-4 * np.abs(floats).max()
        assert not (diff != 0)[~near_step].any()


@pytest.mark.parametrize("native", [False, True], ids=["npz", "rcache"])
def test_packed_folders_read_in_the_other_package(png_folder, tmp_path, native) -> None:
    mine = _prepare("port", png_folder, str(tmp_path / "port"), native)
    ref = _prepare("jax", png_folder, str(tmp_path / "jax"), native)
    for folder in (mine, ref):
        for split in ("train", "valid"):
            a, b = TF.PackedImageDataset(folder, split), JF.PackedImageDataset(folder, split)
            idx = np.array([len(a) - 1, 0, 1])
            for k in (INPUT_KEY, LABEL_KEY):
                np.testing.assert_array_equal(a[idx][k], b[idx][k])


def test_image_folder_data_loaders_match_jax(png_folder, tmp_path) -> None:
    """`ImageFolderData` with a normalize block: the same batches (shuffled by
    numpy's global generator) in both packages; a loader copy reopens the
    store."""
    folder = _prepare("port", png_folder, str(tmp_path / "packed"), True)
    block = {"block_names": ["affine_normalize"],
             "block_configs": {"affine_normalize": {"center": 127.5, "scale": 127.5}}}
    tconfig, jconfig = cflearn_torch.DataConfig(), JDataConfig()
    tconfig.batch_size = jconfig.batch_size = 4
    from cflearn_torch.schema.data import DataProcessorConfig as TPC
    from cflearn_tpu.schema.data import DataProcessorConfig as JPC

    mine = TF.ImageFolderData.from_folder(folder, config=tconfig, processor_config=TPC(**block))
    ref = JF.ImageFolderData.from_folder(folder, config=jconfig, processor_config=JPC(**block))
    assert (mine.num_train, mine.num_valid) == (ref.num_train, ref.num_valid) == (10, 4)
    for got_loader, want_loader in zip(mine.get_loaders(), ref.get_loaders()):
        np.random.seed(9)
        got = list(got_loader)
        np.random.seed(9)
        want = list(want_loader)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for k in (INPUT_KEY, LABEL_KEY):
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))
            assert a[INPUT_KEY].dtype == np.float32 and np.abs(a[INPUT_KEY]).max() <= 1.0
    clone = mine.get_loaders()[0].copy()
    assert clone.get_one_batch()[INPUT_KEY].shape[1:] == (8, 8, 3)
    assert mine.to_info()["folder"] == folder


def test_image_folder_block_and_collect_images(png_folder, tmp_path) -> None:
    from cflearn_torch.schema.data import DataBundle

    got = TF.collect_images(png_folder, prefix=png_folder)
    want = JF.collect_images(png_folder, prefix=png_folder)
    assert got.all_img_paths == want.all_img_paths and got.hierarchy_list == want.hierarchy_list
    assert len(got.all_img_paths) == 14
    target = str(tmp_path / "prepared")
    block = TF.ImageFolderBlock(tgt_folder=target, preparation_pack={"type": "resized", "img_size": 6})
    bundle = block.fit_transform(DataBundle(png_folder))
    assert bundle.x_train == target
    assert TF.PackedImageDataset(target, "train")[np.arange(2)][INPUT_KEY].shape == (2, 6, 6, 3)


def test_rcache_store_round_trip_and_bounds(tmp_path) -> None:
    """The port's store against the JAX package's reader and back, through
    the native library and through numpy; an index out of range raises."""
    from cflearn_torch import native as tnative

    records = _batch((6, 10))
    path = str(tmp_path / "store.rcache")
    tnative.write_records(path, records)
    assert open(path, "rb").read()[:24] == np.array([0x52434143484531, 6, 10], dtype="<u8").tobytes()
    idx = np.array([5, 0, 3, 3])
    np.testing.assert_array_equal(jnative.RecordCache(path).gather(idx), records[idx])
    np.testing.assert_array_equal(tnative.RecordCache(path).gather(idx), records[idx])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnative.rcache, "load_library", lambda: None)
        other = str(tmp_path / "numpy.rcache")
        tnative.rcache.write_records(other, records)
        assert open(other, "rb").read() == open(path, "rb").read()
        reader = tnative.rcache.RecordCache(path)
        assert reader._handle is None
        np.testing.assert_array_equal(reader.gather(idx), records[idx])
        with pytest.raises(IndexError):
            reader.gather(np.array([6]))
    with pytest.raises(IndexError):
        tnative.RecordCache(path).gather(np.array([-1]))


class _Toy(torch.utils.data.Dataset):
    def __len__(self) -> int:
        return 20

    def __getitem__(self, i: int):
        return torch.full((4,), float(i)), i % 3


class _DictToy:
    def __len__(self) -> int:
        return 11

    def __getitem__(self, i: int):
        return {INPUT_KEY: np.full((2, 2), i, dtype=np.float32), "extra": np.int64(i * 2)}


@pytest.mark.parametrize("dataset", [_Toy, _DictToy])
def test_external_data_batches_match_jax(dataset) -> None:
    tconfig, jconfig = cflearn_torch.DataConfig(), JDataConfig()
    tconfig.batch_size = jconfig.batch_size = 8
    tconfig.shuffle_train = jconfig.shuffle_train = False
    mine = TE.ExternalData.from_datasets(dataset(), dataset(), config=tconfig)
    ref = JE.ExternalData.from_datasets(dataset(), dataset(), config=jconfig)
    assert (mine.num_train, mine.num_valid) == (ref.num_train, ref.num_valid)
    for got_loader, want_loader in zip(mine.get_loaders(), ref.get_loaders()):
        for a, b in zip(got_loader, want_loader):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_external_data_shards_match_jax(monkeypatch, rank) -> None:
    """Three processes: each takes indices rank::3 of the training set, as
    the JAX package's process index does; the valid set stays whole unless
    asked."""
    import jax

    monkeypatch.setattr(TE, "process_shard", lambda: (rank, 3))
    monkeypatch.setattr(jax, "process_count", lambda: 3)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    mine = TE.ExternalData.from_datasets(_Toy(), _Toy())
    ref = JE.ExternalData.from_datasets(_Toy(), _Toy())
    np.testing.assert_array_equal(mine.train_dataset._indices, ref.train_dataset._indices)
    np.testing.assert_array_equal(mine.train_dataset._indices, np.arange(rank, 20, 3))
    assert len(mine.valid_dataset) == len(ref.valid_dataset) == 20
    sharded = TE.ExternalData.from_datasets(_Toy(), _Toy(), shard_valid=True)
    assert len(sharded.valid_dataset) == len(range(rank, 20, 3))
    batch = mine.train_dataset[np.arange(len(mine.train_dataset))]
    np.testing.assert_array_equal(batch[INPUT_KEY][:, 0], np.arange(rank, 20, 3))


def test_process_shard_reads_the_process_group(tmp_path) -> None:
    """With a (one-process, gloo) group up, the shard is its rank and size."""
    import torch.distributed as dist

    assert TE.process_shard() == (0, 1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        assert TE.process_shard() == (0, 1)
        assert len(TE.ExternalDataset(_Toy())) == 20
    finally:
        dist.destroy_process_group()
