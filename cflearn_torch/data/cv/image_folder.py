"""Image folders: preparation once, then a packed random-access store
(counterpart of `cflearn_tpu/data/cv/image_folder.py`).

* `IPreparation` / `DefaultPreparation` / `ResizedPreparation` — which files
  are images, their labels (the parent folder's name) and the processing of
  each decoded image (`ResizedPreparation`: `jax.image.resize`'s bilinear
  through `data.blocks.cv.resize_image`, clipped to [0, 255] and truncated to
  uint8, as the JAX package does);
* `prepare_image_folder` — scan a class-subfolder tree, draw the valid split
  with `np.random.permutation` (numpy's global generator, as there), decode
  and process every image once, and write either one rcache store a split
  (`cflearn_torch.native`, where the C++ library builds) or compressed npz
  shards, with `meta.json`. Both formats are the JAX package's, file for
  file, so a folder that either package packed opens in the other;
* `PackedImageDataset` — random access over either format;
* `ImageFolderData` ("image_folder") — the `IData` over a packed folder;
* `collect_images`, `ImageFolderBlock` — the path walker, and the block that
  prepares a raw folder named by a bundle.

Images stay NHWC uint8 until the data blocks.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ...constants import INPUT_KEY, LABEL_KEY
from ...native import RecordCache, has_native, write_records
from ...schema.data import DataConfig, IData, IDataBlock, IDataset
from ..blocks.cv import resize_image
from ..utils import ArrayLoader, IArrayDataMixin

META_FILE = "meta.json"
IMG_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


class IPreparation:
    """Which files are images, their labels, and each image's processing."""

    def is_ready(self, path: str) -> bool:
        return os.path.splitext(path)[1].lower() in IMG_EXTENSIONS

    def get_label(self, path: str) -> Any:
        return os.path.basename(os.path.dirname(path))

    def process(self, image: np.ndarray) -> np.ndarray:
        return image


class DefaultPreparation(IPreparation):
    pass


class ResizedPreparation(IPreparation):
    def __init__(self, img_size: int = 224) -> None:
        self.img_size = img_size

    def process(self, image: np.ndarray) -> np.ndarray:
        out = resize_image(image, (self.img_size, self.img_size), "bilinear")
        return np.clip(out, 0, 255).astype(np.uint8)


def _load_image(path: str) -> Optional[np.ndarray]:
    # a missing PIL is an environment error and raises; an undecodable file is skipped
    from PIL import Image

    try:
        return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)
    except Exception:  # noqa: BLE001  (a corrupt image)
        return None


def _mixed_shapes(shape: Any, other: Any) -> ValueError:
    return ValueError(
        f"images process to differing shapes ({shape} vs {other}); use a resizing preparation (e.g. "
        "ResizedPreparation) for folders with mixed image sizes"
    )


def prepare_image_folder(
    src_folder: str,
    dst_folder: str,
    *,
    preparation: Optional[IPreparation] = None,
    valid_split: float = 0.1,
    shard_size: int = 1024,
    num_jobs: int = 8,
    force: bool = False,
) -> str:
    """Scan `src_folder` (one subfolder a class), decode and process every
    image once, and write the packed folder `dst_folder`: one rcache store a
    split where the rcache library builds, else npz shards of `shard_size`
    images. An existing `meta.json` is kept unless `force`."""
    preparation = preparation or ResizedPreparation(224)
    meta_path = os.path.join(dst_folder, META_FILE)
    if os.path.isfile(meta_path) and not force:
        return dst_folder
    paths: List[str] = []
    for root, _, files in os.walk(src_folder):
        for f in sorted(files):
            p = os.path.join(root, f)
            if preparation.is_ready(p):
                paths.append(p)
    if not paths:
        raise ValueError(f"no images found under '{src_folder}'")
    labels = [preparation.get_label(p) for p in paths]
    classes = sorted(set(labels))
    label_map = {c: i for i, c in enumerate(classes)}
    indices = np.random.permutation(len(paths))
    n_valid = max(1, int(round(len(paths) * valid_split))) if valid_split else 0
    splits = {"valid": indices[:n_valid], "train": indices[n_valid:]}
    os.makedirs(dst_folder, exist_ok=True)
    use_native = has_native()
    shard_info: Dict[str, List[Dict[str, Any]]] = {}
    image_shape: Optional[List[int]] = None
    with ThreadPoolExecutor(max_workers=num_jobs) as pool:
        for split, split_idx in splits.items():
            shard_info[split] = []
            if use_native:
                records: List[np.ndarray] = []
                split_labels: List[int] = []
                for img, label in pool.map(lambda i: (_load_image(paths[i]), labels[i]), split_idx):
                    if img is None:
                        continue
                    processed = preparation.process(img)
                    if image_shape is not None and list(processed.shape) != image_shape:
                        raise _mixed_shapes(image_shape, list(processed.shape))
                    image_shape = list(processed.shape)
                    records.append(processed.reshape(-1))
                    split_labels.append(label_map[label])
                if not records:
                    continue
                store = f"{split}.rcache"
                write_records(os.path.join(dst_folder, store), np.stack(records))
                np.save(os.path.join(dst_folder, f"{split}_labels.npy"),
                        np.asarray(split_labels, dtype=np.int64)[:, None])
                shard_info[split].append({"file": store, "num": len(records), "native": True})
                continue
            for s in range(0, len(split_idx), shard_size):
                chunk = split_idx[s : s + shard_size]
                images = list(pool.map(lambda i: _load_image(paths[i]), chunk))
                keep = [(img, labels[i]) for img, i in zip(images, chunk) if img is not None]
                if not keep:
                    continue
                processed = [preparation.process(img) for img, _ in keep]
                shapes = {p_.shape for p_ in processed}
                if len(shapes) > 1 or (image_shape is not None and list(processed[0].shape) != image_shape):
                    raise _mixed_shapes(image_shape, sorted(shapes))
                arr = np.stack(processed)
                image_shape = list(arr.shape[1:])
                y = np.array([label_map[l] for _, l in keep], dtype=np.int64)[:, None]
                shard = f"{split}_{s // shard_size:05d}.npz"
                np.savez_compressed(os.path.join(dst_folder, shard), images=arr, labels=y)
                shard_info[split].append({"file": shard, "num": len(keep)})
    with open(meta_path, "w") as f:
        json.dump({"classes": classes, "shards": shard_info, "image_shape": image_shape, "native": use_native},
                  f, indent=2)
    return dst_folder


class PackedImageDataset(IDataset):
    """Random access over a packed folder's split: the rcache store's gather,
    or the npz shards with the last shard read kept."""

    def __init__(self, folder: str, split: str = "train") -> None:
        with open(os.path.join(folder, META_FILE), "r") as f:
            meta = json.load(f)
        self.folder = folder
        self.split = split
        self.classes = meta["classes"]
        self.shards = meta["shards"][split]
        self.image_shape = meta.get("image_shape")
        self.offsets = np.cumsum([0] + [s["num"] for s in self.shards])
        self._cache_idx = -1
        self._cache: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._store: Optional[RecordCache] = None
        self._store_labels: Optional[np.ndarray] = None
        if self.shards and self.shards[0].get("native"):
            self._store = RecordCache(os.path.join(folder, self.shards[0]["file"]))
            self._store_labels = np.load(os.path.join(folder, f"{split}_labels.npy"))

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def __deepcopy__(self, memo: Any) -> "PackedImageDataset":
        # the store holds a native handle (which a copy must not share and close twice): reopen it
        return PackedImageDataset(self.folder, self.split)

    def _shard(self, shard_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if shard_idx != self._cache_idx:
            with np.load(os.path.join(self.folder, self.shards[shard_idx]["file"])) as z:
                self._cache = (z["images"], z["labels"])
            self._cache_idx = shard_idx
        assert self._cache is not None
        return self._cache

    def __getitem__(self, item: Any) -> Dict[str, np.ndarray]:
        indices = np.atleast_1d(np.asarray(item))
        if self._store is not None:
            assert self._store_labels is not None
            images = self._store.gather(indices.astype(np.int64)).reshape((len(indices), *self.image_shape))
            return {INPUT_KEY: images, LABEL_KEY: self._store_labels[indices].reshape(-1, 1)}
        images, labels = [], []
        for i in indices:
            shard_idx = int(np.searchsorted(self.offsets, i, side="right")) - 1
            imgs, ys = self._shard(shard_idx)
            local = int(i - self.offsets[shard_idx])
            images.append(imgs[local])
            labels.append(ys[local])
        return {INPUT_KEY: np.stack(images), LABEL_KEY: np.stack(labels).reshape(-1, 1)}


@IData.register("image_folder")
class ImageFolderData(IArrayDataMixin, IData):
    """The `IData` over a packed folder: loaders over its train and valid
    splits, each batch through the processor's blocks (the CV blocks)."""

    def __init__(self) -> None:
        super().__init__()
        self.folder: Optional[str] = None
        self._datasets: Dict[str, PackedImageDataset] = {}

    @classmethod
    def from_folder(
        cls, folder: str, *, config: Optional[DataConfig] = None, processor_config: Any = None,
    ) -> "ImageFolderData":
        self = cls.init(config, processor_config)
        self.folder = folder
        return self

    def to_info(self) -> Dict[str, Any]:
        info = super().to_info()
        info["folder"] = self.folder
        return info

    def from_info(self, info: Dict[str, Any]) -> None:
        super().from_info(info)
        self.folder = info.get("folder")

    def _dataset(self, split: str) -> PackedImageDataset:
        if split not in self._datasets:
            self._datasets[split] = PackedImageDataset(self.folder, split)
        return self._datasets[split]

    def get_loaders(self) -> Tuple[ArrayLoader, Optional[ArrayLoader]]:
        assert self.folder is not None
        postprocess = None
        if self.processor is not None:
            processor = self.processor
            postprocess = lambda item, for_inference: processor.postprocess_item(item, for_inference=for_inference)
        train = ArrayLoader(
            self._dataset("train"),
            batch_size=self.config.batch_size,
            shuffle=self.config.shuffle_train,
            drop_last=self.config.drop_last,
            sample_weights=self.train_weights,
            postprocess_fn=postprocess,
            for_inference=self.config.for_inference,
        )
        valid = None
        try:
            valid_ds = self._dataset("valid")
        except (KeyError, IndexError, FileNotFoundError):
            valid_ds = None
        if valid_ds is not None and len(valid_ds):
            valid = ArrayLoader(
                valid_ds,
                batch_size=self.config.valid_batch_size or self.config.batch_size,
                postprocess_fn=postprocess,
                for_inference=True,
            )
        return train, valid

    @property
    def num_train(self) -> int:
        assert self.folder is not None
        return len(self._dataset("train"))

    @property
    def num_valid(self) -> int:
        assert self.folder is not None
        try:
            return len(self._dataset("valid"))
        except (KeyError, IndexError):
            return 0


default_image_extensions = {".jpg", ".png", ".jpeg"}


class CollectResults(NamedTuple):
    all_img_paths: List[str]
    hierarchy_list: List[List[str]]


def collect_images(
    src_folder: str,
    *,
    prefix: Optional[str] = None,
    extensions: Optional[Any] = None,
    filter_fn: Optional[Any] = None,
) -> CollectResults:
    """The image paths under `src_folder`, sorted, with their folder
    hierarchies (the path's parts after `prefix`'s)."""
    if extensions is None:
        extensions = default_image_extensions
    prefix_idx = len(prefix.split(os.path.sep)) if prefix is not None else 0
    all_img_paths: List[str] = []
    hierarchy_list: List[List[str]] = []
    for root, _, files in sorted(os.walk(src_folder)):
        for name in sorted(files):
            if os.path.splitext(name)[1].lower() not in extensions:
                continue
            path = os.path.join(root, name)
            hierarchy = path.split(os.path.sep)[prefix_idx:]
            if filter_fn is not None and not filter_fn(hierarchy):
                continue
            hierarchy_list.append(hierarchy)
            all_img_paths.append(path)
    return CollectResults(all_img_paths, hierarchy_list)


@IDataBlock.register("image_folder")
class ImageFolderBlock(IDataBlock):
    """A raw image folder (`bundle.x_train`, a path) prepared into a packed
    folder by `prepare_image_folder`; the bundle then names the packed one."""

    tgt_folder: Optional[str]
    preparation_pack: Optional[Dict[str, Any]]
    force_rerun: bool

    @property
    def fields(self) -> List[str]:
        return ["tgt_folder", "preparation_pack", "force_rerun"]

    @property
    def init_fields(self) -> Dict[str, Any]:
        return {"tgt_folder": None, "preparation_pack": None, "force_rerun": False}

    def fit_transform(self, bundle: Any) -> Any:
        return self.transform(bundle, False)

    def transform(self, bundle: Any, for_inference: bool) -> Any:
        src = bundle.x_train
        if not isinstance(src, str):
            return bundle
        tgt = self.tgt_folder or (src.rstrip(os.path.sep) + "_prepared")
        pack = dict(self.preparation_pack or {})
        prep_type = pack.pop("type", "resized")
        preparation = ResizedPreparation(**pack) if prep_type == "resized" else DefaultPreparation()
        prepare_image_folder(src, tgt, preparation=preparation, force=self.force_rerun)
        bundle.x_train = tgt
        return bundle
