"""Toy tabular datasets (counterpart of `cflearn_tpu/data/ml/datasets.py`):
iris, digits, breast cancer and California housing from scikit-learn, which
is imported only when a loader is called; MNIST from a local torchvision
cache, else the digits upscaled by the port's `jax.image.resize`
counterpart."""

from typing import Tuple

import numpy as np


def _from_sklearn(loader_name: str) -> Tuple[np.ndarray, np.ndarray]:
    from sklearn import datasets

    bunch = getattr(datasets, loader_name)()
    x = np.asarray(bunch.data, dtype=np.float32)
    y = np.asarray(bunch.target).reshape(-1, 1)
    return x, y


def iris_data() -> Tuple[np.ndarray, np.ndarray]:
    x, y = _from_sklearn("load_iris")
    return x, y.astype(np.int64)


def digits_data() -> Tuple[np.ndarray, np.ndarray]:
    x, y = _from_sklearn("load_digits")
    return x, y.astype(np.int64)


def breast_data() -> Tuple[np.ndarray, np.ndarray]:
    x, y = _from_sklearn("load_breast_cancer")
    return x, y.astype(np.int64)


def california_data() -> Tuple[np.ndarray, np.ndarray]:
    x, y = _from_sklearn("fetch_california_housing")
    return x, y.astype(np.float32)


def mnist_data(*, img_size: int = 28) -> Tuple[np.ndarray, np.ndarray]:
    """MNIST images (N, 28, 28, 1) in [0, 1] from a torchvision cache in
    `~/.cache/mnist` (never downloaded); without one, the 8x8 digits upscaled
    bilinearly to `img_size`."""
    try:
        from torchvision.datasets import MNIST  # type: ignore

        ds = MNIST(root="~/.cache/mnist", download=False)
        x = ds.data.numpy().astype(np.float32)[..., None] / 255.0
        y = ds.targets.numpy().astype(np.int64).reshape(-1, 1)
        return x, y
    except Exception:  # noqa: BLE001
        pass
    x, y = digits_data()
    images = x.reshape(-1, 8, 8, 1) / 16.0
    if img_size != 8:
        import torch

        from ...modules.layers import resize

        images = resize(torch.from_numpy(images.astype(np.float32)), (img_size, img_size), "bilinear").numpy()
    return images.astype(np.float32), y
