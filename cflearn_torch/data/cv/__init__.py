"""Image-folder data (counterpart of `cflearn_tpu/data/cv/`)."""

from .image_folder import (
    CollectResults, DefaultPreparation, ImageFolderBlock, ImageFolderData, IPreparation, PackedImageDataset,
    ResizedPreparation, collect_images, default_image_extensions, prepare_image_folder,
)

__all__ = [
    "CollectResults", "DefaultPreparation", "ImageFolderBlock", "ImageFolderData", "IPreparation",
    "PackedImageDataset", "ResizedPreparation", "collect_images", "default_image_extensions", "prepare_image_folder",
]
