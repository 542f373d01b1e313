from .misc import check_sha_with, download, download_checkpoint, download_json

__all__ = ["check_sha_with", "download", "download_checkpoint", "download_json"]
