"""Native (C++) host components (counterpart of `cflearn_tpu/native/`):
`rcache`, the mmap'd packed record store under the image-folder data, the
port's own copy of the source, built at first use."""

from .rcache import RecordCache, has_native, write_records

__all__ = ["RecordCache", "has_native", "write_records"]
