"""Serialisation (counterpart of `cflearn_tpu/toolkit/serialization.py`).

- `DataClassBase`: a dataclass that goes to and from a JSON-able dict
  (`to_info` / `from_info`);
- `ISerializable`: a named, registered object with a JSON info and a dict of
  numpy arrays (`to_info` / `from_info`, `to_npd` / `from_npd`);
- `Serializer.save(folder, obj)` writes `info.json` (the type and the info)
  and `data.npz`; `Serializer.load(folder, base)` rebuilds the registered
  type. A folder the JAX package wrote loads here, and the other way round:
  the layout and the file names are the same.
"""

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Type, TypeVar

import numpy as np

from .registry import WithRegister

TSerializable = TypeVar("TSerializable", bound="ISerializable")

INFO_FILE = "info.json"
NPD_FILE = "data.npz"
OBJECT_PREFIX = "__obj__::"


def _jsonify(value: Any) -> Any:
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _jsonify(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, dict):
        return {k: _jsonify(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonify(v) for v in value]
    return value


class DataClassBase:
    """A dataclass that goes to and from a JSON-able dict."""

    @property
    def fields(self) -> Any:
        return dataclasses.fields(self)

    def asdict(self) -> Dict[str, Any]:
        return {f.name: _jsonify(getattr(self, f.name)) for f in self.fields}

    def to_info(self) -> Dict[str, Any]:
        return self.asdict()

    def from_info(self, info: Dict[str, Any]) -> None:
        """Set the fields named in `info`; other keys are ignored."""
        names = {f.name for f in self.fields}
        for k, v in info.items():
            if k in names:
                setattr(self, k, v)

    def update_with(self, other: "DataClassBase") -> None:
        for f in other.fields:
            v = getattr(other, f.name)
            if v is not None:
                setattr(self, f.name, v)

    def copy(self) -> "DataClassBase":
        new = self.__class__()
        new.from_info(json.loads(json.dumps(self.to_info())))
        return new

    @classmethod
    def from_dict(cls, info: Dict[str, Any]) -> "DataClassBase":
        obj = cls()
        obj.from_info(info)
        return obj


class ISerializable(WithRegister):
    """A registered object with a JSON info and numpy payloads."""

    d: Dict[str, type] = {}

    def to_info(self) -> Dict[str, Any]:
        return {}

    def from_info(self, info: Dict[str, Any]) -> None:
        pass

    def to_npd(self) -> Dict[str, np.ndarray]:
        return {}

    def from_npd(self, npd: Dict[str, np.ndarray]) -> None:
        pass

    def to_pack(self) -> Dict[str, Any]:
        return {"type": getattr(self, "__identifier__", self.__class__.__name__), "info": self.to_info()}

    @classmethod
    def from_pack(cls: Type[TSerializable], pack: Dict[str, Any]) -> TSerializable:
        obj = cls.get(pack["type"])()
        obj.from_info(pack["info"])
        return obj

    def copy(self: TSerializable) -> TSerializable:
        copied = self.__class__()
        copied.from_info(json.loads(json.dumps(self.to_info())))
        copied.from_npd(self.to_npd())
        return copied


class Serializer:
    """Folder save / load of `ISerializable`s."""

    @staticmethod
    def save_info(folder: str, *, info: Optional[Dict[str, Any]] = None, serializable: Optional[ISerializable] = None) -> None:
        os.makedirs(folder, exist_ok=True)
        if info is None:
            assert serializable is not None
            info = serializable.to_pack()
        with open(os.path.join(folder, INFO_FILE), "w") as f:
            json.dump(_jsonify(info), f, indent=2)

    @staticmethod
    def load_info(folder: str) -> Dict[str, Any]:
        with open(os.path.join(folder, INFO_FILE), "r") as f:
            return json.load(f)

    @staticmethod
    def save_npd(folder: str, serializable: ISerializable) -> None:
        """`to_npd()` as `data.npz`; object arrays go as unicode arrays under
        a marked key (None as ""), so that nothing is pickled."""
        npd = dict(serializable.to_npd())
        for k in list(npd):
            v = npd[k]
            if isinstance(v, np.ndarray) and v.dtype == object:
                is_none = np.frompyfunc(lambda x: x is None, 1, 1)(v).astype(bool)
                npd[OBJECT_PREFIX + k] = np.where(is_none, "", v).astype(str)
                del npd[k]
        os.makedirs(folder, exist_ok=True)
        np.savez_compressed(os.path.join(folder, NPD_FILE), **npd)

    @staticmethod
    def load_npd(folder: str) -> Dict[str, np.ndarray]:
        path = os.path.join(folder, NPD_FILE)
        if not os.path.isfile(path):
            return {}
        with np.load(path, allow_pickle=False) as z:
            return {
                (k[len(OBJECT_PREFIX):] if k.startswith(OBJECT_PREFIX) else k): (
                    z[k].astype(object) if k.startswith(OBJECT_PREFIX) else z[k]
                )
                for k in z.files
            }

    @classmethod
    def save(cls, folder: str, serializable: ISerializable, *, save_npd: bool = True) -> None:
        cls.save_info(folder, serializable=serializable)
        if save_npd:
            cls.save_npd(folder, serializable)

    @classmethod
    def load(
        cls,
        folder: str,
        base: Type[TSerializable],
        *,
        swap_id: Optional[str] = None,
        load_npd: bool = True,
    ) -> TSerializable:
        pack = cls.load_info(folder)
        if swap_id is not None:
            pack["type"] = swap_id
        obj = base.from_pack(pack)
        if load_npd:
            obj.from_npd(cls.load_npd(folder))
        return obj
