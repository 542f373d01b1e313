"""Named registries (counterpart of `cflearn_tpu/toolkit/registry.py`): a
`Registry` container, and the `WithRegister` mixin that gives a class
hierarchy its own name -> class table with `register`, `get`, `make` and
`make_multiple`."""

from typing import Any, Callable, Dict, Generic, Iterator, List, Optional, Type, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """A plain name -> class registry that builds by name."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._d: Dict[str, Type[T]] = {}

    def __contains__(self, key: str) -> bool:
        return key in self._d

    def __iter__(self) -> Iterator[str]:
        return iter(self._d)

    def keys(self) -> List[str]:
        return sorted(self._d)

    def get(self, key: str) -> Optional[Type[T]]:
        return self._d.get(key)

    def register(self, key: str, *, allow_duplicate: bool = False) -> Callable[[Type[T]], Type[T]]:
        """A decorator: a second class under `key` raises unless
        `allow_duplicate` (the same class again is fine)."""

        def _core(cls: Type[T]) -> Type[T]:
            if not allow_duplicate and key in self._d and self._d[key] is not cls:
                raise ValueError(f"'{key}' already registered in registry '{self.name}'")
            self._d[key] = cls
            setattr(cls, "__identifier__", key)
            return cls

        return _core

    def build(self, key: str, *args: Any, **kwargs: Any) -> T:
        cls = self._d.get(key)
        if cls is None:
            raise ValueError(f"'{key}' is not registered in registry '{self.name}' (available: {self.keys()})")
        return cls(*args, **kwargs)


class WithRegister:
    """A class hierarchy's own registry: the base declares `d: Dict[str,
    type] = {}`, subclasses join it by `Base.register(name)`, and
    `Base.make(name, config)` builds one."""

    d: Dict[str, type]
    __identifier__: str

    @classmethod
    def register(cls, name: str, *, allow_duplicate: bool = False) -> Callable[[type], type]:
        def _core(sub: type) -> type:
            if not allow_duplicate and name in cls.d and cls.d[name] is not sub:
                raise ValueError(f"'{name}' already registered for {cls.__name__}")
            cls.d[name] = sub
            sub.__identifier__ = name
            return sub

        return _core

    @classmethod
    def has(cls, name: str) -> bool:
        return name in cls.d

    @classmethod
    def remove(cls, name: str) -> Optional[type]:
        return cls.d.pop(name, None)

    @classmethod
    def get(cls, name: str) -> type:
        if name not in cls.d:
            raise ValueError(f"'{name}' is not registered for {cls.__name__} (available: {sorted(cls.d)})")
        return cls.d[name]

    @classmethod
    def make(cls, name: str, config: Optional[Dict[str, Any]] = None, **kwargs: Any) -> Any:
        kw = dict(config or {})
        kw.update(kwargs)
        return cls.get(name)(**kw)

    @classmethod
    def make_multiple(cls, names: Any, configs: Optional[Dict[str, Dict[str, Any]]] = None) -> List[Any]:
        if isinstance(names, str):
            names = [names]
        configs = configs or {}
        return [cls.make(name, configs.get(name)) for name in names]
