"""Explicit plugin registry.

The reference lineage resolves algorithms/backends through a ``Factory``
metaclass plus ``pkg_resources`` entry points (ref: src/metaopt/core/utils/).
Here registration is an explicit decorator and lookup is a dict — cheaper,
import-order independent, and trivially testable.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, Type, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """A named collection of classes with case-insensitive lookup."""

    def __init__(self, kind: str) -> None:
        self.kind = kind
        self._entries: Dict[str, Type[T]] = {}

    def register(self, name: str | None = None) -> Callable[[Type[T]], Type[T]]:
        def deco(cls: Type[T]) -> Type[T]:
            key = (name or cls.__name__).lower()
            if key in self._entries and self._entries[key] is not cls:
                raise ValueError(f"{self.kind} {key!r} already registered")
            self._entries[key] = cls
            return cls

        return deco

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._entries

    def get(self, name: str) -> Type[T]:
        try:
            return self._entries[name.lower()]
        except KeyError:
            known = ", ".join(sorted(self._entries)) or "<none>"
            raise KeyError(
                f"unknown {self.kind} {name!r}; known: {known}"
            ) from None

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))
