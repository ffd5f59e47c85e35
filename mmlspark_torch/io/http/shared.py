"""Process-wide shared values.

Reference ``io/http/SharedVariable.scala`` / ``SharedSingleton`` — one
instance per executor JVM, keyed by constructor value; used so every
partition on a host shares one HTTP client / server. Here: per-process
registries with lazy construction.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, TypeVar

T = TypeVar("T")


class SharedVariable(Generic[T]):
    """Lazily-constructed process-wide value (one per SharedVariable
    instance, like the reference's one-per-JVM semantics)."""

    def __init__(self, factory: Callable[[], T]):
        self._factory = factory
        self._lock = threading.Lock()
        self._value: T | None = None
        self._created = False

    def get(self) -> T:
        with self._lock:
            if not self._created:
                self._value = self._factory()
                self._created = True
            return self._value


class SharedSingleton:
    """Keyed global registry (reference ``SharedSingleton``)."""

    _registry: dict = {}
    _lock = threading.Lock()

    @classmethod
    def get_or_create(cls, key, factory: Callable[[], T]) -> T:
        with cls._lock:
            if key not in cls._registry:
                cls._registry[key] = factory()
            return cls._registry[key]

    @classmethod
    def remove(cls, key) -> None:
        with cls._lock:
            cls._registry.pop(key, None)
