"""Push-based dynamic configuration (port of ``sentinel_tpu/core/property.py``;
reference: ``core:property/`` — ``SentinelProperty``,
``DynamicSentinelProperty``, ``PropertyListener``,
``SimplePropertyListener``).

A property is a typed holder whose ``update_value`` fans out to listeners;
the engine's window-geometry and occupy-cap properties register the
engine's setters as listeners, and a datasource pushes into the property.
``update_value`` returns False (and skips the fan-out) when the value is
unchanged — the reference's equality short-circuit. Listeners run OUTSIDE
the property's lock, so a listener may take the engine's locks.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")


class PropertyListener(Generic[T]):
    """Reference: ``PropertyListener<T>``."""

    def config_update(self, value: T) -> None:
        raise NotImplementedError

    def config_load(self, value: T) -> None:
        # Initial load; the default mirrors the reference's common pattern.
        self.config_update(value)


class SimplePropertyListener(PropertyListener[T]):
    def __init__(self, fn: Callable[[T], None]):
        self._fn = fn

    def config_update(self, value: T) -> None:
        self._fn(value)


class SentinelProperty(Generic[T]):
    """Reference: ``SentinelProperty<T>`` interface."""

    def add_listener(self, listener: PropertyListener[T]) -> None:
        raise NotImplementedError

    def remove_listener(self, listener: PropertyListener[T]) -> None:
        raise NotImplementedError

    def update_value(self, value: T) -> bool:
        raise NotImplementedError


class DynamicSentinelProperty(SentinelProperty[T]):
    """Reference: ``DynamicSentinelProperty<T>``.

    ``epoch`` counts ACCEPTED updates (the equality short-circuit does not
    bump it): a monotonic version observers can compare without holding
    the value itself."""

    def __init__(self, value: Optional[T] = None):
        self._lock = threading.RLock()
        self._listeners: List[PropertyListener[T]] = []
        self.value: Optional[T] = value
        self.epoch = 0

    def add_listener(self, listener: PropertyListener[T]) -> None:
        with self._lock:
            self._listeners.append(listener)
            value = self.value
        if value is not None:
            listener.config_load(value)

    def remove_listener(self, listener: PropertyListener[T]) -> None:
        with self._lock:
            if listener in self._listeners:
                self._listeners.remove(listener)

    def update_value(self, value: T) -> bool:
        with self._lock:
            if value == self.value:
                return False
            self.value = value
            self.epoch += 1
            listeners = list(self._listeners)
        for listener in listeners:
            listener.config_update(value)
        return True


class NoOpSentinelProperty(SentinelProperty[T]):
    """Reference: ``NoOpPropertyListener`` counterpart for disabled paths."""

    def add_listener(self, listener: PropertyListener[T]) -> None:
        pass

    def remove_listener(self, listener: PropertyListener[T]) -> None:
        pass

    def update_value(self, value: T) -> bool:
        return False
