"""Push-based and KV-polled datasources over an in-process broker.

The reference ships one datasource module per config system (SURVEY.md
§2.2: Nacos/ZooKeeper/Apollo/Redis/etcd/Consul/...), all instances of two
shapes:

  * **push**: register a listener with the config system; convert + publish
    into the ``SentinelProperty`` on every notification
    (``NacosDataSource`` listener, ``ZookeeperDataSource`` watcher,
    ``RedisDataSource`` pub/sub);
  * **poll**: periodically read a key and push when its version changed
    (``ConsulDataSource``, ``EtcdDataSource`` watch-or-poll).

This sandbox has no network, so the concrete backend here is an
:class:`InProcessBroker` — a faithful KV + pub/sub analog (GET/SET with
monotone versions, topic subscribe/publish) that proves both shapes against
the same ``ReadableDataSource`` contract. A real Redis/etcd binding swaps
the broker for a client and keeps every other line.

Port of ``sentinel_tpu/datasource/push.py``: the same classes, importing
only this package.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple, TypeVar

from sentinel_tpu_torch.datasource.base import (
    AbstractDataSource,
    AutoRefreshDataSource,
    Converter,
    WritableDataSource,
    _log_warn,
)

T = TypeVar("T")


class InProcessBroker:
    """KV store with versions + topic pub/sub (Redis/etcd stand-in)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._kv: Dict[str, Tuple[str, int]] = {}  # key -> (value, version)
        self._subs: Dict[str, List[Callable[[str], None]]] = defaultdict(list)
        # Per-key delivery serialization: concurrent set()s must not deliver
        # an older value after a newer one (subscribers would keep the stale
        # rules until the next unrelated write). RLock: a subscriber may
        # write the key back from inside its callback.
        self._delivery: Dict[str, threading.RLock] = defaultdict(threading.RLock)
        self._delivered: Dict[str, int] = defaultdict(int)

    # -- KV ----------------------------------------------------------------

    def set(self, key: str, value: str) -> int:
        """SET; returns the new version. Also publishes to topic ``key``
        (the Redis impl publishes the channel alongside the write)."""
        with self._lock:
            version = self._kv.get(key, ("", 0))[1] + 1
            self._kv[key] = (value, version)
            delivery = self._delivery[key]
        with delivery:
            # Deliver until OUR version is covered (bounded: at most one
            # round past supersession — the superseding writer is parked on
            # this lock and owns delivering its own newer value, so no
            # subscriber is left stale and no writer loops on behalf of a
            # sustained write stream).
            while self._delivered[key] < version:
                with self._lock:
                    current, cur_version = self._kv[key]
                    subs = list(self._subs.get(key, ()))
                self._delivered[key] = cur_version
                for cb in subs:
                    with self._lock:
                        superseded = self._kv[key][1] > cur_version
                    if superseded:
                        break
                    try:
                        cb(current)
                    except Exception as ex:
                        _log_warn("broker subscriber failed: %r", ex)
        return version

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            item = self._kv.get(key)
        return item[0] if item else None

    def version(self, key: str) -> int:
        with self._lock:
            item = self._kv.get(key)
        return item[1] if item else 0

    def sync(self, key: str, cb: Callable[[str], None]) -> None:
        """Deliver the key's current value to ``cb`` under the delivery
        lock — the race-free "initial GET" for a fresh subscriber: no set()
        can interleave, and any later set() delivers strictly newer."""
        with self._lock:
            delivery = self._delivery[key]
        with delivery:
            with self._lock:
                item = self._kv.get(key)
            if item is not None:
                cb(item[0])

    # -- pub/sub -----------------------------------------------------------

    def subscribe(self, topic: str, cb: Callable[[str], None]) -> None:
        with self._lock:
            self._subs[topic].append(cb)

    def unsubscribe(self, topic: str, cb: Callable[[str], None]) -> None:
        with self._lock:
            try:
                self._subs[topic].remove(cb)
            except ValueError:
                pass


class PushDataSource(AbstractDataSource[str, T]):
    """Generic push shape: external notifications drive the property.

    Subclasses (or integrations) call :meth:`on_update` from the config
    system's callback thread; bad payloads are logged and skipped, keeping
    the last good value — the reference listeners behave the same way.
    """

    def __init__(self, converter: Converter):
        super().__init__(converter)

    def read_source(self) -> str:
        raise NotImplementedError(
            "push sources have no pull path; data arrives via on_update")

    def on_update(self, raw: str) -> None:
        try:
            value = self.converter(raw)
        except Exception as ex:
            _log_warn("push datasource convert failed (kept last good): %r", ex)
            return
        if value is not None:
            from sentinel_tpu_torch.telemetry.journal import acting

            # Journal provenance: pushed loads attribute to
            # the concrete source class, like the poll loop's reads.
            with acting(f"datasource:{type(self).__name__}"):
                self._property.update_value(value)


class BrokerDataSource(PushDataSource[T]):
    """Redis-pub/sub-shaped source: initial GET, then subscribe.

    Reference: ``RedisDataSource`` — constructor reads the key once, then
    listens on the channel for pushes.
    """

    def __init__(self, broker: InProcessBroker, key: str, converter: Converter):
        super().__init__(converter)
        self.broker = broker
        self.key = key
        # Subscribe, then take the initial value through broker.sync(),
        # which holds the per-key delivery lock: a concurrent set() either
        # fully delivers before the sync (sync re-reads the newer value) or
        # fully after (strictly newer) — the stale-initial-clobbers-push
        # race cannot happen.
        broker.subscribe(key, self.on_update)
        broker.sync(key, self.on_update)

    def read_source(self) -> str:
        return self.broker.get(self.key) or ""

    def close(self) -> None:
        self.broker.unsubscribe(self.key, self.on_update)


class PollingKVDataSource(AutoRefreshDataSource[str, T]):
    """Consul/etcd-shaped source: poll a key, push when its version moves."""

    def __init__(self, broker: InProcessBroker, key: str, converter: Converter,
                 recommend_refresh_ms: int = 3000, retry_policy=None):
        super().__init__(converter, recommend_refresh_ms,
                         retry_policy=retry_policy)
        self.broker = broker
        self.key = key
        self._last_version = -1

    def read_source(self) -> str:
        return self.broker.get(self.key) or ""

    def is_modified(self) -> bool:
        v = self.broker.version(self.key)
        if v != self._last_version:
            self._last_version = v
            return v > 0
        return False

    def first_load(self) -> None:
        self._last_version = self.broker.version(self.key)
        if self._last_version > 0:
            super().first_load()


class BrokerWritableDataSource(WritableDataSource[T]):
    """Write-back half: ``setRules`` persistence publishes through the
    broker, closing the reference's read/write datasource pair."""

    def __init__(self, broker: InProcessBroker, key: str, encoder: Converter):
        self.broker = broker
        self.key = key
        self.encoder = encoder

    def write(self, value: T) -> None:
        self.broker.set(self.key, self.encoder(value))
