"""Datasource framework (reference: ``sentinel-datasource-extension``:
``ReadableDataSource`` / ``WritableDataSource`` / ``AbstractDataSource`` /
``AutoRefreshDataSource`` / ``FileRefreshableDataSource`` /
``FileWritableDataSource`` / ``Converter`` — SURVEY.md §2.2, §3.2).

Port of ``sentinel_tpu/datasource/base.py``: the same classes, importing
only this package.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Generic, Optional, TypeVar

from sentinel_tpu_torch.core.property import (
    DynamicSentinelProperty,
    SentinelProperty,
    SimplePropertyListener,
)
from sentinel_tpu_torch.resilience import RetryPolicy, faults, register_probe
from sentinel_tpu_torch.utils import time_util

S = TypeVar("S")
T = TypeVar("T")


def _log_warn(msg: str, *args) -> None:
    from sentinel_tpu_torch.log.record_log import record_log

    record_log.warn(msg, *args)

# Reference: ``Converter<S, T>`` — a single ``convert`` method, so a plain
# callable is the Python-native shape.
Converter = Callable[[S], T]


class ReadableDataSource(Generic[S, T]):
    """Reference: ``ReadableDataSource<S, T>``."""

    def load_config(self) -> Optional[T]:
        raise NotImplementedError

    def read_source(self) -> S:
        raise NotImplementedError

    @property
    def property(self) -> SentinelProperty[T]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class WritableDataSource(Generic[T]):
    """Reference: ``WritableDataSource<T>``."""

    def write(self, value: T) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class AbstractDataSource(ReadableDataSource[S, T]):
    """Holds the converter + a ``DynamicSentinelProperty`` fan-out point."""

    def __init__(self, converter: Converter):
        if converter is None:
            raise ValueError("converter can't be None")
        self.converter = converter
        self._property: DynamicSentinelProperty[T] = DynamicSentinelProperty()

    def load_config(self) -> Optional[T]:
        faults.fire("datasource.read")
        return self.converter(self.read_source())

    @property
    def property(self) -> SentinelProperty[T]:
        return self._property


class AutoRefreshDataSource(AbstractDataSource[S, T]):
    """Poll loop (reference default 3s): re-read, convert, push on change.

    ``is_modified`` lets subclasses cheaply skip unchanged sources (the
    file impl checks mtime, mirroring the reference).

    Resilience: consecutive refresh failures back off on a seedable
    ``RetryPolicy`` (base = the poll cadence) instead of log-and-retry at
    fixed cadence against a down source; ``last_success_ms`` exposes the
    age of the last good poll (also published to the resilience
    health-probe registry while the loop runs — last good rules keep
    enforcing during an outage, and this is how ops sees how stale
    they are).
    """

    def __init__(self, converter: Converter, recommend_refresh_ms: int = 3000,
                 retry_policy: Optional[RetryPolicy] = None):
        super().__init__(converter)
        self.refresh_ms = recommend_refresh_ms
        self.retry_policy = retry_policy or RetryPolicy.from_config(
            "datasource", base_ms=max(1, recommend_refresh_ms),
            max_ms=max(60_000, recommend_refresh_ms * 20))
        self._retry_session = self.retry_policy.session()
        self._last_success_ms = -1
        self._last_check_ms = -1
        self.consecutive_failures = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._probe_off: Optional[Callable[[], None]] = None

    @property
    def last_success_ms(self) -> int:
        """Clock time of the last successful READ (-1: never). A source
        that simply hasn't changed keeps this at the last real read —
        watch ``last_check_ms``/``consecutiveFailures`` for liveness."""
        return self._last_success_ms

    @property
    def last_check_ms(self) -> int:
        """Clock time of the last error-free poll, including polls
        skipped as unmodified (-1: never)."""
        return self._last_check_ms

    def health(self) -> dict:
        return {"lastSuccessMs": self._last_success_ms,
                "lastCheckMs": self._last_check_ms,
                "consecutiveFailures": self.consecutive_failures,
                "refreshMs": self.refresh_ms}

    def start(self, initial_load: bool = True) -> "AutoRefreshDataSource":
        """``initial_load=False`` skips the (error-swallowing) first read —
        for callers that already loaded, validated, and pushed the initial
        value themselves and must not race a second read."""
        if initial_load:
            self.first_load()
        self._probe_off = register_probe(
            f"datasource.{type(self).__name__}.{id(self):x}", self.health)
        self._thread = threading.Thread(
            target=self._run, name="sentinel-datasource-auto-refresh", daemon=True
        )
        self._thread.start()
        return self

    def _acting(self):
        """Provenance context for the audit journal: every
        rule/objective/target load this source pushes records
        ``datasource:<ClassName>`` as its actor."""
        from sentinel_tpu_torch.telemetry.journal import acting

        return acting(f"datasource:{type(self).__name__}")

    def first_load(self) -> None:
        try:
            value = self.load_config()
            if value is not None:
                with self._acting():
                    self._property.update_value(value)
            self._note_success()
        except Exception as ex:
            _log_warn("datasource initial load failed: %r", ex)

    def is_modified(self) -> bool:
        return True

    def refresh(self, force: bool = False) -> bool:
        """One poll iteration (exposed for deterministic tests); ``force``
        skips the is_modified gate (coarse-mtime filesystems can miss a
        same-tick rewrite). Returns whether the source was actually READ
        (False = skipped as unmodified)."""
        if not force and not self.is_modified():
            return False
        # Flap seam (resilience/faults.py "datasource.flap"):
        # the SOURCE is healthy but the path to it flapped this cycle —
        # the poll fails transiently and catches up on a later cadence
        # tick (distinct from datasource.read, which models the read
        # itself failing inside the connector).
        faults.fire("datasource.flap")
        value = self.load_config()
        if value is not None:
            with self._acting():
                self._property.update_value(value)
        return True

    def _note_success(self) -> None:
        now = time_util.current_time_millis()
        self._last_success_ms = now
        self._last_check_ms = now
        self.consecutive_failures = 0
        self._retry_session.reset()

    def _poll_once(self) -> int:
        """One poll; returns the wait before the next one. Successful
        reads keep the configured cadence; consecutive failures back
        off. Polls skipped by ``is_modified`` leave ``last_success_ms``
        (last real read) and the failure counter alone — a deleted file
        also reads as "unmodified" — but refresh ``last_check_ms``: an
        unchanged-for-hours source is healthy, not stale."""
        try:
            did_read = self.refresh()
        except Exception as ex:  # poll loop survives, with a trace
            self.consecutive_failures += 1
            delay_ms = max(self.refresh_ms,
                           self._retry_session.next_delay_ms())
            _log_warn("datasource refresh failed (%d consecutive, "
                      "next poll in %dms): %r",
                      self.consecutive_failures, delay_ms, ex)
            return delay_ms
        if did_read:
            self._note_success()
        else:
            self._last_check_ms = time_util.current_time_millis()
        return self.refresh_ms

    def _run(self):
        wait_ms = self.refresh_ms
        while not self._stop.wait(wait_ms / 1000.0):
            wait_ms = self._poll_once()

    def close(self) -> None:
        self._stop.set()
        if self._probe_off is not None:
            self._probe_off()
            self._probe_off = None
        if self._thread is not None:
            self._thread.join(timeout=1.0)


class FileRefreshableDataSource(AutoRefreshDataSource[str, T]):
    """Reference: ``FileRefreshableDataSource`` — mtime-polled file source."""

    def __init__(self, file_path: str, converter: Converter,
                 recommend_refresh_ms: int = 3000, charset: str = "utf-8",
                 retry_policy: Optional[RetryPolicy] = None):
        super().__init__(converter, recommend_refresh_ms,
                         retry_policy=retry_policy)
        self.file_path = os.path.abspath(file_path)
        self.charset = charset
        self._last_mtime = -1.0

    def read_source(self) -> str:
        with open(self.file_path, "r", encoding=self.charset) as f:
            return f.read()

    def is_modified(self) -> bool:
        try:
            mtime = os.stat(self.file_path).st_mtime
        except OSError:
            return False
        if mtime != self._last_mtime:
            self._last_mtime = mtime
            return True
        return False

    def first_load(self) -> None:
        try:
            self._last_mtime = os.stat(self.file_path).st_mtime
        except OSError:
            pass
        super().first_load()


class FileWritableDataSource(WritableDataSource[T]):
    """Reference: ``FileWritableDataSource`` — serialize + atomic rewrite."""

    def __init__(self, file_path: str, encoder: Converter, charset: str = "utf-8"):
        self.file_path = os.path.abspath(file_path)
        self.encoder = encoder
        self.charset = charset
        self._lock = threading.Lock()

    def write(self, value: T) -> None:
        text = self.encoder(value)
        with self._lock:
            tmp = self.file_path + ".tmp"
            with open(tmp, "w", encoding=self.charset) as f:
                f.write(text)
            os.replace(tmp, self.file_path)


class ContentDedupPollMixin:
    """``load_config`` for poll connectors whose only change signal is
    the document bytes (Eureka metadata, Spring Cloud Config — neither
    API has a usable change index): ``read_source() -> None`` (absent
    key/instance) or unchanged content pushes nothing and keeps the last
    good rules; ``_applied`` commits only after the converter succeeds,
    so a bad payload can't poison the dedup cache.
    """

    _applied: Optional[str] = None

    def load_config(self):
        faults.fire("datasource.read")
        raw = self.read_source()
        if raw is None or raw == self._applied:
            return None
        value = self.converter(raw)
        if value is not None:
            self._applied = raw
        return value


class ReconnectingWatchMixin:
    """Scaffolding shared by the push connectors (Redis / Nacos / Consul /
    etcd): a daemon watch thread that runs ``_watch_round()`` forever,
    turning any exception in ``_watch_exceptions`` into an exponential-
    backoff reconnect. One implementation so the stop-guard/backoff
    discipline can't drift between connectors.

    Contract for subclasses:
      - call ``_init_watch(reconnect_backoff_ms)`` in ``__init__``,
        ``_start_watching()`` in ``start()``, ``_join_watch()`` in
        ``close()``;
      - implement ``_watch_round()``: ONE connect/park/read cycle; raise
        one of ``_watch_exceptions`` on any failure; call ``_healthy()``
        once the round proves the server is back (resets the backoff);
        return normally when ``self._stop`` is set;
      - override ``_interrupt_watch()`` if a parked round needs an
        explicit kick (e.g. socket shutdown) to notice ``close()``.
    """

    _watch_exceptions: tuple = (OSError, ConnectionError, ValueError)
    _watch_thread_name = "sentinel-datasource-watch"

    def _init_watch(self, reconnect_backoff_ms) -> None:
        self.backoff_min_ms, self.backoff_max_ms = reconnect_backoff_ms
        self._backoff_ms = self.backoff_min_ms
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.reconnect_count = 0  # ops visibility + test hook

    def _start_watching(self) -> None:
        self._thread = threading.Thread(
            target=self._watch_forever, name=self._watch_thread_name,
            daemon=True)
        self._thread.start()

    def _healthy(self) -> None:
        self._backoff_ms = self.backoff_min_ms

    def _watch_round(self) -> None:
        raise NotImplementedError

    def _interrupt_watch(self) -> None:
        pass

    def _watch_forever(self) -> None:
        while not self._stop.is_set():
            try:
                self._watch_round()
            except self._watch_exceptions as ex:
                if self._stop.is_set():
                    break
                self.reconnect_count += 1
                _log_warn("%s lost (%r); retry in %dms",
                          self._watch_thread_name, ex, self._backoff_ms)
                self._stop.wait(self._backoff_ms / 1000.0)
                self._backoff_ms = min(self._backoff_ms * 2,
                                       self.backoff_max_ms)

    def _join_watch(self, timeout_s: float = 2.0) -> None:
        self._stop.set()
        self._interrupt_watch()
        if self._thread is not None:
            # The thread may be parked inside a long poll; it is a daemon
            # and the stop guards discard any post-close push, so an
            # impatient join is safe.
            self._thread.join(timeout=timeout_s)
            self._thread = None


def bind(source: ReadableDataSource, load_rules: Callable) -> None:
    """Attach a datasource to a rule loader (``register2Property`` analog).

    ``load_rules`` is e.g. ``sentinel_tpu_torch.load_flow_rules`` or a manager's
    ``load_rules`` bound method; every push re-loads the family wholesale
    (§3.2 swap semantics).
    """
    source.property.add_listener(SimplePropertyListener(load_rules))
