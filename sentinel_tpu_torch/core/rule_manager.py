"""Shared rule-registry base (reference: the ``XxxRuleManager`` pattern —
SURVEY.md §1 "Rules are data, managers are registries").

Every family keeps a list rebuilt wholesale on load (§3.2 swap semantics),
filters invalid rules, and fans out to engine listeners for tensor rebuild.

Staged sources (``rollout/``): a rule carrying ``candidate_set`` is part
of a named CANDIDATE ruleset — it rides the same wholesale load, but lands
in a per-set staged partition instead of the live list, so a tagged rule
can never leak into enforcement. The rollout manager reads the staged
partitions through :meth:`get_staged` on every push and stages them as a
candidate (``RolloutManager.refresh_staged``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Generic, List, TypeVar

R = TypeVar("R")


class RuleManager(Generic[R]):
    def __init__(self):
        self._lock = threading.RLock()
        self._rules: List[R] = []
        self._staged: Dict[str, List[R]] = {}
        self.version = 0
        self._listeners: List[Callable[[], None]] = []

    def load_rules(self, rules: List[R]) -> None:
        with self._lock:
            live: List[R] = []
            staged: Dict[str, List[R]] = {}
            for r in rules:
                if not r.is_valid():
                    continue
                cs = getattr(r, "candidate_set", None)
                if cs:
                    staged.setdefault(cs, []).append(r)
                else:
                    live.append(r)
            self._rules = live
            self._staged = staged
            self.version += 1
            listeners = list(self._listeners)
        for fn in listeners:
            fn()

    def get_rules(self) -> List[R]:
        """The LIVE (enforced) partition only."""
        with self._lock:
            return list(self._rules)

    def get_staged(self, name: str = None):
        """Staged candidate rules: ``{set_name: rules}`` (or one set's
        list when ``name`` is given). Valid-filtered like the live list."""
        with self._lock:
            if name is not None:
                return list(self._staged.get(name, []))
            return {k: list(v) for k, v in self._staged.items()}

    def add_listener(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._listeners.append(fn)
