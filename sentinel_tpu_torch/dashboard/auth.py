"""Dashboard authentication (port of ``sentinel_tpu/dashboard/auth.py``).

Reference: ``dashboard:auth/AuthService.java`` +
``SimpleWebAuthServiceImpl`` + ``LoginAuthenticationFilter`` +
``AuthorizationInterceptor`` (SURVEY.md §2.6 "Boot + auth"). Semantics
preserved:

  * credentials come from config (``sentinel.dashboard.auth.username`` /
    ``…password``, env-overridable like every other key); when the
    username is unset/empty, auth is DISABLED and every request passes —
    the reference's ``FakeAuthServiceImpl`` fallback wired by
    ``WebConfig`` when ``auth.username`` is blank;
  * login mints an opaque session token (the reference stores the
    ``AuthUser`` in the servlet session; here the token travels as a
    cookie or ``Authorization: Bearer`` header);
  * the filter exempts the login endpoint, static assets, and the
    machine-registry heartbeat endpoint (engines are not browsers);
    everything else requires a live session;
  * the simple impl grants a logged-in user all privileges
    (``SimpleWebAuthServiceImpl.AuthUserImpl.authTarget`` returns true),
    so there is no per-app ACL here either.

Sessions expire after ``ttl_s`` (default 8h) of age; expiry uses the
injected monotonic clock so tests don't sleep.
"""

from __future__ import annotations

import hmac
import secrets
import threading
import time
from typing import Callable, Dict, NamedTuple, Optional

from sentinel_tpu_torch.core.config import config

AUTH_USERNAME = "sentinel.dashboard.auth.username"
AUTH_PASSWORD = "sentinel.dashboard.auth.password"
DEFAULT_SESSION_TTL_S = 8 * 3600

COOKIE_NAME = "sentinel_dashboard_token"


class AuthUser(NamedTuple):
    username: str

    def auth_target(self, target: str, privilege: str) -> bool:
        """All-privileges once logged in, like ``SimpleWebAuthServiceImpl``."""
        return True


class _Session(NamedTuple):
    user: AuthUser
    expires_at: float


class AuthService:
    """Credential check + in-memory session store."""

    def __init__(self, username: Optional[str] = None,
                 password: Optional[str] = None,
                 ttl_s: float = DEFAULT_SESSION_TTL_S,
                 clock: Callable[[], float] = time.monotonic):
        if username is None:
            username = config.get(AUTH_USERNAME, "") or ""
            password = config.get(AUTH_PASSWORD, "") or ""
        self._username = username
        self._password = password or ""
        self._ttl_s = ttl_s
        self._clock = clock
        self._sessions: Dict[str, _Session] = {}
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        # Both parts must be configured: a username with a blank password
        # would otherwise enable auth that accepts an empty password.
        return bool(self._username) and bool(self._password)

    def login(self, username: str, password: str) -> Optional[str]:
        """Return a session token, or None on bad credentials."""
        if not self.enabled:
            return None
        # bytes operands: compare_digest refuses non-ASCII str
        ok_user = hmac.compare_digest(
            (username or "").encode("utf-8"), self._username.encode("utf-8"))
        ok_pass = hmac.compare_digest(
            (password or "").encode("utf-8"), self._password.encode("utf-8"))
        if not (ok_user and ok_pass):
            return None
        token = secrets.token_urlsafe(24)
        with self._lock:
            self._prune()
            self._sessions[token] = _Session(
                AuthUser(username), self._clock() + self._ttl_s)
        return token

    def validate(self, token: Optional[str]) -> Optional[AuthUser]:
        """The logged-in user for ``token``, or None (expired/unknown)."""
        if not token:
            return None
        with self._lock:
            sess = self._sessions.get(token)
            if sess is None:
                return None
            if self._clock() >= sess.expires_at:
                del self._sessions[token]
                return None
            return sess.user

    def logout(self, token: Optional[str]) -> None:
        if token:
            with self._lock:
                self._sessions.pop(token, None)

    def _prune(self) -> None:
        now = self._clock()
        dead = [t for t, s in self._sessions.items() if now >= s.expires_at]
        for t in dead:
            del self._sessions[t]
