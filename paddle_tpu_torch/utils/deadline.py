"""Deadlines and the typed no-hang errors the serving engine and the
comms layer raise.

Counterpart of ``paddle_tpu/utils/deadline.py``, cut to what the serving
path, its gateway and the comms layer use: the ``Deadline`` budget a
request carries as its TTL, a socket exchange across its reads and a
collective across its phases, the typed ``RequestTimeout`` /
``EngineOverloaded`` / ``CommTimeout`` errors, the exact socket read the
gateway's framing is built on (``recv_exact``), the flight-recorder hook
(``set_incident_hook``) and the env-knob readers.
"""
from __future__ import annotations

import os
import socket
import time

__all__ = ["DeadlineExceeded", "RequestTimeout", "EngineOverloaded",
           "CommTimeout", "CheckpointTimeout", "Deadline", "set_incident_hook",
           "recv_exact", "join_bounded", "env_timeout", "env_int"]

# flight-recorder hook (observability/__init__ installs trace's
# record_incident): every DeadlineExceeded construction passes the new
# error to it, so a typed timeout carries its own span timeline. An
# injected callback, so this bottom-layer module never imports upward.
_INCIDENT_HOOK = None


def set_incident_hook(cb) -> None:
    """Install (or clear, with None) the typed-deadline incident hook."""
    global _INCIDENT_HOOK
    _INCIDENT_HOOK = cb


class DeadlineExceeded(TimeoutError):
    """A blocking primitive exceeded its time budget.

    Carries the site ("what was being waited on") and the budget, so the
    error names the stuck dependency instead of a bare "timed out".
    """

    def __init__(self, what: str, timeout: float | None = None,
                 detail: str = ""):
        self.what = what
        self.timeout = timeout
        msg = f"deadline exceeded: {what}"
        if timeout is not None:
            msg += f" (budget {timeout:.3g}s)"
        if detail:
            msg += f" — {detail}"
        super().__init__(msg)
        if _INCIDENT_HOOK is not None:
            try:
                _INCIDENT_HOOK(self)
            except Exception:  # noqa: BLE001 — the recorder must never
                pass           # mask the typed error being raised


class RequestTimeout(DeadlineExceeded):
    """A serving request ran out of its TTL budget: expired while queued
    for admission or evicted mid-decode (partial output kept on the
    request). Either way its KV pages go back to the pool."""


class EngineOverloaded(DeadlineExceeded):
    """Admission rejected at the serving front door: the engine's queue is
    capped out, or the projected queue wait already exceeds the request's
    TTL. Terminal for this submission; ``retry_after_ms`` carries the
    engine's advice for when a queue slot should free."""

    def __init__(self, what: str, timeout: float | None = None,
                 detail: str = "", retry_after_ms: int = 100):
        self.retry_after_ms = int(retry_after_ms)
        super().__init__(what, timeout, detail)


class CommTimeout(DeadlineExceeded):
    """A collective of the comms layer (its quantize, wire or dequantize
    phase) ran out of its PT_COMM_DEADLINE budget: a peer stalled
    mid-collective. The message names the owner and the site."""


class CheckpointTimeout(DeadlineExceeded):
    """A sharded generation commit ran out of budget: a staging owner died
    (or wedged) before its receipt landed, or the COMMIT marker never
    appeared within the committer's bound (distributed/ckpt_manager.py).
    The generation stays uncommitted — readers keep resolving the previous
    committed one, and GC reaps the partial stage."""


class Deadline:
    """One time budget shared across the steps of a blocking operation;
    ``Deadline(None)`` never expires."""

    __slots__ = ("timeout", "what", "_expiry")

    def __init__(self, timeout: float | None, what: str = ""):
        self.timeout = timeout
        self.what = what
        self._expiry = None if timeout is None \
            else time.monotonic() + max(0.0, timeout)

    @property
    def expired(self) -> bool:
        return self._expiry is not None and time.monotonic() >= self._expiry

    def remaining(self, floor: float = 0.0) -> float | None:
        """Budget left (at least ``floor``), or None when unbounded. A
        positive floor keeps socket timeouts from reaching zero; the
        expiry itself is read from ``expired``."""
        if self._expiry is None:
            return None
        return max(floor, self._expiry - time.monotonic())

    def check(self, what: str = "", exc: type = DeadlineExceeded,
              detail: str = "") -> None:
        """Raise ``exc`` (a DeadlineExceeded subclass) if the budget is
        gone."""
        if self.expired:
            raise exc(what or self.what or "blocking operation",
                      self.timeout, detail)

    def sleep(self, secs: float) -> None:
        """Sleep at most ``secs``, never past the deadline."""
        rem = self.remaining()
        time.sleep(secs if rem is None else min(secs, rem))


def recv_exact(sock, n: int, dl: Deadline | None = None,
               closed_exc: type = ConnectionError,
               what: str = "peer closed mid-message") -> bytes:
    """Read exactly ``n`` bytes. With a Deadline every chunk re-arms the
    socket timeout from the remaining budget and expiry is checked between
    chunks, so a peer trickling one byte per poll cannot stretch one read
    past it. Without one the read is unbounded (a server handler thread,
    which owns its own teardown)."""
    buf = b""
    while len(buf) < n:
        if dl is not None:
            if dl.expired:
                raise socket.timeout("read deadline exhausted")
            sock.settimeout(dl.remaining(floor=0.01))
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise closed_exc(what)
        buf += chunk
    return buf


def join_bounded(thread, what: str, env: str = "PT_CKPT_WAIT_TIMEOUT",
                 default: float = 600.0) -> None:
    """Join a worker thread under an env-tunable budget; a thread still
    alive at expiry raises the typed DeadlineExceeded (a writer wedged on
    dead storage must not block its caller forever). Shared by the two
    async-checkpoint wait() paths."""
    budget = env_timeout(env, default)
    thread.join(timeout=budget)
    if thread.is_alive():
        raise DeadlineExceeded(
            what, budget,
            detail="worker thread still running — wedged storage?")


def env_timeout(name: str, default: float) -> float:
    """Read a timeout knob from the environment (seconds; <=0, unset or
    unparseable means the default)."""
    try:
        val = float(os.environ.get(name, ""))
    except ValueError:
        return default
    return val if val > 0 else default


def env_int(name: str, default: int) -> int:
    """Integer sibling of env_timeout, same contract: unset, unparseable,
    or <=0 degrades to the default."""
    try:
        val = int(os.environ.get(name, ""))
    except ValueError:
        return default
    return val if val > 0 else default
