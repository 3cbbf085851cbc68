"""GatewayClient: typed-deadline client for the PTSG/1 serving gateway.

Counterpart of ``paddle_tpu/inference/serving/gateway/client.py``. One
connection, one in-flight request at a time (a lock serialises; make one
client per parallel stream). It connects with jittered backoff, verifies
the server with a PING, and carries every exchange under one Deadline:

- the response wait is bounded by the request's TTL plus a grace, or by
  an explicit ``timeout=``; a timeout mid-exchange closes the connection
  (the stream is desynced) and raises the typed RequestTimeout;
- a connection loss reconnects and retries once (greedy or seeded
  generation replays the same tokens);
- error frames re-raise the engine's typed exception class.

Self-protection: a 429 EngineOverloaded frame's ``retry-after-ms`` is
honoured with jittered bounded backoff (``PT_GATEWAY_BREAKER_RETRIES``);
after ``PT_GATEWAY_BREAKER_THRESHOLD`` consecutive typed overloads or
timeouts the circuit breaker opens and calls fail locally with the typed
``CircuitOpen`` for ``PT_GATEWAY_BREAKER_COOLDOWN`` seconds, then one
half-open probe goes through. ``health()`` is breaker-exempt.
"""
from __future__ import annotations

import random
import socket
import threading
import time
from typing import Dict, Optional

import numpy as np

from ....utils.deadline import (Deadline, EngineOverloaded, RequestTimeout,
                                env_int, env_timeout)
from . import protocol as proto

__all__ = ["GatewayClient", "GatewayConnectionError", "CircuitOpen"]

_BACKOFF_BASE = 0.02
_BACKOFF_CAP = 1.0


def _backoff_delay(attempt: int) -> float:
    """Bounded exponential backoff with full jitter."""
    exp = min(_BACKOFF_CAP, _BACKOFF_BASE * (2 ** min(attempt, 16)))
    return random.uniform(_BACKOFF_BASE / 2, exp)


class GatewayConnectionError(ConnectionError):
    """Terminal client failure: the gateway connection died (or desynced)
    and reconnect-plus-retry did not recover it."""


class CircuitOpen(RuntimeError):
    """The client's circuit breaker is open: the last
    ``PT_GATEWAY_BREAKER_THRESHOLD`` exchanges all failed with typed
    overloads/timeouts, so calls fail fast LOCALLY (no wire traffic)
    until the cooldown elapses and a half-open probe succeeds. Carries
    ``retry_after_ms`` — the cooldown remainder — like the server-side
    429 it shields."""

    def __init__(self, host: str, port: int, fails: int,
                 retry_after_ms: int):
        self.retry_after_ms = int(retry_after_ms)
        self.fails = int(fails)
        super().__init__(
            f"gateway {host}:{port} circuit open after {fails} consecutive "
            f"typed overload/timeout failures — retry locally rejected for "
            f"{retry_after_ms}ms (half-open probe follows)")


def _typed_error(status: int, name: str, msg: str,
                 budget: Optional[float],
                 headers: Optional[Dict[str, str]] = None) -> BaseException:
    if status == proto.STATUS_EXHAUSTED and name == "EngineOverloaded":
        # discriminated from PoolExhausted (same 429) by the class name on
        # the status line; the retry-after-ms header rides into the attr
        # the backoff below reads
        try:
            retry_ms = int((headers or {}).get("retry-after-ms", "") or 0)
        except ValueError:
            retry_ms = 0
        return EngineOverloaded("gateway generate", budget, detail=msg,
                                retry_after_ms=retry_ms)
    if status == proto.STATUS_TIMEOUT:
        return RequestTimeout(f"gateway request ({name})", budget,
                              detail=msg)
    if status == proto.STATUS_EXHAUSTED:
        # reconstructed with the SERVER's message; the class attrs exist
        # (None = unknown over the wire) so in-process except clauses that
        # read them keep working, they just can't see the peer's numbers
        from ..kv_pool import PoolExhausted
        e = PoolExhausted.__new__(PoolExhausted)
        RuntimeError.__init__(e, msg)
        e.need = e.free = e.total = None
        e.permanent = True
        return e
    if status == proto.STATUS_DRAINING:
        return proto.GatewayDraining(msg)
    if status == proto.STATUS_BAD_REQUEST and name == "SamplingUnsupported":
        from ..engine import SamplingUnsupported
        e = SamplingUnsupported.__new__(SamplingUnsupported)
        NotImplementedError.__init__(e, msg)
        e.param = e.value = None
        return e
    if status in (proto.STATUS_BAD_REQUEST, proto.STATUS_TOO_LARGE):
        return ValueError(msg)
    if name == "FaultInjected":
        from ....distributed.chaos import FaultInjected
        return FaultInjected("gateway.remote")
    return RuntimeError(f"gateway error {status} {name}: {msg}")


class GatewayClient:
    def __init__(self, host: str, port: int,
                 connect_timeout: Optional[float] = None):
        self.host, self.port = host, int(port)
        self._connect_timeout = (connect_timeout if connect_timeout
                                 is not None else
                                 env_timeout("PT_GATEWAY_CONNECT_TIMEOUT",
                                             10.0))
        # REENTRANT: the mid-exchange reconnect path re-enters _exchange
        # through the ping handshake while the outer exchange holds it
        self._lock = threading.RLock()
        self._sock: Optional[socket.socket] = None
        self._buf = bytearray()
        # circuit breaker (see module docstring): consecutive typed
        # overload/timeout failures trip it; _breaker_open_until != 0
        # means tripped — before it: fail fast; past it: half-open probe
        self._breaker_threshold = env_int("PT_GATEWAY_BREAKER_THRESHOLD", 5)
        self._breaker_cooldown = env_timeout("PT_GATEWAY_BREAKER_COOLDOWN",
                                             1.0)
        self._breaker_fails = 0
        self._breaker_open_until = 0.0
        self._connect(self._connect_timeout)

    # ------------------------------------------------------------------
    # circuit breaker
    # ------------------------------------------------------------------
    def _breaker_gate(self) -> None:
        """Raise the typed CircuitOpen while tripped and cooling; past the
        cooldown the call proceeds as the ONE half-open probe (a failure
        re-trips for a fresh cooldown, a success closes)."""
        with self._lock:
            remaining = self._breaker_open_until - time.monotonic()
            if remaining > 0:
                raise CircuitOpen(self.host, self.port, self._breaker_fails,
                                  max(1, int(remaining * 1000)))

    def _breaker_record(self, ok: bool) -> None:
        with self._lock:
            if ok:
                self._breaker_fails = 0
                self._breaker_open_until = 0.0
                return
            self._breaker_fails += 1
            half_open_probe_failed = self._breaker_open_until != 0.0
            if half_open_probe_failed \
                    or self._breaker_fails >= self._breaker_threshold:
                self._breaker_open_until = \
                    time.monotonic() + self._breaker_cooldown

    @property
    def breaker_open(self) -> bool:
        with self._lock:
            return time.monotonic() < self._breaker_open_until

    # ------------------------------------------------------------------
    def _connect(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        last: Optional[BaseException] = None
        attempt = 0
        while time.monotonic() < deadline:
            try:
                self._sock = socket.create_connection(
                    (self.host, self.port), timeout=5)
                self._sock.setsockopt(socket.IPPROTO_TCP,
                                      socket.TCP_NODELAY, 1)
                self._buf.clear()
                self.ping(timeout=5.0)
                return
            except (OSError, ConnectionError) as e:
                last = e
                self._teardown()
            time.sleep(min(_backoff_delay(attempt),
                           max(0.0, deadline - time.monotonic())))
            attempt += 1
        raise GatewayConnectionError(
            f"gateway: cannot connect {self.host}:{self.port}: {last}")

    def _teardown(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._buf.clear()

    @property
    def alive(self) -> bool:
        return self._sock is not None

    def close(self) -> None:
        with self._lock:
            self._teardown()

    # ------------------------------------------------------------------
    def _exchange(self, frame: bytes, dl: Deadline, budget,
                  retry: bool = True):
        """Send one frame, read one frame, typed errors throughout. A
        connection loss reconnects and retries EXACTLY once (idempotent:
        generation is deterministic per request); a deadline expiry is
        typed immediately with the connection poisoned."""
        with self._lock:
            for attempt in (0, 1):
                if self._sock is None:
                    # dead at entry (earlier exchange poisoned it):
                    # reconnect before anything is sent
                    self._connect(min(self._connect_timeout,
                                      dl.remaining(floor=0.1) or
                                      self._connect_timeout))
                try:
                    self._sock.settimeout(dl.remaining(floor=0.01))
                    self._sock.sendall(frame)
                    return proto.read_frame(self._sock, dl, self._buf)
                except socket.timeout as e:
                    self._teardown()  # mid-message: stream desynced
                    raise RequestTimeout(
                        f"gateway {self.host}:{self.port}", budget,
                        detail="no response within the budget; connection "
                               "closed to prevent desync") from e
                except (ConnectionError, OSError) as e:
                    self._teardown()
                    if not retry or attempt:
                        raise GatewayConnectionError(
                            f"gateway connection lost: {e}") from e
                    # fall through: reconnect + single retry

    # ------------------------------------------------------------------
    def ping(self, timeout: float = 5.0) -> None:
        dl = Deadline(timeout, what="gateway ping")
        head, _, _ = self._exchange(proto.ping_frame(), dl, timeout,
                                    retry=False)
        if not head.startswith(str(proto.STATUS_OK)):
            raise GatewayConnectionError(f"gateway ping rejected: {head!r}")

    def metrics(self, timeout: float = 10.0) -> str:
        """Scrape the gateway process's metrics registry (the PTSG/1
        METRICS verb): returns the Prometheus text exactly as the server
        rendered it. Raises the typed GatewayDraining on a draining
        gateway (503 on the wire) — a scraper must see the drain, not a
        healthy-looking half-sample."""
        dl = Deadline(timeout, what=f"gateway metrics "
                                    f"{self.host}:{self.port}")
        head, headers, body = self._exchange(proto.metrics_frame(), dl,
                                             timeout)
        parts = head.split(None, 1)
        status = int(parts[0])
        if status != proto.STATUS_OK:
            raise _typed_error(status, parts[1] if len(parts) > 1 else "",
                               headers.get("error", head), timeout)
        return body.decode("utf-8")

    def health(self, timeout: float = 5.0) -> dict:
        """Poll the gateway's drain-aware HEALTH verb: readiness +
        current overload-ladder pressure, answered from bookkeeping alone
        (never touches the generate path). Breaker-exempt by design — a
        load balancer must be able to watch a tripped backend recover."""
        dl = Deadline(timeout, what=f"gateway health "
                                    f"{self.host}:{self.port}")
        head, headers, _ = self._exchange(proto.health_frame(), dl, timeout)
        parts = head.split(None, 1)
        status = int(parts[0])
        if status != proto.STATUS_OK:
            raise _typed_error(status, parts[1] if len(parts) > 1 else "",
                               headers.get("error", head), timeout, headers)

        def _i(key):
            try:
                return int(headers.get(key, "") or 0)
            except ValueError:
                return 0

        return {"ready": headers.get("ready") == "1",
                "draining": headers.get("draining") == "1",
                "pressure": _i("pressure"), "queued": _i("queued"),
                "active": _i("active")}

    def generate(self, prompt_ids, max_new_tokens: int = 16,
                 ttl: Optional[float] = None,
                 timeout: Optional[float] = None,
                 temperature: Optional[float] = None,
                 top_p: Optional[float] = None,
                 seed: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 retries: Optional[int] = None) -> np.ndarray:
        """Round-trip one request; returns prompt+generated tokens exactly
        as the in-process `Request.result()` would (bitwise — the gateway
        adds transport, never math). Raises the engine's typed errors.

        A 429 `EngineOverloaded` answer is retried up to ``retries`` times
        (default ``PT_GATEWAY_BREAKER_RETRIES``, 2), each wait the frame's
        ``retry-after-ms`` advice plus up to 25% jitter, never past the
        request's own deadline; consecutive typed overloads/timeouts feed
        the circuit breaker, which fails fast with `CircuitOpen` once
        tripped (``retries=0`` disables the backoff, not the breaker)."""
        if ttl is not None:
            budget = float(ttl) + env_timeout("PT_GATEWAY_TTL_GRACE", 10.0)
        else:
            budget = env_timeout("PT_GATEWAY_CLIENT_TIMEOUT", 300.0)
        if timeout is not None:
            budget = float(timeout)
        dl = Deadline(budget, what=f"gateway generate "
                                   f"{self.host}:{self.port}")
        frame = proto.request_frame(prompt_ids, max_new_tokens, ttl,
                                    temperature, top_p, seed, eos_token_id)
        # retry-once is sound only when a replay provably regenerates the
        # SAME stream: greedy always, sampled only with an explicit seed
        # (the server defaults an omitted seed to the request id, which
        # differs per submission — and the orphaned original would keep
        # decoding, so an unseeded duplicate is a correctness bug twice)
        retryable = temperature is None or seed is not None
        max_retries = env_int("PT_GATEWAY_BREAKER_RETRIES", 2) \
            if retries is None else max(0, int(retries))
        attempt = 0
        while True:
            self._breaker_gate()
            try:
                head, headers, body = self._exchange(frame, dl, budget,
                                                     retry=retryable)
            except RequestTimeout:
                # socket-level expiry (wedged/partitioned server): a typed
                # timeout, so it feeds the breaker like a frame-level 408
                self._breaker_record(ok=False)
                raise
            parts = head.split(None, 1)
            status = int(parts[0])
            name = parts[1] if len(parts) > 1 else ""
            if status == proto.STATUS_OK:
                self._breaker_record(ok=True)
                return proto.unpack_tokens(body)
            err = _typed_error(status, name, headers.get("error", head),
                               budget, headers)
            if isinstance(err, (EngineOverloaded, RequestTimeout)):
                self._breaker_record(ok=False)
            if isinstance(err, EngineOverloaded) and attempt < max_retries:
                # the server's advice, jittered so a shed burst of clients
                # does not resubmit in lockstep; bounded by our own
                # deadline — waiting past it just converts 429 into 408
                wait = max(0.001, err.retry_after_ms / 1000.0) \
                    * (1.0 + 0.25 * random.random())
                remaining = dl.remaining()
                if (remaining is None or wait < remaining) \
                        and not self.breaker_open:
                    attempt += 1
                    time.sleep(wait)
                    continue
            raise err
