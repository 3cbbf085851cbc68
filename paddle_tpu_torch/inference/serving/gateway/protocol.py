"""PTSG/1 — the serving gateway's wire protocol.

Counterpart of ``paddle_tpu/inference/serving/gateway/protocol.py``, the
same bytes on the wire. An HTTP/1.1-style line protocol over TCP: ASCII
header lines terminated by ``\\n``, a blank
line, then a fixed-length binary body of little-endian int64 token ids.
One request/response exchange per round; connections are keep-alive until
either side closes.

Request::

    PTSG/1 GENERATE            (or PING / METRICS, no headers/body)
    prompt-len: 12             body token count
    max-new-tokens: 16
    ttl: 2.5                   optional; maps onto the engine's per-request
                               Deadline -> typed RequestTimeout on the wire
    temperature: 0.8           optional sampling knobs
    top-p: 0.9
    seed: 7
    eos: 2
    <blank line>
    <prompt-len * 8 bytes>

Response::

    PTSG/1 200 OK
    tokens: 28                 body token count (prompt + generated)
    finish-reason: length
    <blank line>
    <tokens * 8 bytes>

Errors carry the TYPED class name and message instead of a body::

    PTSG/1 408 RequestTimeout
    error: deadline exceeded: serving request 3 ...
    <blank line>

The client re-raises the matching typed error (`RequestTimeout`,
`PoolExhausted`, `SamplingUnsupported`, ...) so a caller over the socket
sees exactly the exceptions the in-process engine raises. An overload
shed (`EngineOverloaded`) answers 429 with a ``retry-after-ms`` header
carrying the engine's computed backoff advice.

``HEALTH`` answers readiness + overload pressure from bookkeeping alone
(``ready`` / ``draining`` / ``pressure`` / ``queued`` / ``active``
headers, no body) — the load-balancer poll never touches the generate
path, so a saturated engine still answers it instantly.

``METRICS`` answers the process metrics registry as Prometheus text in a
``content-length``-sized UTF-8 body (drain-aware: a draining gateway
answers the typed 503 so a scraper never samples a half-stopped process
as healthy).
"""
from __future__ import annotations

import socket as _socket
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from ....utils.deadline import (Deadline, EngineOverloaded, RequestTimeout,
                                recv_exact)

MAGIC = "PTSG/1"
MAX_LINE = 4096          # a header line longer than this is a protocol error
MAX_TOKENS = 1 << 20     # sanity cap on either direction's token payload
MAX_TEXT_BODY = 1 << 26  # content-length (METRICS text) cap — wider than
                         # the token cap so a large registry render never
                         # wedges the scrape behind a mis-labeled
                         # "connection" failure, still bounded vs a
                         # garbage peer

# status codes -> the typed error the client re-raises (the server sends
# type(exc).__name__ beside the code; the CLASS mapping is by code so an
# unknown subclass still surfaces as its base type)
STATUS_OK = 200
STATUS_BAD_REQUEST = 400      # malformed frame / invalid sampling ask
STATUS_TIMEOUT = 408          # typed RequestTimeout (TTL ran out)
STATUS_TOO_LARGE = 413        # sizing error: can never fit the engine
STATUS_EXHAUSTED = 429        # PoolExhausted (permanent=True)
STATUS_INTERNAL = 500         # anything else (incl. injected faults)
STATUS_DRAINING = 503         # gateway is draining: submit rejected


__all__ = ["MAGIC", "ProtocolError", "GatewayDraining", "read_frame",
           "request_frame", "response_frame", "error_frame", "status_of"]


class ProtocolError(ConnectionError):
    """The peer sent bytes that are not a PTSG/1 frame — the stream is
    unparseable from here, so the connection must be closed."""


class GatewayDraining(RuntimeError):
    """Typed submit rejection while the gateway drains for shutdown."""


def pack_tokens(tokens) -> bytes:
    arr = np.asarray(tokens, np.int64).reshape(-1)
    return struct.pack(f"<{arr.size}q", *(int(t) for t in arr))


def unpack_tokens(payload: bytes) -> np.ndarray:
    if len(payload) % 8:
        raise ProtocolError("token payload is not a multiple of 8 bytes")
    return np.frombuffer(payload, "<i8").astype(np.int64)


def read_line(sock, dl: Optional[Deadline], buf: bytearray) -> str:
    """One ``\\n``-terminated ASCII line. `buf` carries bytes read past
    earlier lines (the reader owns one buffer per connection). The
    Deadline bounds the whole read, chunk by chunk, exactly like
    recv_exact — a peer trickling bytes cannot stretch it."""
    while True:
        nl = buf.find(b"\n")
        if nl >= 0:
            line = bytes(buf[:nl])
            del buf[:nl + 1]
            if len(line) > MAX_LINE:
                raise ProtocolError("header line too long")
            return line.decode("ascii", "replace").rstrip("\r")
        if len(buf) > MAX_LINE:
            raise ProtocolError("header line too long")
        if dl is not None:
            if dl.expired:
                raise _socket.timeout("read deadline exhausted")
            sock.settimeout(dl.remaining(floor=0.01))
        chunk = sock.recv(4096)  # bounded by the Deadline when one is given
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk


def read_body(sock, dl: Optional[Deadline], buf: bytearray,
              nbytes: int) -> bytes:
    """The fixed-length binary body following the blank line."""
    take = min(len(buf), nbytes)
    head = bytes(buf[:take])
    del buf[:take]
    if take == nbytes:
        return head
    return head + recv_exact(sock, nbytes - take, dl,
                             what="peer closed mid-body")


def read_frame(sock, dl: Optional[Deadline],
               buf: bytearray) -> Tuple[str, Dict[str, str], bytes]:
    """-> (verb_or_status_line_tail, headers, body). The first line must
    start with the PTSG/1 magic; `tokens`/`prompt-len` headers size the
    body."""
    first = read_line(sock, dl, buf)
    if not first.startswith(MAGIC + " "):
        raise ProtocolError(f"not a {MAGIC} frame: {first[:60]!r}")
    head = first[len(MAGIC) + 1:]
    headers: Dict[str, str] = {}
    while True:
        line = read_line(sock, dl, buf)
        if not line:
            break
        key, sep, val = line.partition(":")
        if not sep:
            raise ProtocolError(f"malformed header line {line[:60]!r}")
        headers[key.strip().lower()] = val.strip()
    try:
        n = int(headers.get("tokens", headers.get("prompt-len", 0)) or 0)
        # a text body (the METRICS verb) is sized in raw bytes, not tokens
        nbytes = int(headers["content-length"]) \
            if "content-length" in headers else n * 8
    except ValueError as e:
        # a malformed size leaves the (unsized) body unconsumed — the
        # stream is desynced from here, so this MUST be the typed
        # connection-closing error, never an answer-and-continue
        raise ProtocolError(f"malformed token count: {e}") from e
    cap = MAX_TEXT_BODY if "content-length" in headers else MAX_TOKENS * 8
    if n < 0 or n > MAX_TOKENS or nbytes < 0 or nbytes > cap:
        raise ProtocolError(f"body size {nbytes} out of range")
    body = read_body(sock, dl, buf, nbytes) if nbytes else b""
    return head, headers, body


def request_frame(prompt, max_new_tokens: int, ttl: Optional[float],
                  temperature: Optional[float], top_p: Optional[float],
                  seed: Optional[int], eos: Optional[int]) -> bytes:
    arr = np.asarray(prompt, np.int64).reshape(-1)
    lines = [f"{MAGIC} GENERATE", f"prompt-len: {arr.size}",
             f"max-new-tokens: {int(max_new_tokens)}"]
    if ttl is not None:
        lines.append(f"ttl: {float(ttl)!r}")
    if temperature is not None:
        lines.append(f"temperature: {float(temperature)!r}")
    if top_p is not None:
        lines.append(f"top-p: {float(top_p)!r}")
    if seed is not None:
        lines.append(f"seed: {int(seed)}")
    if eos is not None:
        lines.append(f"eos: {int(eos)}")
    return ("\n".join(lines) + "\n\n").encode("ascii") + pack_tokens(arr)


def ping_frame() -> bytes:
    return f"{MAGIC} PING\n\n".encode("ascii")


def metrics_frame() -> bytes:
    """The METRICS verb: scrape the process metrics registry
    (observability/metrics.py Prometheus text) over the wire."""
    return f"{MAGIC} METRICS\n\n".encode("ascii")


def text_response_frame(text: str) -> bytes:
    """A 200 whose body is raw UTF-8 text sized by ``content-length``
    (the METRICS response — token framing stays untouched)."""
    payload = text.encode("utf-8")
    return (f"{MAGIC} {STATUS_OK} OK\ncontent-length: {len(payload)}\n\n"
            ).encode("ascii") + payload


def response_frame(tokens, finish_reason: Optional[str]) -> bytes:
    arr = np.asarray(tokens, np.int64).reshape(-1)
    lines = [f"{MAGIC} {STATUS_OK} OK", f"tokens: {arr.size}"]
    if finish_reason:
        lines.append(f"finish-reason: {finish_reason}")
    return ("\n".join(lines) + "\n\n").encode("ascii") + pack_tokens(arr)


def error_frame(status: int, exc: BaseException,
                extra_headers: Optional[Dict[str, str]] = None) -> bytes:
    name = type(exc).__name__
    msg = str(exc).replace("\n", " ")[:1024]
    lines = [f"{MAGIC} {status} {name}", f"error: {msg}"]
    for key, val in (extra_headers or {}).items():
        lines.append(f"{key}: {val}")
    return ("\n".join(lines) + "\n\n").encode("ascii", "replace")


def error_headers(exc: BaseException) -> Dict[str, str]:
    """Typed-error headers that ride beside the status line: an overload
    shed's 429 carries the engine's computed ``retry-after-ms`` so the
    client's backoff is advised, not guessed."""
    if isinstance(exc, EngineOverloaded):
        return {"retry-after-ms": str(exc.retry_after_ms)}
    return {}


def health_frame() -> bytes:
    """The HEALTH verb: drain-aware readiness + current overload-ladder
    pressure, answered entirely from gateway/engine bookkeeping — a load
    balancer polling it never touches the generate path."""
    return f"{MAGIC} HEALTH\n\n".encode("ascii")


def health_response_frame(ready: bool, draining: bool, pressure: int,
                          queued: int, active: int) -> bytes:
    return (f"{MAGIC} {STATUS_OK} OK\n"
            f"ready: {int(bool(ready))}\n"
            f"draining: {int(bool(draining))}\n"
            f"pressure: {int(pressure)}\n"
            f"queued: {int(queued)}\n"
            f"active: {int(active)}\n\n").encode("ascii")


def status_of(exc: BaseException) -> int:
    """Map an engine-side exception to its wire status."""
    from ..kv_pool import PageUncommitted, PoolExhausted
    from ..engine import SamplingUnsupported
    if isinstance(exc, EngineOverloaded):
        # checked BEFORE RequestTimeout: both are DeadlineExceeded, but an
        # overload shed is retryable-later (429 + retry-after-ms) while a
        # TTL expiry is this request's terminal 408
        return STATUS_EXHAUSTED
    if isinstance(exc, RequestTimeout):
        return STATUS_TIMEOUT
    if isinstance(exc, GatewayDraining):
        return STATUS_DRAINING
    if isinstance(exc, PoolExhausted):
        return STATUS_EXHAUSTED
    if isinstance(exc, SamplingUnsupported):
        return STATUS_BAD_REQUEST
    if isinstance(exc, PageUncommitted):
        # refcount-law violation inside the engine — a server bug, not a
        # client mistake: surfaces as the typed 500
        return STATUS_INTERNAL
    if isinstance(exc, (ValueError, ProtocolError)):
        return STATUS_TOO_LARGE if "max_seq_len" in str(exc) \
            else STATUS_BAD_REQUEST
    return STATUS_INTERNAL
