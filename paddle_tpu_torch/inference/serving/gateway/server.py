"""ServingGateway: the engine behind a socket.

Counterpart of ``paddle_tpu/inference/serving/gateway/server.py``. A
threaded TCP listener (one accept loop, one handler thread per
connection) in front of ONE ServingEngine, plus a driver thread that owns
the engine's step loop: the engine's single-driver contract holds, and
handler threads only submit() and wait().

- every connection's request read runs under a per-connection read
  deadline (``PT_GATEWAY_READ_TIMEOUT``, default 30 s): an idle or
  trickling peer is closed, never parked;
- a request's TTL header becomes the engine's per-request Deadline, and
  the typed RequestTimeout travels back as a 408 frame;
- a TTL-less request's wait is bounded too (``PT_GATEWAY_REQUEST_TIMEOUT``,
  default 300 s -> 408);
- ``stop(drain=True)`` closes the listener, lets in-flight requests finish
  under ``PT_GATEWAY_DRAIN_TIMEOUT``, then stops the driver and joins
  every thread the gateway started.

Chaos: ``gateway.accept``, ``gateway.read`` and ``gateway.admit`` are
registered fault sites (crash/delay/error/drop).
"""
from __future__ import annotations

import socket
import threading
import time
import weakref
from typing import Optional

from ....observability import trace
from ....utils.deadline import Deadline, env_timeout
from ....distributed.chaos import faultpoint, register_fault
from ..request import Request
from . import protocol as proto

__all__ = ["ServingGateway", "gateway_info"]

FP_ACCEPT = register_fault(
    "gateway.accept", "every accepted gateway connection passes here")
FP_READ = register_fault(
    "gateway.read", "every gateway request read passes here")
FP_ADMIT = register_fault(
    "gateway.admit", "every GENERATE passes here before engine.submit — "
    "the gateway-side admission edge (drain check + overload shed)")

_GATEWAYS: "weakref.WeakSet[ServingGateway]" = weakref.WeakSet()


class ServingGateway:
    """Serve one engine over TCP. ``port=0`` binds an ephemeral port
    (read it back from ``self.port``)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 read_timeout: Optional[float] = None, poll: float = 0.001):
        self.engine = engine
        self.read_timeout = (read_timeout if read_timeout is not None
                             else env_timeout("PT_GATEWAY_READ_TIMEOUT",
                                              30.0))
        self._poll = float(poll)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(128)
        self.host, self.port = host, self._sock.getsockname()[1]
        self._stopping = False
        self._draining = False
        self._lock = threading.Lock()
        self._conns: set = set()
        # accepted-but-not-yet-submitted/answered exchanges: drain() must
        # wait these out too — engine idleness alone can't see a handler
        # that read a frame but has not reached submit() yet
        self._inflight = 0
        self._handlers: list = []
        self.counters = {"connections": 0, "requests": 0, "responses": 0,
                         "errors": 0, "read_timeouts": 0,
                         "protocol_errors": 0, "driver_errors": 0,
                         "metrics_scrapes": 0}
        self._status_counts: dict = {}
        self._driver = threading.Thread(target=self._drive, daemon=True,
                                        name=f"gateway-driver:{self.port}")
        self._driver.start()
        self._accept = threading.Thread(target=self._accept_loop, daemon=True,
                                        name=f"gateway-accept:{self.port}")
        self._accept.start()
        _GATEWAYS.add(self)

    # ------------------------------------------------------------------
    # the engine driver: ONE thread owns step()/run() (engine contract)
    # ------------------------------------------------------------------
    def _drive(self):
        while not self._stopping:
            try:
                if not self.engine.scheduler.idle:
                    self.engine.step()
                else:
                    time.sleep(self._poll)
            except Exception:  # noqa: BLE001 — the driver must survive:
                # an exception escaping step() (a bad lowering, a
                # transient backend failure) would otherwise silently
                # kill the ONLY thread stepping the engine and turn the
                # gateway into a 408 generator with no signal. Count it,
                # back off, keep driving — per-request failures still
                # reach their callers typed through result().
                with self._lock:
                    self.counters["driver_errors"] += 1
                time.sleep(max(self._poll, 0.05))

    # ------------------------------------------------------------------
    # accept + per-connection handlers
    # ------------------------------------------------------------------
    def _accept_loop(self):
        while not self._stopping:
            try:
                fd, _ = self._sock.accept()
            except OSError:
                return  # listener closed: shutdown/drain began
            try:
                # chaos: a fault armed here hits the connection BEFORE any
                # request is parsed — error/drop modes close it (the
                # client's reconnect-and-retry absorbs that, like a dead
                # load-balancer hop), delay stalls it into the client's
                # deadline, crash is the preempted-server case
                faultpoint(FP_ACCEPT)
            except Exception:  # noqa: BLE001 — injected fault: drop the conn
                try:
                    fd.close()
                except OSError:
                    pass
                continue
            with self._lock:
                if self._stopping:
                    fd.close()
                    continue
                self.counters["connections"] += 1
                self._conns.add(fd)
                t = threading.Thread(target=self._handle, args=(fd,),
                                     daemon=True,
                                     name=f"gateway-conn:{self.port}")
                self._handlers = [h for h in self._handlers
                                  if h.is_alive()] + [t]
            t.start()

    def _count_status(self, status: int):
        with self._lock:
            self._status_counts[status] = \
                self._status_counts.get(status, 0) + 1
            if status != proto.STATUS_OK:
                self.counters["errors"] += 1

    def _handle(self, fd):
        fd.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        buf = bytearray()
        try:
            while not self._stopping:
                try:
                    # per-connection read deadline: the frame read is
                    # bounded chunk-by-chunk, so an idle keep-alive or a
                    # trickling peer is closed at the deadline. The chaos
                    # site sits on the read-to-serve edge — it fires once
                    # per REQUEST read, so an armed mode hits a live
                    # exchange deterministically, never an idle poll
                    dl = Deadline(self.read_timeout,
                                  what=f"gateway read :{self.port}")
                    head, headers, body = proto.read_frame(fd, dl, buf)
                    # an EVENT, not a span around the read: a span would
                    # record every idle keep-alive poll's full read-
                    # deadline wait and churn the bounded ring with idle
                    # records — the event marks only served reads (the
                    # chaos faultpoint below stamps its own record when
                    # armed, so an incident timeline still ends here)
                    trace.event("gateway.read", port=self.port)
                    faultpoint(FP_READ)
                except socket.timeout:
                    with self._lock:
                        self.counters["read_timeouts"] += 1
                    return
                except proto.ProtocolError:
                    with self._lock:
                        self.counters["protocol_errors"] += 1
                    return
                except ConnectionError:
                    return  # peer went away (or an injected drop): close
                except Exception as e:  # noqa: BLE001 — injected error mode:
                    # answer typed so the client re-raises it, keep serving
                    self._count_status(proto.STATUS_INTERNAL)
                    fd.sendall(proto.error_frame(proto.STATUS_INTERNAL, e))
                    continue
                # the read loop armed per-chunk timeouts from the read
                # deadline; the RESPONSE send must not inherit whatever
                # near-zero remainder a slow-but-valid request left behind
                # — but it stays bounded (a peer that stops READING would
                # otherwise park this handler in sendall forever once the
                # kernel buffer fills, pinning _inflight past every drain)
                fd.settimeout(env_timeout("PT_GATEWAY_SEND_TIMEOUT", 30.0))
                if head.startswith("PING"):
                    fd.sendall(proto.response_frame([], None))
                    continue
                if head.startswith("HEALTH"):
                    # answered from bookkeeping alone — never touches the
                    # generate path, so the LB poll works at any pressure.
                    # 200 even while draining: "reachable but not ready"
                    # is exactly what the ready/draining headers encode
                    eng = self.engine
                    self._count_status(proto.STATUS_OK)
                    fd.sendall(proto.health_response_frame(
                        ready=not (self._draining or self._stopping),
                        draining=self._draining or self._stopping,
                        pressure=getattr(eng, "pressure_level", 0),
                        queued=eng.scheduler.queue_depth,
                        active=eng.scheduler.active))
                    continue
                if head.startswith("METRICS"):
                    # drain-aware like GENERATE: a draining gateway answers
                    # the typed 503 (a scraper must never sample a half-
                    # stopped process as healthy), a live one renders the
                    # registry — engine counters included, so a wire scrape
                    # round-trips metrics_snapshot() exactly
                    if self._draining or self._stopping:
                        self._count_status(proto.STATUS_DRAINING)
                        fd.sendall(proto.error_frame(
                            proto.STATUS_DRAINING,
                            proto.GatewayDraining(
                                "gateway is draining for shutdown — "
                                "scrape elsewhere")))
                        continue
                    from ....observability import metrics as _metrics
                    self._count_status(proto.STATUS_OK)
                    with self._lock:
                        self.counters["metrics_scrapes"] += 1
                    fd.sendall(proto.text_response_frame(
                        _metrics.render_prometheus()))
                    continue
                if not head.startswith("GENERATE"):
                    self._count_status(proto.STATUS_BAD_REQUEST)
                    fd.sendall(proto.error_frame(
                        proto.STATUS_BAD_REQUEST,
                        proto.ProtocolError(f"unknown verb {head[:20]!r}")))
                    continue
                with self._lock:
                    self.counters["requests"] += 1
                    self._inflight += 1
                try:
                    # the SEND stays inside the inflight-covered window:
                    # drain() observing inflight == 0 must imply the reply
                    # already left, or stop()'s connection teardown could
                    # strand a finished request's bytes
                    try:
                        reply = self._serve_one(headers, body)
                    except ConnectionError:
                        # an injected drop at the admission edge simulates
                        # the wire dying mid-exchange: close the conn, the
                        # client's reconnect-and-retry absorbs it
                        return
                    except BaseException as e:  # noqa: BLE001 — typed onto the wire
                        status = proto.status_of(e)
                        self._count_status(status)
                        fd.sendall(proto.error_frame(
                            status, e, proto.error_headers(e)))
                        continue
                    self._count_status(proto.STATUS_OK)
                    with self._lock:
                        self.counters["responses"] += 1
                    fd.sendall(reply)
                finally:
                    with self._lock:
                        self._inflight -= 1
        except OSError:
            pass
        finally:
            with self._lock:
                self._conns.discard(fd)
            try:
                fd.close()
            except OSError:
                pass

    def _serve_one(self, headers, body) -> bytes:
        # chaos: the admission edge — a fault armed here hits the request
        # AFTER its frame parsed but BEFORE any engine state exists, the
        # exact window an overload shed occupies
        faultpoint(FP_ADMIT)
        if self._draining or self._stopping:
            raise proto.GatewayDraining(
                "gateway is draining for shutdown — resubmit elsewhere")
        prompt = proto.unpack_tokens(body)
        ttl = headers.get("ttl")
        temp = headers.get("temperature")
        top_p = headers.get("top-p")
        seed = headers.get("seed")
        eos = headers.get("eos")
        # the wire-side span of one request: the engine's request id lands
        # on it at submit, so a Chrome-trace timeline links this span to
        # every engine.prefill/decode/verify span that served the rid
        with trace.span("gateway.request", port=self.port) as sp:
            req: Request = self.engine.submit(
                prompt,
                max_new_tokens=int(headers.get("max-new-tokens", 16)),
                ttl=float(ttl) if ttl is not None else None,
                temperature=float(temp) if temp is not None else None,
                top_p=float(top_p) if top_p is not None else None,
                seed=int(seed) if seed is not None else None,
                eos_token_id=int(eos) if eos is not None else None)
            sp.set(rid=req.rid, prompt_len=int(prompt.size))
            # the wait is ALWAYS bounded: the request's own TTL (+grace for
            # the final decode step) when it has one, the gateway request
            # budget otherwise — a wedged driver surfaces as a typed 408,
            # not a parked handler thread
            budget = (float(ttl) + env_timeout("PT_GATEWAY_TTL_GRACE", 10.0)
                      if ttl is not None
                      else env_timeout("PT_GATEWAY_REQUEST_TIMEOUT", 300.0))
            if not req.wait(timeout=budget):
                raise proto.RequestTimeout(
                    f"gateway request {req.rid}", budget,
                    detail="engine did not finish the request within the "
                           "gateway budget")
            tokens = req.result()  # raises the typed error on TTL/cancel
            return proto.response_frame(tokens, req.finish_reason)

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------
    def _close_listener(self) -> None:
        """Close the listening socket; the shutdown wakes a thread blocked
        in accept() (a bare close does not on Linux)."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting (503 on new GENERATEs, listener closed) and wait
        for every in-flight request to finish. Returns True when the
        engine went idle within the budget."""
        self._draining = True
        self._close_listener()
        budget = (timeout if timeout is not None
                  else env_timeout("PT_GATEWAY_DRAIN_TIMEOUT", 30.0))
        dl = Deadline(budget, what=f"gateway drain :{self.port}")
        while True:
            with self._lock:
                inflight = self._inflight
            # BOTH must clear: a handler that read a frame but has not
            # submitted yet is invisible to engine idleness, and a
            # submitted request is invisible to the in-flight counter
            # once its handler finished — together they cover the window
            if inflight == 0 and self.engine.scheduler.idle:
                return True
            if dl.expired:
                return False
            time.sleep(self._poll or 0.001)

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> bool:
        """Graceful by default: drain first, then stop the driver and
        close every connection. ``drain=False`` is the hard stop (in-
        flight peers see a reset)."""
        drained = self.drain(timeout) if drain else False
        self._stopping = True
        self._close_listener()
        with self._lock:
            conns = list(self._conns)
        for fd in conns:
            try:
                fd.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                fd.close()
            except OSError:
                pass
        self._driver.join(timeout=5.0)
        self._accept.join(timeout=5.0)
        with self._lock:
            handlers = list(self._handlers)
        for t in handlers:
            t.join(timeout=5.0)
        return drained

    def threads(self) -> list:
        """The gateway's threads still alive (none after ``stop()``)."""
        with self._lock:
            ts = [self._driver, self._accept] + list(self._handlers)
        return [t for t in ts if t.is_alive()]

    def __del__(self):
        try:
            if not self._stopping:
                self.stop(drain=False)
        except Exception:  # noqa: BLE001 — interpreter-teardown best effort
            pass

    # ------------------------------------------------------------------
    def info(self) -> dict:
        with self._lock:
            return {"host": self.host, "port": self.port,
                    "draining": self._draining, "stopped": self._stopping,
                    "open_connections": len(self._conns),
                    "read_timeout": self.read_timeout,
                    **self.counters,
                    "status_counts": dict(self._status_counts)}


def gateway_info() -> list:
    """info() of every live gateway (the metrics collector's source)."""
    return [g.info() for g in list(_GATEWAYS)]
