"""TCPStore rendezvous.

Counterpart of ``paddle_tpu/distributed/store.py`` (Paddle's TCPStore,
paddle/phi/core/distributed/store/tcp_store.h:120). The server and the wire
protocol live in the port's host runtime (``csrc/host_runtime.cc``, built
by ``utils/native.py``), byte for byte the JAX package's, so a client of
either package talks to a master of the other. This wraps them with the
Python-facing API: set/get/add/wait/delete_key and store-side leases with
a master that rank 0 hosts. A pure-Python server and client with the same
protocol take over when the native build is unavailable
(``native.load_error()`` says why).

The store is the key/value blackboard of everything elastic in the port:
the elastic membership's leases, the supervisor's rendezvous and barriers,
``reshard.StoreTransport``'s bricks, and (``C10dStore``) the bootstrap
of the ``torch.distributed`` groups a ``TrainStep.reshard`` re-forms.

No hang: every client operation carries a deadline.
Per-call socket timeouts (PT_STORE_OP_TIMEOUT, default 60s) bound each rpc
against a partitioned master; `wait()` is bounded SERVER-side
(PT_STORE_WAIT_TIMEOUT, default 300s) so a key a peer never publishes raises
a typed `StoreTimeout` instead of blocking forever. A timeout or peer close
mid-message leaves the stream desynced, so the client poisons the connection.
Connection losses on idempotent ops reconnect (same jittered backoff as
startup, short PT_STORE_RECONNECT_TIMEOUT budget) and retry exactly once
before raising the typed terminal `StoreConnectionError`; a `StoreTimeout`
raises immediately (its budget is spent) and the next op reconnects.
Fault modes for all of this are injectable at the registered chaos sites
`store.client.rpc` and `store.wait` (see distributed/chaos.py).
"""
from __future__ import annotations

import random
import socket
import struct
import threading
import time
from typing import Optional

from ..utils import native
from ..utils.deadline import (Deadline, StoreConnectionError, StoreTimeout,
                              env_timeout, recv_exact)
from .chaos import FaultDrop, faultpoint, register_fault

_SET, _GET, _ADD, _WAIT, _DEL, _PING = 1, 2, 3, 4, 5, 6
_LEASE, _LEASE_CHECK = 7, 8
_WAIT_T = 9  # bounded wait: val = i64 timeout_ms; status -3 = deadline hit

# chaos sites: the no-hang fault matrix (tests/test_no_hang.py) arms each of
# these with delay / drop / error / crash and proves the typed-error bound
FP_STORE_RPC = register_fault(
    "store.client.rpc", "every TCPStore client operation hits the wire here")
FP_STORE_WAIT = register_fault(
    "store.wait", "blocking until a peer publishes a key")

_BACKOFF_BASE = 0.02   # first retry delay (s)
_BACKOFF_CAP = 1.0     # ceiling — a late-starting master costs at most 1s/poll


def _backoff_delay(attempt: int) -> float:
    """Bounded exponential backoff with full jitter. A fixed short poll
    (the old 50ms sleep) synchronizes every connecting rank into thundering
    retry herds against a master that is still binding; jitter decorrelates
    them and the exponential cap bounds the tail."""
    # exponent clamped so a very long wait can't overflow float conversion
    exp = min(_BACKOFF_CAP, _BACKOFF_BASE * (2 ** min(attempt, 16)))
    return random.uniform(_BACKOFF_BASE / 2, exp)


class _PyStoreServer:
    """Fallback Python implementation of the same wire protocol."""

    def __init__(self, port: int):
        self._kv = {}
        self._leases = {}  # key -> monotonic expiry (SERVER-side TTL)
        self._cond = threading.Condition()
        self._stopping = False
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", port))
        self._sock.listen(128)
        self.port = self._sock.getsockname()[1]
        self._threads = []
        self._accept = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept.start()

    def _accept_loop(self):
        while not self._stopping:
            try:
                fd, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._handle, args=(fd,), daemon=True)
            t.start()
            self._threads.append(t)

    @staticmethod
    def _read_full(fd, n):
        buf = b""
        while len(buf) < n:
            # server-side read: a stalled client only parks its own handler
            # thread (daemon; released by stop()'s socket close)
            chunk = fd.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _handle(self, fd):
        fd.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                hdr = self._read_full(fd, 5)
                if hdr is None:
                    return
                cmd, klen = struct.unpack("<BI", hdr)
                key = self._read_full(fd, klen).decode() if klen else ""
                (vlen,) = struct.unpack("<I", self._read_full(fd, 4))
                val = self._read_full(fd, vlen) if vlen else b""
                status, reply = 0, b""
                if cmd == _SET:
                    with self._cond:
                        self._kv[key] = val
                        self._cond.notify_all()
                elif cmd in (_GET, _WAIT):
                    with self._cond:
                        # server-side handler thread: unbounded by design,
                        # released by stop() or the key arriving; the CLIENT
                        # side owns the deadline
                        self._cond.wait_for(
                            lambda: self._stopping or key in self._kv)
                        if key in self._kv:
                            if cmd == _GET:
                                reply = self._kv[key]
                        else:
                            status = -1
                elif cmd == _WAIT_T:
                    (ms,) = struct.unpack("<q", val)
                    with self._cond:
                        self._cond.wait_for(
                            lambda: self._stopping or key in self._kv,
                            timeout=ms / 1e3)
                        if key in self._kv:
                            status = 0
                        elif self._stopping:
                            status = -1
                        else:
                            status = -3  # deadline expired, key still absent
                elif cmd == _ADD:
                    (delta,) = struct.unpack("<q", val)
                    with self._cond:
                        cur = int(self._kv.get(key, b"0") or b"0") + delta
                        self._kv[key] = str(cur).encode()
                        status = cur
                        self._cond.notify_all()
                elif cmd == _DEL:
                    with self._cond:
                        status = int(self._kv.pop(key, None) is not None)
                        self._cond.notify_all()
                elif cmd == _LEASE:
                    import time as _t
                    (ttl_ms,) = struct.unpack("<q", val)
                    with self._cond:
                        self._leases[key] = _t.monotonic() + ttl_ms / 1e3
                elif cmd == _LEASE_CHECK:
                    import time as _t
                    with self._cond:
                        exp = self._leases.get(key)
                        if exp is None:
                            status = 0
                        elif _t.monotonic() < exp:
                            status = 1
                        else:
                            self._leases.pop(key, None)  # lazy expiry
                            status = 0
                elif cmd == _PING:
                    status = 42
                else:
                    status = -2
                fd.sendall(struct.pack("<qI", status, len(reply)) + reply)
        except OSError:
            pass
        finally:
            fd.close()

    def stop(self):
        self._stopping = True
        with self._cond:
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass


class TCPStore:
    """Key/value store: master hosts the server, every rank connects a client.

    API mirrors the reference store (set/get/add/wait/delete_key).
    """

    def __init__(self, host: str, port: int, is_master: bool = False,
                 world_size: int = 1, timeout: float = 300.0):
        self.host = host
        self.is_master = is_master
        self.world_size = world_size
        self._server = None
        self._py_server = None
        lib = native.get_lib()
        if is_master:
            if lib is not None:
                self._server = lib.pt_store_server_start(int(port))
                if not self._server:
                    raise RuntimeError(f"TCPStore: cannot bind port {port}")
                port = lib.pt_store_server_port(self._server)
            else:
                self._py_server = _PyStoreServer(port)
                port = self._py_server.port
        self.port = port
        addr = socket.gethostbyname(host) if host != "localhost" else "127.0.0.1"
        self._addr = addr
        self._connect_timeout = timeout
        self._lib = lib
        # serializes client use + the reconnect swap. The clients already
        # serialize one in-flight rpc internally (native c->mu, _PyClient
        # _lock), so this adds no real contention — what it buys is that a
        # concurrent op can never use (or double-free) a client handle that
        # a failing sibling op is mid-replacing.
        self._client_lock = threading.Lock()
        self._stopped = False
        # native handles replaced by _reconnect are SHUTDOWN but not freed
        # until stop(): stop() may shutdown self._client without the lock,
        # and deferring the free is what makes that handle read safe
        self._retired = []
        if lib is not None:
            self._client = self._native_connect(timeout)
        else:
            self._client = _PyClient(addr, int(port), timeout)

    def _native_connect(self, timeout: float, abortable: bool = False):
        """Connect the native client with jittered backoff (non-master ranks
        race the master's bind; refused connections inside the window are
        startup noise), then arm its per-operation socket deadline.

        With abortable=True (mid-job reconnects) the native dial is sliced
        into ~1s attempts and self._stopped is checked between them, so a
        concurrent stop() isn't blocked behind the full reconnect budget."""
        lib, addr, port = self._lib, self._addr, self.port
        deadline = time.monotonic() + timeout
        attempt = 0
        while True:
            if abortable and self._stopped:
                raise StoreConnectionError(
                    "TCPStore stopped during reconnect")
            # each attempt gets only the REMAINING budget (the native
            # call may itself block polling until its deadline; handing
            # it the full timeout every round could overshoot ~2x)
            left = max(0.05, deadline - time.monotonic())
            if abortable:
                left = min(left, 1.0)
            client = lib.pt_store_client_new(addr.encode(), int(port),
                                             float(left))
            if client:
                lib.pt_store_client_set_op_timeout(
                    client, env_timeout("PT_STORE_OP_TIMEOUT", 60.0))
                return client
            if time.monotonic() >= deadline:
                raise StoreConnectionError(
                    f"TCPStore: cannot connect {self.host}:{port} "
                    f"after {timeout:.0f}s")
            time.sleep(min(_backoff_delay(attempt),
                           max(0.0, deadline - time.monotonic())))
            attempt += 1

    # --- no-hang plumbing ---
    def _reconnect(self) -> None:
        """Replace the (desynced/dead) client. Mid-job reconnects get a
        SHORT budget (PT_STORE_RECONNECT_TIMEOUT, default 10s), not the
        startup rendezvous budget: a master that left on purpose (shutdown
        barriers poll the store precisely to notice that) must fail the
        retry in seconds, not stall the caller for minutes."""
        budget = env_timeout("PT_STORE_RECONNECT_TIMEOUT", 10.0)
        if self._lib is not None:
            if self._client:
                # retire, don't free: stop() may be shutdown()ing this
                # handle concurrently — it stays valid until stop() frees
                # the retired list under the lock
                self._lib.pt_store_client_shutdown(self._client)
                self._retired.append(self._client)
                self._client = None
                # bound the retirement: stop() holds a just-read handle
                # across AT MOST one swap (read and shutdown are adjacent,
                # each reconnect cycle takes seconds), so freeing all but
                # a small tail can never free a handle stop() still holds
                # — and a flaky master no longer leaks one fd per reconnect
                while len(self._retired) > 4:
                    self._lib.pt_store_client_free(self._retired.pop(0))
            self._client = self._native_connect(budget, abortable=True)
        else:
            self._client.reconnect(budget, abort=lambda: self._stopped)

    def _op(self, thunk, site: str = FP_STORE_RPC, retry: bool = True):
        """Run one client operation: chaos faultpoint first, then the wire
        op; on a dropped/desynced connection reconnect (jittered backoff)
        and retry EXACTLY once, then let the typed error fly.

        Only the idempotent ops (set/get/wait/lease/delete) retry; add()
        passes retry=False because a lost reply would double-apply the
        delta and the exact-count rendezvous sites can't tolerate that.
        A StoreTimeout never retries either: the op's budget is spent —
        it raises at once with the connection poisoned, and the NEXT op
        reconnects through the dead-client path.
        """
        with self._client_lock:
            try:
                self._guard_client()
            except StoreConnectionError:
                # dead at ENTRY (a previous op poisoned the connection):
                # nothing has been sent yet, so reconnect-then-send is
                # single-send safe for EVERY op, including add()
                if self._stopped:
                    raise
                self._reconnect()
                self._guard_client()
            try:
                faultpoint(site)
                return thunk()
            except (FaultDrop, StoreConnectionError):
                if not retry or self._stopped:
                    raise
                self._reconnect()  # on failure leaves _client None and
                self._guard_client()  # raises typed — never a NULL into C
                return thunk()

    def _guard_client(self) -> None:
        """Typed fail-fast for a client that cannot carry a request: after
        stop(), after a failed reconnect (never a NULL into the C library),
        or with a connection an earlier op poisoned (dead-at-entry — the
        caller reconnects BEFORE anything is sent)."""
        if self._stopped or not self._client:
            raise StoreConnectionError(
                "TCPStore client is disconnected (stopped, or an earlier "
                "reconnect failed)")
        if self._lib is not None:
            if not self._lib.pt_store_client_ok(self._client):
                raise StoreConnectionError(
                    "TCPStore client connection is poisoned")
        elif not self._client.alive:
            raise StoreConnectionError(
                "TCPStore client connection is poisoned")

    def _native_err(self, what: str, timeout: Optional[float] = None):
        """Map a failed native call to a typed error. last_err is read
        under _client_lock right after the failing call, so it is this
        op's verdict, not a concurrent sibling's."""
        err = self._lib.pt_store_client_last_error(self._client)
        if err == -3:
            raise StoreTimeout(
                what,
                timeout if timeout is not None
                else env_timeout("PT_STORE_OP_TIMEOUT", 60.0),
                detail="socket deadline hit mid-message; connection "
                       "poisoned (next op reconnects)")
        if err == 0:
            # the transport is healthy — the SERVER rejected the request
            # (e.g. a stopping store answering status -1). Reconnecting
            # and retrying would fail identically: raise non-retryable.
            raise RuntimeError(f"{what} failed (store rejected the request)")
        raise StoreConnectionError(f"{what}: store connection lost")

    # --- client ops ---
    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()

        def thunk():
            if self._lib is not None:
                rc = self._lib.pt_store_set(self._client, key.encode(),
                                            value, len(value))
                if rc != 0:
                    self._native_err(f"TCPStore.set({key!r})")
            else:
                self._client.rpc(_SET, key, value)
        self._op(thunk)

    def get(self, key: str) -> bytes:
        def thunk():
            if self._lib is not None:
                import ctypes
                out = ctypes.c_void_p()
                n = self._lib.pt_store_get(self._client, key.encode(),
                                           ctypes.byref(out))
                if n < 0:
                    self._native_err(f"TCPStore.get({key!r})")
                return native._take_bytes(self._lib, out, n)
            status, reply = self._client.rpc(_GET, key)
            if status < 0:
                raise RuntimeError(f"TCPStore.get({key!r}) failed")
            return reply
        return self._op(thunk)

    def add(self, key: str, delta: int) -> int:
        def thunk():
            if self._lib is not None:
                v = self._lib.pt_store_add(self._client, key.encode(),
                                           int(delta))
                if v == -(2 ** 63):
                    self._native_err(f"TCPStore.add({key!r})")
                return int(v)
            status, _ = self._client.rpc(_ADD, key,
                                         struct.pack("<q", int(delta)))
            return status
        # NO retry: a reply lost after the server applied the delta would
        # double-apply on retry, and the exact-count rendezvous
        # (nodes_arrived == nnodes, collective.barrier) cannot tolerate
        # over-counting — a typed error beats a silently skipped count
        return self._op(thunk, retry=False)

    def wait(self, key: str, timeout: Optional[float] = None) -> None:
        """Block until `key` exists — but never unboundedly: the SERVER
        enforces the deadline (kWaitT / _WAIT_T) and a typed `StoreTimeout`
        is raised if the key is still absent when it expires. Default bound:
        PT_STORE_WAIT_TIMEOUT (300s)."""
        if timeout is None:
            timeout = env_timeout("PT_STORE_WAIT_TIMEOUT", 300.0)
        what = f"TCPStore.wait({key!r})"
        dl = Deadline(timeout, what=what)

        def thunk():
            # an armed delay fault stalls ABOVE the wire op; the deadline
            # converts the stall into the typed timeout the caller expects
            dl.check(what, exc=StoreTimeout, detail="stalled before issue")
            left = dl.remaining(floor=0.01)
            if self._lib is not None:
                rc = self._lib.pt_store_wait_timeout(
                    self._client, key.encode(), float(left))
                if rc == -3:
                    raise StoreTimeout(what, timeout,
                                       detail="key never published")
                if rc != 0:
                    self._native_err(what, timeout)
            else:
                status, _ = self._client.rpc(
                    _WAIT_T, key, struct.pack("<q", int(left * 1000)),
                    timeout=left + 5.0)
                if status == -3:
                    raise StoreTimeout(what, timeout,
                                       detail="key never published")
                if status < 0:
                    raise RuntimeError(f"{what} failed (store stopping)")
        self._op(thunk, site=FP_STORE_WAIT)

    def delete_key(self, key: str) -> bool:
        def thunk():
            if self._lib is not None:
                return self._lib.pt_store_delete(self._client,
                                                 key.encode()) > 0
            status, _ = self._client.rpc(_DEL, key)
            return status > 0
        return self._op(thunk)

    def lease(self, key: str, ttl_ms: int) -> None:
        """Grant/refresh a TTL lease on `key`.  Expiry is decided by the
        STORE's clock (ETCD-lease semantics, reference
        fleet/elastic/manager.py:126): all observers agree on liveness."""
        def thunk():
            if self._lib is not None:
                if self._lib.pt_store_lease(self._client, key.encode(),
                                            int(ttl_ms)) != 0:
                    self._native_err(f"TCPStore.lease({key!r})")
            else:
                self._client.rpc(_LEASE, key, struct.pack("<q", int(ttl_ms)))
        self._op(thunk)

    def lease_alive(self, key: str) -> bool:
        def thunk():
            if self._lib is not None:
                rc = self._lib.pt_store_lease_check(self._client,
                                                    key.encode())
                if rc < 0:
                    self._native_err(f"TCPStore.lease_check({key!r})")
                return rc == 1
            status, _ = self._client.rpc(_LEASE_CHECK, key)
            return status == 1
        return self._op(thunk)

    def stop(self):
        # Interrupt FIRST, without the lock: an in-flight wait() may hold
        # _client_lock for its full budget, and shutdown() is the one call
        # that is safe against a concurrent recv (native handles stay
        # allocated until the free below; _stopped stops the failing op
        # from reconnecting and re-waiting).
        self._stopped = True
        if self._lib is not None:
            c = self._client
            if c:
                self._lib.pt_store_client_shutdown(c)
        elif self._client is not None:
            self._client.interrupt()
        # now the lock clears fast; freeing under it means no op still
        # holds the handle (new ops are fenced off by _guard_client)
        with self._client_lock:
            if self._lib is not None:
                for c in [self._client, *self._retired]:
                    if c:
                        self._lib.pt_store_client_free(c)
                self._client = None
                self._retired.clear()
            elif self._client is not None:
                self._client.close()
        if self._lib is not None:
            if self._server:
                self._lib.pt_store_server_stop(self._server)
                self._server = None
        else:
            if self._py_server is not None:
                self._py_server.stop()
                self._py_server = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class _PyClient:
    """Python store client with per-call deadlines.

    The old client set `settimeout(None)` after connect, so a partitioned
    master hung every subsequent rpc() forever. Now every rpc carries a
    `Deadline`; a timeout or peer close mid-message means the stream is
    desynced (the next read would parse a stale half-reply as its own
    header), so the socket is closed immediately and the owning TCPStore
    reconnects through the same jittered-backoff path as startup.
    """

    def __init__(self, addr: str, port: int, timeout: float):
        self._addr = addr
        self._port = port
        self._connect_timeout = timeout
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._connect(timeout)

    def _connect(self, timeout: float, abort=None) -> None:
        deadline = time.monotonic() + timeout
        last = None
        attempt = 0
        while time.monotonic() < deadline:
            if abort is not None and abort():
                raise StoreConnectionError(
                    "TCPStore stopped during reconnect")
            try:
                self._sock = socket.create_connection(
                    (self._addr, self._port), timeout=5)
                self._sock.setsockopt(socket.IPPROTO_TCP,
                                      socket.TCP_NODELAY, 1)
                status, _ = self.rpc(_PING, "", timeout=5.0)
                if status == 42:
                    return
                self._teardown()
                last = StoreConnectionError("store ping rejected")
            except (OSError, StoreConnectionError, StoreTimeout) as e:
                last = e
            time.sleep(min(_backoff_delay(attempt),
                           max(0.0, deadline - time.monotonic())))
            attempt += 1
        raise StoreConnectionError(
            f"TCPStore: cannot connect {self._addr}:{self._port}: {last}")

    def reconnect(self, timeout: Optional[float] = None, abort=None) -> None:
        """Drop the (possibly desynced) connection and redo the connect
        handshake (default: the startup backoff budget). `abort` is polled
        between attempts so a concurrent stop() isn't blocked behind the
        whole budget."""
        self._teardown()
        self._connect(self._connect_timeout if timeout is None else timeout,
                      abort=abort)

    @property
    def alive(self) -> bool:
        return self._sock is not None

    def _teardown(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def interrupt(self) -> None:
        """Wake a concurrent rpc blocked in recv (thread-safe: shutdown on
        the live socket object, which only _teardown ever replaces)."""
        sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _recv_exact(self, n: int, dl: Deadline) -> bytes:
        return recv_exact(self._sock, n, dl, closed_exc=StoreConnectionError,
                          what="TCPStore connection closed mid-message")

    def rpc(self, cmd: int, key: str, val: bytes = b"",
            timeout: Optional[float] = None):
        if timeout is None:
            timeout = env_timeout("PT_STORE_OP_TIMEOUT", 60.0)
        what = f"TCPStore rpc (cmd {cmd}, key {key!r})"
        dl = Deadline(timeout, what=what)
        kb = key.encode()
        msg = struct.pack("<BI", cmd, len(kb)) + kb \
            + struct.pack("<I", len(val)) + val
        with self._lock:
            if self._sock is None:
                raise StoreConnectionError(
                    "TCPStore client is disconnected (earlier rpc failed)")
            try:
                self._sock.settimeout(dl.remaining(floor=0.01))
                self._sock.sendall(msg)
                hdr = self._recv_exact(12, dl)
                status, rlen = struct.unpack("<qI", hdr)
                reply = self._recv_exact(rlen, dl) if rlen else b""
            except socket.timeout as e:
                # mid-message deadline: poison the stream before anyone can
                # read a stale half-reply as their own response
                self._teardown()
                raise StoreTimeout(
                    what, timeout,
                    detail="socket deadline hit mid-message; connection "
                           "closed to prevent desync") from e
            except StoreConnectionError:
                self._teardown()
                raise
            except (ConnectionError, OSError) as e:
                self._teardown()
                raise StoreConnectionError(
                    f"TCPStore connection lost during {what}: {e}") from e
        return status, reply

    def close(self):
        self._teardown()


def create_master_store(port: int = 0, world_size: int = 1) -> TCPStore:
    return TCPStore("127.0.0.1", port, is_master=True, world_size=world_size)
