"""paddle.distributed.rpc: counterpart of ``paddle_tpu/distributed/rpc.py``
(Paddle's python/paddle/distributed/rpc/rpc.py — init_rpc:73, rpc_sync:141,
rpc_async:179, shutdown:270, get_worker_info:299).

The TRANSPORT is native
C++ (csrc/host_runtime.cc RpcServer/pt_rpc_call: sockets, framing, HMAC auth,
connection threads, request/response correlation) while Python keeps what
must be Python — pickle (de)serialization and request execution — mirroring
the reference's brpc-transport / Python-handler split. The existing TCPStore
provides the rendezvous that maps worker names to endpoints. A pure-Python
transport with the identical wire format remains as fallback for
environments without the C++ toolchain; the two interoperate. Function
results (including Tensors via their numpy form) are pickled back; rpc_async
returns a concurrent.futures.Future.

Security: pickle deserialization of a request is code execution, so every
message (both directions) is authenticated with HMAC-SHA256 over a 32-byte
session secret generated by rank 0 and distributed through the TCPStore;
unauthenticated payloads are dropped before unpickling, and the server binds
only the interface implied by the master endpoint. Like the reference's brpc
transport, the rendezvous itself assumes a trusted cluster network — anyone
who can read the TCPStore can join the job.
"""
from __future__ import annotations

import hmac
import hashlib
import os
import pickle
import secrets as _secrets
import socket
import struct
import threading
from collections import namedtuple
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

from ..utils.deadline import Deadline, RpcTimeout, env_timeout, recv_exact
from .chaos import faultpoint, register_fault
from .store import TCPStore, create_master_store

WorkerInfo = namedtuple("WorkerInfo", ["name", "rank", "ip", "port"])

_DEFAULT_RPC_TIMEOUT = env_timeout("PT_RPC_TIMEOUT", 120.0)

# chaos site: every outbound rpc call crosses this point; the no-hang fault
# matrix arms it with delay/drop/error/crash (tests/test_no_hang.py)
FP_RPC_INVOKE = register_fault(
    "rpc.invoke", "outbound rpc_sync/rpc_async transport call")



class _Slot:
    """The one live rpc agent of this process: init_rpc installs it and
    shutdown pops it, under a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._d = {}

    def __contains__(self, key):
        with self._lock:
            return key in self._d

    def get(self, key):
        with self._lock:
            return self._d.get(key)

    def put(self, key, value):
        with self._lock:
            self._d[key] = value

    def pop(self, key):
        with self._lock:
            return self._d.pop(key, None)


_rpc_state = _Slot()


class _RpcState:
    def __init__(self, name, rank, world_size, store, server, pool):
        self.name = name
        self.rank = rank
        self.world_size = world_size
        self.store = store
        self.server = server
        self.pool = pool
        self.workers = {}  # name -> WorkerInfo


def _read_full(sock, n, dl: Optional[Deadline] = None):
    """Trickle-proof exact read (see utils.deadline.recv_exact): with a
    Deadline the read is bounded; without one it is a server-side handler
    read released by per-connection teardown."""
    return recv_exact(sock, n, dl, closed_exc=ConnectionError,
                      what="rpc peer closed")


_MAC_LEN = hashlib.sha256().digest_size


def _send_msg(sock, payload: bytes, secret: bytes):
    mac = hmac.new(secret, payload, hashlib.sha256).digest()
    sock.sendall(struct.pack("<Q", len(payload)) + mac + payload)


def _recv_msg(sock, secret: bytes, dl: Optional[Deadline] = None) -> bytes:
    (n,) = struct.unpack("<Q", _read_full(sock, 8, dl))
    mac = _read_full(sock, _MAC_LEN, dl)
    payload = _read_full(sock, n, dl)
    want = hmac.new(secret, payload, hashlib.sha256).digest()
    if not hmac.compare_digest(mac, want):
        raise ConnectionError("rpc message failed authentication")
    return payload


def _execute_request(req: bytes) -> bytes:
    """Unpickle-and-run one authenticated request; pickle the response."""
    try:
        fn, args, kwargs = pickle.loads(req)
        return pickle.dumps(("ok", fn(*args, **kwargs)))
    except Exception as e:  # noqa: BLE001 — marshal to caller
        return pickle.dumps(("err", repr(e)))


class _NativeRpcServer:
    """C++ transport (csrc/host_runtime.cc): native accept/conn threads pull
    authenticated frames; a Python executor pool drains them via
    pt_rpc_next_request and answers via pt_rpc_send_response."""

    def __init__(self, bind_host: str, secret: bytes, lib):
        import ctypes
        self._c = ctypes
        self._lib = lib
        self.secret = secret
        self._h = lib.pt_rpc_server_start(bind_host.encode(), secret,
                                          len(secret))
        if not self._h:
            raise OSError(f"native rpc server failed to bind {bind_host}")
        self.port = lib.pt_rpc_server_port(self._h)
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=8)
        self._drain = threading.Thread(target=self._drain_loop, daemon=True)
        self._drain.start()

    def _drain_loop(self):
        c = self._c
        while not self._stop.is_set():
            h = self._h  # snapshot: stop() nulls it on another thread
            if not h:
                break
            out = c.c_void_p()
            rid = c.c_long()
            n = self._lib.pt_rpc_next_request(h, c.byref(out),
                                              c.byref(rid), 0.2)
            if n == -2:
                break
            if n < 0:
                continue
            req = c.string_at(out, n)
            self._lib.pt_free(out)
            self._pool.submit(self._run_one, rid.value, req)

    def _run_one(self, rid: int, req: bytes):
        resp = _execute_request(req)
        h = self._h
        if h:  # server may be tearing down; the handle stays valid until
            self._lib.pt_rpc_send_response(h, rid, resp, len(resp))

    def stop(self):
        self._stop.set()
        h, self._h = self._h, None        # _run_one stops touching it
        self._lib.pt_rpc_server_stop(h)   # unblocks drain + conn threads
        self._drain.join(timeout=5)
        # wait for in-flight handlers BEFORE freeing the C handle —
        # pt_rpc_send_response on a freed server would be use-after-free
        self._pool.shutdown(wait=True)
        self._lib.pt_rpc_server_free(h)


class _RpcServer:
    """Pure-Python fallback transport, same wire format as the native one."""

    def __init__(self, bind_host: str = "127.0.0.1", secret: bytes = b""):
        self.secret: Optional[bytes] = secret or None
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((bind_host, 0))
        self.sock.listen(64)
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()
        self._threads = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                self.sock.settimeout(0.2)
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn):
        try:
            while not self._stop.is_set():
                secret = self.secret
                if secret is None:
                    break  # no requests are legitimate before rendezvous
                try:
                    # auth failure raises BEFORE any unpickling happens
                    req = _recv_msg(conn, secret)
                except (ConnectionError, OSError):
                    break
                _send_msg(conn, _execute_request(req), secret)
        finally:
            conn.close()

    def stop(self):
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass


def init_rpc(name, rank=None, world_size=None, master_endpoint=None):
    """Start this worker's RPC agent and rendezvous with the others.

    Defaults come from the launcher env (PADDLE_TRAINER_ID,
    PADDLE_TRAINERS_NUM, PADDLE_MASTER) like the reference."""
    if "state" in _rpc_state:
        raise RuntimeError("rpc is already initialized")
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0)) if rank is None else rank
    world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", 1)) \
        if world_size is None else world_size
    ep = master_endpoint or os.environ.get("PADDLE_MASTER", "127.0.0.1:0")
    host, port = ep.rsplit(":", 1)
    port = int(port)

    ip = "127.0.0.1" if host in ("127.0.0.1", "localhost", "0.0.0.0") \
        else socket.gethostbyname(socket.gethostname())
    if world_size == 1 and port == 0:
        store = create_master_store(port=0, world_size=1)
    else:
        store = TCPStore(host, port, is_master=(rank == 0),
                         world_size=world_size)
    # rank 0 mints the per-job HMAC secret; everyone reads it from the store
    # BEFORE starting a server, so no worker ever serves unauthenticated.
    # Rendezvous reads wait with the RENDEZVOUS budget first: a bare get()
    # is capped at the much shorter per-op deadline, which would abort a
    # job whose rank 0 is merely slow to publish (e.g. long recovery).
    rendezvous_t = env_timeout("PT_LAUNCH_RENDEZVOUS_TIMEOUT", 300.0)
    if rank == 0:
        store.set("rpc/secret", _secrets.token_bytes(32).hex().encode())
    else:
        store.wait("rpc/secret", timeout=rendezvous_t)
    secret = bytes.fromhex(store.get("rpc/secret").decode())
    from ..utils import native as _native
    lib = _native.get_lib()
    if lib is not None:
        server = _NativeRpcServer(ip, secret, lib)  # C++ transport
    else:
        server = _RpcServer(bind_host=ip, secret=secret)  # python fallback
    store.set(f"rpc/{rank}",
              pickle.dumps(WorkerInfo(name, rank, ip, server.port)))
    workers = {}
    for r in range(world_size):
        store.wait(f"rpc/{r}", timeout=rendezvous_t)
        info = pickle.loads(store.get(f"rpc/{r}"))
        workers[info.name] = info

    st = _RpcState(name, rank, world_size, store, server,
                   ThreadPoolExecutor(max_workers=8))
    st.workers = workers
    _rpc_state.put("state", st)
    return None


def _require_state():
    st = _rpc_state.get("state")
    if st is None:
        raise RuntimeError("call init_rpc before using rpc APIs")
    return st


def _invoke(to, fn, args, kwargs, timeout):
    st = _require_state()
    if to not in st.workers:
        raise ValueError(f"unknown rpc worker {to!r}; "
                         f"known: {sorted(st.workers)}")
    info = st.workers[to]
    secret = st.server.secret
    req = pickle.dumps((fn, tuple(args or ()), kwargs or {}))
    what = f"rpc to {to!r}"
    dl = Deadline(timeout, what=what)
    # chaos: delay stalls here and the check below converts it into the
    # typed RpcTimeout; drop raises the ConnectionError the caller handles
    faultpoint(FP_RPC_INVOKE)
    dl.check(what, exc=RpcTimeout, detail="stalled before transport call")
    from ..utils import native as _native
    lib = _native.get_lib()
    if lib is not None:
        import ctypes
        # The C transport takes the REMAINING budget, but the Python-level
        # Deadline is the authority: run the native
        # call on a watchdog thread and abandon it at expiry + a small
        # grace, so a wedged pt_rpc_call (bad C timeout arithmetic, a
        # blocked DNS/connect path) still becomes the typed RpcTimeout
        # instead of outliving its budget.
        box = {}

        # an explicitly unbounded call (timeout=None) has no remaining():
        # hand the C side a huge-but-finite bound instead of float(None)
        c_budget = dl.remaining(floor=0.01)
        c_budget = float(2 ** 31) if c_budget is None else float(c_budget)

        def _transport_call():
            try:
                out = ctypes.c_void_p()
                n = lib.pt_rpc_call(info.ip.encode(), info.port, secret,
                                    len(secret), req, len(req),
                                    ctypes.byref(out), c_budget)
                box["n"] = n
                if n >= 0:
                    box["resp"] = ctypes.string_at(out, n)
                    lib.pt_free(out)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["exc"] = e

        t = threading.Thread(target=_transport_call, daemon=True)
        t.start()
        # grace keeps the C-side timeout the NORMAL expiry path (it returns
        # -3 and we map it below); the join bound only fires when the C
        # call overran its own deadline. An explicitly unbounded call
        # (timeout=None) keeps an unbounded join.
        rem = dl.remaining(floor=0.01)
        t.join(None if rem is None else rem + 0.25)
        if t.is_alive():
            raise RpcTimeout(
                what, timeout,
                detail="native transport overran its C-side timeout; call "
                       "abandoned at the Python-level deadline")
        if "exc" in box:
            raise box["exc"]
        n = box["n"]
        if n < 0:
            if dl.expired:
                raise RpcTimeout(what, timeout,
                                 detail=f"transport error {n} at deadline")
            raise ConnectionError(
                f"rpc to {to!r} transport error {n} "
                "(-1 connect, -2 send, -3 recv/auth)")
        status, payload = pickle.loads(box["resp"])
    else:
        try:
            sock = socket.create_connection(
                (info.ip, info.port), timeout=dl.remaining(floor=0.01))
        except socket.timeout as e:
            raise RpcTimeout(what, timeout, detail="connect timed out") from e
        try:
            sock.settimeout(dl.remaining(floor=0.01))
            _send_msg(sock, req, secret)
            status, payload = pickle.loads(_recv_msg(sock, secret, dl))
        except socket.timeout as e:
            raise RpcTimeout(
                what, timeout,
                detail="no reply within the deadline (hung or partitioned "
                       "peer)") from e
        finally:
            sock.close()
    if status == "err":
        raise RuntimeError(f"rpc to {to!r} failed remotely: {payload}")
    return payload


def rpc_sync(to, fn, args=None, kwargs=None, timeout=_DEFAULT_RPC_TIMEOUT):
    """Blocking remote call; returns fn(*args, **kwargs) run on worker `to`."""
    return _invoke(to, fn, args, kwargs, timeout)


def rpc_async(to, fn, args=None, kwargs=None,
              timeout=_DEFAULT_RPC_TIMEOUT) -> Future:
    """Non-blocking remote call; returns a Future (wait()/result())."""
    st = _require_state()
    fut = st.pool.submit(_invoke, to, fn, args, kwargs, timeout)
    if not hasattr(fut, "wait"):
        fut.wait = fut.result  # reference API parity
    return fut


def shutdown():
    """Barrier with all workers, then stop the agent (reference shutdown:270)."""
    st = _rpc_state.pop("state")
    if st is None:
        return
    # simple store barrier so no one tears down while peers still call in.
    # Tolerate a dead master: rank 0 stops its store server right after
    # passing this barrier, so a connection error while polling means the
    # peer already left — exactly the condition we are waiting for.
    try:
        dl = Deadline(_DEFAULT_RPC_TIMEOUT, what="rpc shutdown barrier")
        n = st.store.add("rpc/shutdown", 1)
        while n < st.world_size and not dl.expired:
            dl.sleep(0.01)
            n = st.store.add("rpc/shutdown", 0)
    except Exception:  # noqa: BLE001 — master gone => barrier passed
        pass
    st.server.stop()
    st.pool.shutdown(wait=False)
    try:
        st.store.stop()
    except Exception:  # noqa: BLE001 — best-effort teardown
        pass


def get_worker_info(name) -> WorkerInfo:
    return _require_state().workers[name]


def get_all_worker_infos():
    return sorted(_require_state().workers.values(), key=lambda w: w.rank)


def get_current_worker_info() -> WorkerInfo:
    st = _require_state()
    return st.workers[st.name]
