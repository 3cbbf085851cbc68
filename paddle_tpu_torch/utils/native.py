"""Loader for the port's host runtime (``paddle_tpu_torch/csrc/host_runtime.cc``).

Counterpart of ``paddle_tpu/utils/native.py``. The host runtime is the
bounded blob queue the data loader feeds through, the TCPStore server and
client, and the RPC transport: plain C++17 with a flat C ABI, bound here
with ``ctypes``. It is compiled at first use:

    g++ -O2 -std=c++17 -fPIC -shared -pthread -fvisibility=hidden \\
        paddle_tpu_torch/csrc/host_runtime.cc \\
        -o build/paddle_tpu_torch/libpt_host_runtime.so

into ``build/paddle_tpu_torch/`` at the repo root, never beside the
source. A stamp beside the library holds a hash of the source, the
flags, the compiler and the platform, so an edited source (or a library
built on another machine) is rebuilt. The check and the build run under
an exclusive ``fcntl`` lock on ``libpt_host_runtime.lock`` (as
``ops/kernels/_build.py`` does for the CUDA kernels), so ranks that start
together build once and the others load what it left.

A failed build (no ``g++``) is not fatal: ``get_lib()`` returns None,
``load_error()`` says why, and the store and the data loader use their
pure-Python servers and queues instead. ``available()`` says which one
runs.

``build_capi()`` builds the serving C ABI
(``paddle_tpu_torch/csrc/predictor_capi.cc``) the same way, with the
running interpreter's headers and ``libpython`` (``sysconfig``), into
``build/paddle_tpu_torch/libpt_capi.so``, and returns its path. A C
program loads it with ``dlopen("libpt_capi.so")`` (``LD_LIBRARY_PATH`` on
that directory) and needs ``paddle_tpu_torch`` importable (``PYTHONPATH``
on the repo root); ``tests/torch_capi_smoke.c`` is such a program.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

__all__ = ["get_lib", "available", "load_error", "build", "build_capi",
           "BlockingQueue", "LIB_PATH", "SOURCE", "CXX_FLAGS", "CAPI_PATH",
           "CAPI_SOURCE"]

_PKG = Path(__file__).resolve().parents[1]            # paddle_tpu_torch/
SOURCE = _PKG / "csrc" / "host_runtime.cc"
LIB_PATH = _PKG.parent / "build" / "paddle_tpu_torch" / "libpt_host_runtime.so"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread",
             "-fvisibility=hidden")
CAPI_SOURCE = _PKG / "csrc" / "predictor_capi.cc"
CAPI_PATH = LIB_PATH.with_name("libpt_capi.so")


def _digest(source: Path, flags) -> str:
    """The source, the flags, the compiler and the platform: a library
    built on another machine (a copied build directory) is rebuilt."""
    import platform
    try:
        cxx = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        cxx = ""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    h.update(cxx.encode())
    h.update(platform.platform().encode())
    return h.hexdigest()


def _build_so(source: Path, lib: Path, flags, link, force: bool) -> float:
    """Compile ``source`` into ``lib`` (``g++ flags source -o lib link``)
    under an exclusive ``fcntl`` lock beside it, unless the stamp shows an
    up-to-date build; the library is loaded once before it is published
    by an atomic rename. Returns the seconds g++ took (0.0 when nothing
    was built); RuntimeError when the compiler fails or is missing."""
    import time
    lib.parent.mkdir(parents=True, exist_ok=True)
    stamp = lib.with_suffix(".sha256")
    with open(lib.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            digest = _digest(source, (*flags, *link))
            if not force and lib.is_file() and stamp.is_file() \
                    and stamp.read_text().strip() == digest:
                return 0.0
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    ["g++", *flags, str(source), "-o", str(tmp), *link],
                    capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"g++ could not run: {e}") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                                   f"{proc.stderr[-2000:]}")
            ctypes.CDLL(str(tmp))              # loads before it is published
            os.replace(tmp, lib)
            stamp.write_text(digest)
            return time.perf_counter() - t0
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def build(force: bool = False) -> float:
    """Compile the host runtime into LIB_PATH unless an up-to-date build
    is there; returns the seconds g++ took (0.0 when nothing was built).
    Raises RuntimeError when the compiler fails or is missing."""
    return _build_so(SOURCE, LIB_PATH, CXX_FLAGS, (), force)


def _capi_flags():
    """g++ compile and link flags for the C ABI: the running interpreter's
    headers, and its ``libpython`` linked with an rpath to where it
    lives."""
    import sysconfig
    cv = sysconfig.get_config_var
    libdir = cv("LIBDIR")
    link = (f"-L{libdir}", f"-Wl,-rpath,{libdir}",
            f"-lpython{cv('LDVERSION')}", *(cv("LIBS") or "").split(),
            *(cv("SYSLIBS") or "").split())
    return ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread",
            f"-I{cv('INCLUDEPY')}"), link


def build_capi() -> str:
    """Build the serving C ABI (``csrc/predictor_capi.cc``) into CAPI_PATH
    unless an up-to-date build is there, and return its path (module
    docstring). RuntimeError when the compiler fails."""
    _build_so(CAPI_SOURCE, CAPI_PATH, *_capi_flags(), False)
    return str(CAPI_PATH)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    sigs = {
        "pt_free": (None, [c.c_void_p]),
        "pt_now_ns": (c.c_longlong, []),
        "pt_queue_new": (c.c_void_p, [c.c_int]),
        "pt_queue_push": (c.c_int, [c.c_void_p, c.c_char_p, c.c_long,
                                    c.c_double]),
        "pt_queue_pop": (c.c_long, [c.c_void_p, c.POINTER(c.c_void_p),
                                    c.c_double]),
        "pt_queue_size": (c.c_int, [c.c_void_p]),
        "pt_queue_close": (None, [c.c_void_p]),
        "pt_queue_free": (None, [c.c_void_p]),
        "pt_store_server_start": (c.c_void_p, [c.c_int]),
        "pt_store_server_port": (c.c_int, [c.c_void_p]),
        "pt_store_server_stop": (None, [c.c_void_p]),
        "pt_store_client_new": (c.c_void_p, [c.c_char_p, c.c_int,
                                             c.c_double]),
        "pt_store_set": (c.c_int, [c.c_void_p, c.c_char_p, c.c_char_p,
                                   c.c_long]),
        "pt_store_get": (c.c_long, [c.c_void_p, c.c_char_p,
                                    c.POINTER(c.c_void_p)]),
        "pt_store_add": (c.c_longlong, [c.c_void_p, c.c_char_p,
                                        c.c_longlong]),
        "pt_store_wait": (c.c_int, [c.c_void_p, c.c_char_p]),
        "pt_store_wait_timeout": (c.c_int, [c.c_void_p, c.c_char_p,
                                            c.c_double]),
        "pt_store_client_set_op_timeout": (None, [c.c_void_p, c.c_double]),
        "pt_store_client_last_error": (c.c_int, [c.c_void_p]),
        "pt_store_client_shutdown": (None, [c.c_void_p]),
        "pt_store_client_ok": (c.c_int, [c.c_void_p]),
        "pt_store_delete": (c.c_int, [c.c_void_p, c.c_char_p]),
        "pt_store_lease": (c.c_int, [c.c_void_p, c.c_char_p, c.c_longlong]),
        "pt_store_lease_check": (c.c_int, [c.c_void_p, c.c_char_p]),
        "pt_store_client_free": (None, [c.c_void_p]),
        "pt_rpc_server_start": (c.c_void_p, [c.c_char_p, c.c_char_p,
                                             c.c_int]),
        "pt_rpc_server_port": (c.c_int, [c.c_void_p]),
        "pt_rpc_next_request": (c.c_long, [c.c_void_p, c.POINTER(c.c_void_p),
                                           c.POINTER(c.c_long), c.c_double]),
        "pt_rpc_send_response": (None, [c.c_void_p, c.c_long, c.c_char_p,
                                        c.c_long]),
        "pt_rpc_server_stop": (None, [c.c_void_p]),
        "pt_rpc_server_free": (None, [c.c_void_p]),
        "pt_rpc_call": (c.c_long, [c.c_char_p, c.c_int, c.c_char_p, c.c_int,
                                   c.c_char_p, c.c_long,
                                   c.POINTER(c.c_void_p), c.c_double]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


class _Loaded:
    """Build and bind once per process: ``(lib, error)``, one of them
    None."""

    def __init__(self):
        self._lock = threading.Lock()
        self._done = False
        self._lib: Optional[ctypes.CDLL] = None
        self._err: Optional[str] = None

    def get(self):
        with self._lock:
            if not self._done:
                try:
                    build()
                    self._lib = _bind(ctypes.CDLL(str(LIB_PATH)))
                except (RuntimeError, OSError) as e:
                    self._err = str(e)
                self._done = True
            return self._lib, self._err


_loaded = _Loaded()


def get_lib():
    """The bound library (built on first call), or None if it cannot be
    built or loaded."""
    return _loaded.get()[0]


def available() -> bool:
    return get_lib() is not None


def load_error() -> Optional[str]:
    """Why the native runtime is not in use (None when it is)."""
    return _loaded.get()[1]


def _take_bytes(lib, ptr: ctypes.c_void_p, n: int) -> bytes:
    try:
        return ctypes.string_at(ptr, n)
    finally:
        lib.pt_free(ptr)


class BlockingQueue:
    """Bounded blocking queue of byte blobs on the native ring buffer.

    ``push`` returns True, or False on timeout; ``pop`` returns the blob,
    or None on timeout; both raise RuntimeError("queue closed") once the
    queue is closed (codes -1 timeout and -2 closed of the C side, as the
    JAX package's queue)."""

    def __init__(self, capacity: int):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError(f"native runtime unavailable: {load_error()}")
        self._q = self._lib.pt_queue_new(int(capacity))

    def push(self, data: bytes, timeout: float = -1.0) -> bool:
        rc = self._lib.pt_queue_push(self._q, data, len(data), float(timeout))
        if rc == -2:
            raise RuntimeError("queue closed")
        return rc == 0

    def pop(self, timeout: float = -1.0):
        out = ctypes.c_void_p()
        n = self._lib.pt_queue_pop(self._q, ctypes.byref(out), float(timeout))
        if n == -1:
            return None
        if n == -2:
            raise RuntimeError("queue closed")
        return _take_bytes(self._lib, out, n)

    def size(self) -> int:
        return self._lib.pt_queue_size(self._q)

    def close(self):
        self._lib.pt_queue_close(self._q)

    def __del__(self):
        try:
            if getattr(self, "_q", None):
                self._lib.pt_queue_free(self._q)
                self._q = None
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
