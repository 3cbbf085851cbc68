"""The no-hang fault matrix on the port's store, rpc, data loader,
reshard, supervisor and sharded-commit layers.

Every (site, mode) row of the JAX package's matrix (``tests/test_no_hang.py``
``MATRIX``) for a site the port registers is the port's expectation too:
the same typed error, a clean absorb, or a SIGKILL at the site, each
within an explicit bound. In tier 1: the delay, error and drop modes of
the store, rpc, reshard and data-loader sites in this process (each under
a watchdog), the JAX file's quick store and rpc cases (a partitioned or
trickling master, a poisoned client healed at entry, ``stop()`` waking a
wait in flight, ops after ``stop()``, a wedged native rpc call bounded by
the Python deadline, ``timeout=None``), on the native and the Python
store, and its quick child cases (a crash at the store site; the
supervisor rendezvous, drain and sharded-stage stalls; the
receipt-collection drop) as port processes, started together. The full
site x mode matrix in child processes is ``slow``, as the JAX one is.
"""
import os
import signal
import subprocess
import sys
import threading

import pytest

from paddle_tpu_torch.distributed import chaos
from paddle_tpu_torch.distributed import (reshard, rpc, store,  # noqa: F401
                                          supervisor)
from paddle_tpu_torch.distributed.ckpt_manager import \
    CheckpointManager  # noqa: F401 — registers the ckpt.* sites
from paddle_tpu_torch.io import dataloader, streaming  # noqa: F401
from paddle_tpu_torch.utils.deadline import (RpcTimeout,
                                             StoreConnectionError,
                                             StoreTimeout)

import torch_no_hang_child as child
from test_no_hang import MATRIX, _HalfDeadServer, _TrickleServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "torch_no_hang_child.py")
PREFIXES = ("store.", "rpc.", "io.", "reshard.", "supervisor.", "ckpt.")
PORT_ROWS = sorted(k for k in MATRIX if k[0].startswith(PREFIXES))
IN_PROCESS = ("store.client.rpc", "store.wait", "rpc.invoke",
              "reshard.plan", "reshard.transfer", "reshard.commit",
              "io.worker_batch", "io.stream_fetch")
QUICK_CHILD = [("store.client.rpc", "crash"),
               ("supervisor.rendezvous", "delay:2.0"),
               ("supervisor.drain", "delay:2.0"),
               ("ckpt.shard_staged", "delay:2.0"),
               ("ckpt.receipts", "drop")]


def test_every_port_site_has_its_jax_rows():
    """The port registers exactly the JAX sites of these layers, each
    with all four modes in the matrix."""
    sites = set(chaos.fault_sites())
    port = {s for s in sites if s.startswith(PREFIXES)}
    assert port == {s for s, _ in PORT_ROWS}
    for s in port:
        assert {m.split(":")[0] for k, m in PORT_ROWS if k == s} == \
            {"crash", "delay", "error", "drop"}, s


def _run_bounded(fn, budget, what):
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(budget)
    if t.is_alive():
        pytest.fail(f"HANG: {what} still blocked after {budget}s")
    return box.get("error")


@pytest.mark.parametrize("site,mode", [
    k for k in PORT_ROWS if k[0] in IN_PROCESS and k[1] != "crash"],
    ids=lambda v: str(v))
def test_fault_in_process_ends_as_the_jax_row(site, mode, monkeypatch,
                                              tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PT_FAULTPOINT", site)
    monkeypatch.setenv("PT_FAULTPOINT_MODE", mode)
    monkeypatch.setenv("PT_FAULTPOINT_HITS", "1")
    monkeypatch.setenv("PT_FAULTPOINT_SKIP", "0")
    chaos.reset_hits()
    try:
        err = _run_bounded(lambda: child.main(site), 30.0,
                           f"{site} x {mode}")
    finally:
        chaos.reset_hits()
    expect, typed = MATRIX[(site, mode)]
    if expect == "clean":
        assert err is None, (site, mode, err)
    else:
        assert err is not None and type(err).__name__ == typed, \
            (site, mode, err)


def _spawn(site, mode, tmp_dir):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PT_FAULTPOINT", "PT_CRASHPOINT"))}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               PT_FAULTPOINT=site, PT_FAULTPOINT_MODE=mode,
               PT_FAULTPOINT_HITS="1", PT_FAULTPOINT_SKIP="0",
               PT_TEST_BUDGET="1.0")
    return subprocess.Popen([sys.executable, CHILD, site],
                            cwd=str(tmp_dir), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _outcome(site, mode, proc):
    out, err = proc.communicate(timeout=120)
    expect, typed = MATRIX[(site, mode)]
    label = f"{site} x {mode}"
    if expect == "sigkill":
        assert proc.returncode == -signal.SIGKILL, (label, proc.returncode,
                                                    err[-2000:])
    elif expect == "clean":
        assert proc.returncode == 0 and "CLEAN" in out, (label, out,
                                                         err[-2000:])
    else:
        assert proc.returncode == 3 and f"TYPED {typed}" in out, (
            label, out, err[-2000:])


@pytest.fixture(scope="module")
def quick_children(tmp_path_factory):
    procs = {}
    for site, mode in QUICK_CHILD:
        d = tmp_path_factory.mktemp(site.replace(".", "_"))
        procs[(site, mode)] = _spawn(site, mode, d)
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()


@pytest.mark.parametrize("site,mode", QUICK_CHILD, ids=lambda v: str(v))
def test_fault_in_a_port_process_ends_as_the_jax_row(quick_children, site,
                                                     mode):
    _outcome(site, mode, quick_children[(site, mode)])


@pytest.mark.slow
def test_full_port_fault_matrix_no_case_hangs(tmp_path):
    """Every port row in a child process, in waves of 8."""
    for lo in range(0, len(PORT_ROWS), 8):
        procs = {}
        for site, mode in PORT_ROWS[lo:lo + 8]:
            d = tmp_path / f"{site}_{mode}".replace(".", "_").replace(
                ":", "_")
            d.mkdir()
            procs[(site, mode)] = _spawn(site, mode, d)
        for (site, mode), proc in procs.items():
            _outcome(site, mode, proc)


# ---------------- the JAX file's quick store and rpc cases ----------------

@pytest.fixture(params=["native", "py"])
def master_store(request, monkeypatch):
    if request.param == "py":
        class _NoNative:
            @staticmethod
            def get_lib():
                return None
        monkeypatch.setattr(store, "native", _NoNative)
    s = store.TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
    yield s
    s.stop()


def test_partitioned_master_raises_typed_timeout_then_terminal():
    srv = _HalfDeadServer()
    try:
        c = store._PyClient("127.0.0.1", srv.port, timeout=10.0)
        err = _run_bounded(lambda: c.rpc(store._GET, "k", timeout=0.4),
                           10.0, "rpc against a partitioned master")
        assert isinstance(err, StoreTimeout), err
        with pytest.raises(StoreConnectionError, match="disconnected"):
            c.rpc(store._GET, "k", timeout=0.4)
        c.close()
    finally:
        srv.close()


def test_trickling_master_cannot_stretch_the_deadline():
    srv = _TrickleServer()
    try:
        c = store._PyClient("127.0.0.1", srv.port, timeout=10.0)
        err = _run_bounded(lambda: c.rpc(store._GET, "k", timeout=0.5),
                           10.0, "rpc against a trickling master")
        assert isinstance(err, StoreTimeout), err
        c.close()
    finally:
        srv.close()


def test_add_on_poisoned_client_heals_at_entry_exactly_once(master_store):
    assert master_store.add("cnt", 1) == 1
    if master_store._lib is not None:
        master_store._lib.pt_store_client_shutdown(master_store._client)
    else:
        master_store._client._teardown()
    box = {}
    assert _run_bounded(lambda: box.setdefault("v", master_store.add(
        "cnt", 1)), 30.0, "add on a poisoned client") is None
    assert box["v"] == 2


def test_stop_interrupts_inflight_wait(master_store):
    import time
    errs = {}

    def waiter():
        try:
            master_store.wait("never/while/stopping", timeout=30.0)
        except Exception as e:  # noqa: BLE001 — the type is the assertion
            errs["e"] = e

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    time.sleep(0.3)
    t0 = time.monotonic()
    master_store.stop()
    assert time.monotonic() - t0 < 5.0
    t.join(10.0)
    assert not t.is_alive()
    assert isinstance(errs.get("e"),
                      (StoreConnectionError, StoreTimeout, RuntimeError)), errs


def test_ops_after_stop_raise_typed_never_crash(monkeypatch):
    monkeypatch.setenv("PT_STORE_RECONNECT_TIMEOUT", "0.5")
    s = store.create_master_store()
    s.set("k", b"v")
    s.stop()
    err = _run_bounded(lambda: s.get("k"), 30.0, "store op after stop()")
    assert isinstance(err, (StoreConnectionError, StoreTimeout)), err


class _WedgedNativeLib:
    """pt_rpc_call ignoring its C-side timeout: the Python deadline must
    abandon it with the typed RpcTimeout."""

    @staticmethod
    def pt_rpc_call(*_a):
        import time
        time.sleep(5.0)
        return -3

    @staticmethod
    def pt_free(_p):
        pass


@pytest.fixture
def solo_rpc():
    rpc.init_rpc("solo", rank=0, world_size=1)
    yield
    rpc.shutdown()


def test_native_rpc_overrun_bounded_by_python_deadline(solo_rpc,
                                                       monkeypatch):
    from paddle_tpu_torch.utils import native as native_mod
    monkeypatch.setattr(native_mod, "get_lib", lambda: _WedgedNativeLib)
    err = _run_bounded(lambda: rpc.rpc_sync("solo", int, args=("7",),
                                            timeout=0.4),
                       3.0, "rpc_sync over a wedged native transport")
    assert isinstance(err, RpcTimeout) and "abandoned" in str(err)


def test_rpc_timeout_none_is_unbounded_and_works(solo_rpc):
    box = {}
    assert _run_bounded(lambda: box.setdefault("v", rpc.rpc_sync(
        "solo", int, args=("9",), timeout=None)), 15.0,
        "rpc_sync with timeout=None") is None
    assert box["v"] == 9
