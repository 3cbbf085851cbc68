"""The port's host runtime, TCPStore, elastic membership and rpc against
the JAX package's.

- Wire compatibility: a port ``TCPStore`` client against a JAX master and
  a JAX client against a port master (native servers, and the port's
  pure-Python server) give equal answers to set, get, add, the bounded
  wait, delete and leases; a port ``ElasticManager`` and a JAX one on one
  store see the same alive roster, also after a lease lapses.
- The native runtime: the port builds ``csrc/host_runtime.cc`` into
  ``build/paddle_tpu_torch/`` and writes nothing under ``paddle_tpu/``;
  its blocking queue gives the JAX queue's push, pop, timeout and close
  results.
- rpc: ``init_rpc`` / ``rpc_sync`` / ``rpc_async`` / the getters on a
  one-worker job, and a port client calling a JAX worker's server (the
  HMAC-framed wire is the same).

Exact: every answer is bytes or an integer. Leases use 0.1 s heartbeats
and a 0.6 s timeout, as the JAX tests.
"""
import time
from pathlib import Path

import pytest

from paddle_tpu.distributed import store as jstore
from paddle_tpu.distributed.launch import elastic as jelastic
from paddle_tpu.utils import native as jnative
from paddle_tpu_torch.distributed import store as pstore
from paddle_tpu_torch.distributed.launch import elastic as pelastic
from paddle_tpu_torch.utils import deadline as pdl
from paddle_tpu_torch.utils import native as pnative

ROOT = Path(__file__).resolve().parents[1]


def _script(store, other):
    """One fixed sequence of store operations; returns every answer."""
    out = []
    store.set("k", b"v1")
    out.append(other.get("k"))
    other.set("k", "v2")
    out.append(store.get("k"))
    out.append(store.add("n", 5))
    out.append(other.add("n", -2))
    out.append(store.add("n", 0))
    other.wait("k", timeout=2.0)
    try:
        store.wait("never", timeout=0.3)
        out.append("no timeout")
    except Exception as e:  # noqa: BLE001 — the type is the answer
        out.append(type(e).__name__)
    out.append(other.delete_key("k"))
    out.append(store.delete_key("k"))
    store.lease("L", 300)
    out.append(other.lease_alive("L"))
    time.sleep(0.45)
    out.append(other.lease_alive("L"))
    out.append(store.lease_alive("absent"))
    return out


@pytest.fixture(params=["jax-master", "port-master", "port-py-master"])
def pair(request, monkeypatch):
    """(master, client of the other package) for each direction; the last
    is the port's pure-Python server under a JAX client."""
    if request.param == "jax-master":
        master = jstore.create_master_store()
        client = pstore.TCPStore("127.0.0.1", master.port)
    else:
        if request.param == "port-py-master":
            class _NoNative:
                @staticmethod
                def get_lib():
                    return None
            monkeypatch.setattr(pstore, "native", _NoNative)
        master = pstore.create_master_store()
        client = jstore.TCPStore("127.0.0.1", master.port)
    yield master, client
    client.stop()
    master.stop()


def test_store_wire_compatible_both_ways(pair):
    """The same script through a same-package pair and a cross-package
    pair gives equal answers (set/get/add/wait/delete/leases)."""
    master, client = pair
    ref = jstore.create_master_store()
    ref_client = jstore.TCPStore("127.0.0.1", ref.port)
    try:
        want = _script(ref, ref_client)
    finally:
        ref_client.stop()
        ref.stop()
    got = _script(master, client)
    assert got == want
    assert want[5] == "StoreTimeout" and want[8:10] == [True, False]


def test_store_timeout_and_connection_error_types():
    """The typed errors sit where the JAX package puts them: StoreTimeout
    under DeadlineExceeded, StoreConnectionError a ConnectionError."""
    from paddle_tpu.utils import deadline as jdl
    for name in ("StoreTimeout", "RpcTimeout", "DataLoaderTimeout",
                 "ReshardTimeout", "MembershipTimeout", "SupervisorTimeout"):
        assert issubclass(getattr(pdl, name), pdl.DeadlineExceeded), name
        assert issubclass(getattr(jdl, name), jdl.DeadlineExceeded), name
        assert getattr(pdl, name).__doc__ == getattr(jdl, name).__doc__
    assert issubclass(pdl.StoreConnectionError, ConnectionError)
    assert not issubclass(pdl.StoreConnectionError, pdl.DeadlineExceeded)
    assert str(pdl.StoreTimeout("w", 1.0, detail="d")) == \
        str(jdl.StoreTimeout("w", 1.0, detail="d"))


def test_elastic_managers_of_both_packages_share_a_roster():
    """A port member and a JAX member on one store: both see both, then
    the port member's lease lapses (heartbeat stopped) and both see the
    JAX member alone; re-ranks agree."""
    store = pstore.create_master_store()
    jclient = jstore.TCPStore("127.0.0.1", store.port)
    a = jelastic.ElasticManager(jclient, node_id="a", np_range=(1, 2),
                                heartbeat_interval=0.1, timeout=0.6)
    b = pelastic.ElasticManager(store, node_id="b", np_range=(1, 2),
                                heartbeat_interval=0.1, timeout=0.6)
    try:
        assert a.wait_for_np(2, timeout=5) and b.wait_for_np(2, timeout=5)
        assert a.alive_members() == b.alive_members() == ["a", "b"]
        assert (a.rank_of(), b.rank_of()) == (0, 1)
        a.commit_roster()
        b.stop()                      # the lease is no longer refreshed
        time.sleep(1.2)               # > ttl = 2 x 0.1 + 0.6
        assert a.alive_members() == b.alive_members() == ["a"]
        assert a.watch_once() == jelastic.ElasticStatus.RESTART
        assert b.watch_once() == pelastic.ElasticStatus.EXIT
        with pytest.raises(pdl.MembershipTimeout, match="only 1 alive"):
            b.require_np(2, timeout=0.3)
    finally:
        a.stop()
        b.stop()
        jclient.stop()
        store.stop()


def test_native_runtime_builds_under_build_and_not_in_the_reference():
    assert pnative.available(), pnative.load_error()
    assert pnative.LIB_PATH == ROOT / "build" / "paddle_tpu_torch" / \
        "libpt_host_runtime.so"
    assert pnative.LIB_PATH.is_file()
    assert pnative.LIB_PATH.with_suffix(".sha256").is_file()
    before = sorted(p.name for p in (ROOT / "paddle_tpu" / "csrc").iterdir()
                    if "host_runtime" in p.name)
    pnative.build()                   # up to date: a no-op
    assert sorted(p.name for p in (ROOT / "paddle_tpu" / "csrc").iterdir()
                  if "host_runtime" in p.name) == before == []
    assert pnative.get_lib().pt_now_ns() > 0


def _queue_script(q):
    out = [q.push(b"x", 0.1), q.push(b"y", 0.1), q.size(), q.pop(0.1),
           q.pop(0.1), q.push(b"z", -1.0), q.pop(-1.0)]
    q.close()
    for op in (lambda: q.push(b"w"), lambda: q.pop(0.1)):
        try:
            out.append(op())
        except RuntimeError as e:
            out.append(str(e))
    return out


def test_blocking_queue_codes_equal_the_jax_queue():
    """push/pop results, the -1 timeout (False / None) and the -2 close
    ("queue closed") of a capacity-1 queue."""
    if not jnative.available():
        pytest.skip("the JAX package's native runtime did not build")
    got = _queue_script(pnative.BlockingQueue(1))
    assert got == _queue_script(jnative.BlockingQueue(1))
    assert got[:5] == [True, False, 1, b"x", None]


def _square(x):
    return x * x


def test_rpc_solo_worker_and_cross_package_call():
    """init_rpc with one worker: rpc_sync, rpc_async, the getters and
    shutdown; then a JAX worker's server answers the port's transport
    (same HMAC-framed messages)."""
    from paddle_tpu.distributed import rpc as jrpc
    from paddle_tpu_torch.distributed import rpc as prpc
    prpc.init_rpc("solo", rank=0, world_size=1)
    try:
        assert prpc.rpc_sync("solo", _square, args=(7,), timeout=10) == 49
        assert prpc.rpc_async("solo", _square, args=(3,)).wait() == 9
        info = prpc.get_current_worker_info()
        assert (info.name, info.rank) == ("solo", 0)
        assert prpc.get_worker_info("solo") == info
        assert prpc.get_all_worker_infos() == [info]
        with pytest.raises(RuntimeError, match="failed remotely"):
            prpc.rpc_sync("solo", _square, args=("a",), timeout=10)
    finally:
        prpc.shutdown()
    jrpc.init_rpc("jsolo", rank=0, world_size=1)
    try:
        jst = jrpc._require_state()
        info = jst.workers["jsolo"]
        st = prpc._RpcState("p", 0, 1, None, jst.server, None)
        st.workers = {"jsolo": info}
        prpc._rpc_state.put("state", st)
        try:
            assert prpc._invoke("jsolo", _square, (12,), {}, 10.0) == 144
        finally:
            prpc._rpc_state.pop("state")
    finally:
        jrpc.shutdown()


def test_rpc_before_init_raises():
    from paddle_tpu_torch.distributed import rpc as prpc
    assert prpc.RpcTimeout is pdl.RpcTimeout
    with pytest.raises(RuntimeError, match="init_rpc"):
        prpc.rpc_sync("nobody", _square, args=(1,))
