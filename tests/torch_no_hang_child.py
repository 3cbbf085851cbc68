"""One blocking operation of the port under an armed fault, for the
port's no-hang tests (tests/test_torch_no_hang.py).

``main(site)`` runs the operation that crosses ``site`` (a registered
fault site of the store, rpc, data loader, reshard, supervisor or
sharded-commit layers) with a small explicit budget (PT_TEST_BUDGET,
default 1 s); the test arms the fault through PT_FAULTPOINT*. In-process
tests call ``main`` directly; as a script it reports on stdout:

    CLEAN                    the op completed (fault absorbed or latency-only)
    TYPED <ExceptionName>    a typed error was raised (never a hang)

and a crash-mode fault SIGKILLs the process. The same operations as the
JAX package's ``tests/dist_workers/no_hang_child.py``, on the port; this
module imports no JAX.
"""
import os
import sys

BUDGET = float(os.environ.get("PT_TEST_BUDGET", "1.0"))


def main(site: str) -> None:
    if site == "store.client.rpc":
        from paddle_tpu_torch.distributed.store import create_master_store
        s = create_master_store()
        s.set("k", b"v")
        assert s.get("k") == b"v"
        s.stop()
    elif site == "store.wait":
        from paddle_tpu_torch.distributed.store import create_master_store
        s = create_master_store()
        s.set("k", b"v")
        s.wait("k", timeout=BUDGET)
        s.stop()
    elif site == "rpc.invoke":
        from paddle_tpu_torch.distributed import rpc
        rpc.init_rpc("solo", rank=0, world_size=1)
        try:
            assert rpc.rpc_sync("solo", int, args=("7",),
                                timeout=BUDGET) == 7
        finally:
            rpc.shutdown()
    elif site.startswith("reshard."):
        import numpy as np
        from paddle_tpu_torch.distributed import reshard as rs

        full = np.arange(32, dtype=np.float32).reshape(8, 4)
        src = rs.MeshSpec.from_members(["a", "b"])
        dst = rs.MeshSpec.from_members(["a"])
        params = {"w": rs.ParamSpec((8, 4), np.float32, ("dp", None),
                                    ("dp", None))}
        states = {"a": {"w": full[:4].copy()}, "b": {"w": full[4:].copy()}}
        out, _ = rs.redistribute(src, dst, params, states, budget=BUDGET)
        assert np.array_equal(out["a"]["w"], full)
    elif site == "supervisor.drain":
        import threading
        import numpy as np
        from paddle_tpu_torch.distributed.ckpt_manager import CheckpointManager
        from paddle_tpu_torch.distributed.launch.elastic import ElasticManager
        from paddle_tpu_torch.distributed.store import create_master_store
        from paddle_tpu_torch.distributed.supervisor import (Supervisor,
                                                       SupervisedParam)
        from paddle_tpu_torch.io import ShardedSampleStream

        # a COORDINATED drain: two real supervisors in lockstep (step
        # barrier ON, short slices so a's barrier wait re-checks the
        # drain counter fast), member b announces its departure (the
        # armed site) and leaves through its own farewell rendezvous
        # while a absorbs the shrink. A stalled announcement must burn
        # b's drain Deadline into the typed SupervisorTimeout — never
        # wedge either member.
        store = create_master_store()
        shards = [[np.full((2,), 10 * s + i, np.float32) for i in range(4)]
                  for s in range(3)]
        mgrs, sups, errors, threads = {}, {}, {}, {}
        for n in ("a", "b"):
            mgrs[n] = ElasticManager(store, node_id=n, np_range=(1, 2),
                                     heartbeat_interval=0.1, timeout=0.5)
            sups[n] = Supervisor(
                store=store, elastic=mgrs[n],
                ckpt=CheckpointManager(os.path.join(os.getcwd(), "ckpt")),
                params={"w": SupervisedParam((4,), np.float32, (None,))},
                state={"w": np.ones((4,), np.float32)},
                stream=ShardedSampleStream(shards, seed=0),
                batch_size=2, budget=BUDGET, watch_budget=BUDGET,
                barrier=True, barrier_timeout=0.2, ckpt_every=1,
                churn_probe=0.2)

        def member(n):
            def fn(state, batch, s):
                if n == "b" and s.steps_done == 1:
                    s.request_stop(leave=True)
                return {"w": state["w"] + 1.0}
            try:
                sups[n].bind(2, timeout=10.0)
                sups[n].run(fn, 4)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors[n] = e

        try:
            for n in ("a", "b"):
                threads[n] = threading.Thread(target=member, args=(n,))
                threads[n].start()
            for t in threads.values():
                t.join(timeout=30.0)
            if "b" in errors:
                raise errors["b"]
            if "a" in errors:
                raise errors["a"]
            assert sups["a"].roster == ["a"], sups["a"].roster
            assert any(e.get("cause") == "drain"
                       for e in sups["a"].events), sups["a"].events
        finally:
            for n in ("a", "b"):
                sups[n].close()
                mgrs[n].stop()
            store.stop()
    elif site.startswith("supervisor."):
        import numpy as np
        from paddle_tpu_torch.distributed.ckpt_manager import CheckpointManager
        from paddle_tpu_torch.distributed.launch.elastic import ElasticManager
        from paddle_tpu_torch.distributed.store import create_master_store
        from paddle_tpu_torch.distributed.supervisor import (Supervisor,
                                                       SupervisedParam)
        from paddle_tpu_torch.io import ShardedSampleStream

        # ONE supervised scale event traverses all four supervisor.*
        # sites: a second (manager-only) member joins, then leaves after
        # step 2 — the supervisor detects the shrink, rendezvouses alone,
        # swaps and resumes. The state is REPLICATED so the event never
        # waits on the departed member's bytes (barrier off: b runs no
        # supervisor of its own).
        store = create_master_store()
        a = ElasticManager(store, node_id="a", np_range=(1, 2),
                           heartbeat_interval=0.1, timeout=0.5)
        b = ElasticManager(store, node_id="b", np_range=(1, 2),
                           heartbeat_interval=0.1, timeout=0.5)
        shards = [[np.full((2,), 10 * s + i, np.float32) for i in range(4)]
                  for s in range(3)]
        sup = Supervisor(
            store=store, elastic=a,
            ckpt=CheckpointManager(os.path.join(os.getcwd(), "ckpt")),
            params={"w": SupervisedParam((4,), np.float32, (None,))},
            state={"w": np.ones((4,), np.float32)},
            stream=ShardedSampleStream(shards, seed=0),
            batch_size=2, budget=BUDGET, watch_budget=BUDGET,
            barrier=False, ckpt_every=1, churn_probe=0.3)
        try:
            sup.bind(2, timeout=10.0)

            def fn(state, batch, s):
                if s.steps_done == 1:
                    b.leave()
                return {"w": state["w"] + 1.0}

            sup.run(fn, 4)
            assert sup.roster == ["a"], sup.roster
            assert sup.events, "no scale event ran"
        finally:
            sup.close()
            a.stop()
            b.stop()
            store.stop()
    elif site == "ckpt.shard_staged":
        import numpy as np
        from paddle_tpu_torch.distributed.ckpt_manager import CheckpointManager

        # one owner's whole sharded commit: stage (the armed site sits
        # between the shard file and its receipt) then self-commit. A
        # stall burns the commit Deadline into the typed
        # CheckpointTimeout and the generation never exists; a dropped
        # wire is absorbed by the stage's retry-once.
        mgr = CheckpointManager(os.path.join(os.getcwd(), "ckpt"))
        w = np.arange(8, dtype=np.float32)
        mgr.save_sharded(1, "a", ["a"], {"w|full": w},
                         {"w": {"shape": [8], "dtype": "float32",
                                "spec": [None]}},
                         budget=BUDGET)
        assert mgr.latest() == 1
    elif site == "ckpt.receipts":
        import threading
        import time
        import numpy as np
        from paddle_tpu_torch.distributed.ckpt_manager import CheckpointManager

        # the committer's receipt-collection poll: owner b stages LATE
        # (from a thread) so the committer's first poll finds b's receipt
        # missing and traverses the armed site. A stalled poll burns the
        # commit Deadline into the typed CheckpointTimeout; a dropped
        # wire is absorbed and the late receipt then completes the
        # commit.
        root = os.path.join(os.getcwd(), "ckpt")
        a, b = CheckpointManager(root), CheckpointManager(root)
        w = np.arange(8, dtype=np.float32)
        meta = {"w": {"shape": [8], "dtype": "float32", "spec": ["dp"]}}

        def late_stage():
            time.sleep(0.3)
            b.stage_shards(1, "b", {"w|4:8": w[4:]}, budget=BUDGET)

        t = threading.Thread(target=late_stage)
        t.start()
        try:
            a.save_sharded(1, "a", ["a", "b"], {"w|0:4": w[:4]}, meta,
                           budget=BUDGET)
        finally:
            t.join(timeout=5.0)
        assert a.latest() == 1
    elif site == "io.stream_fetch":
        import numpy as np
        from paddle_tpu_torch.io import ShardedSampleStream, StreamLoader

        shards = [[np.full((2,), 10 * s + i, np.float32) for i in range(4)]
                  for s in range(3)]
        stream = ShardedSampleStream(shards, seed=0)
        list(StreamLoader(stream, batch_size=4, timeout=BUDGET,
                         device="cpu"))
    elif site == "io.worker_batch":
        import numpy as np
        import paddle_tpu_torch.io as io

        class _DS(io.Dataset):
            def __len__(self):
                return 16

            def __getitem__(self, i):
                return np.full((2,), i, np.float32)

        list(io.DataLoader(_DS(), batch_size=4, num_workers=1,
                           timeout=BUDGET, places="cpu"))
    else:
        raise ValueError(f"unknown fault site {site!r}")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        main(sys.argv[1])
    except BaseException as e:  # noqa: BLE001 — the TYPE is the result
        print(f"TYPED {type(e).__name__}", flush=True)
        sys.exit(3)
    print("CLEAN", flush=True)
