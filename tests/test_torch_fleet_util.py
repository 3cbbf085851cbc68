"""The rest of the fleet's surface in the port, against the JAX package:
``fleet.util`` (``UtilBase``, the data generators, ``Fleet``),
``fleet.utils`` (``LocalFS``, ``HDFSClient``, ``DistributedInfer``, the
``recompute`` re-export), the ``distributed.sharding`` facade, and the
names ``utils.deadline`` and ``distributed.chaos`` gained for the
checkpoint layer. ``UtilBase``'s collectives run on spawned gloo ranks.
"""
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed import chaos as jchaos
from paddle_tpu.distributed.fleet import util as jutil
from paddle_tpu.distributed.fleet import utils as jutils
from paddle_tpu.utils import deadline as jdl
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import chaos as tchaos
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed import sharding as tsharding
from paddle_tpu_torch.distributed.fleet import util as tutil
from paddle_tpu_torch.distributed.fleet import utils as tutils
from paddle_tpu_torch.utils import deadline as tdl

import torch_dist


class _Slots:
    """A generator over three in-memory lines of ``a,b;c`` slots."""

    LINES = ["1,2;3", "4;5,6,7", "8,9;"]

    def generate_sample(self, line):
        def it():
            for text in self.LINES:
                a, b = text.split(";")
                yield [("a", [int(v) for v in a.split(",") if v]),
                       ("b", [int(v) for v in b.split(",") if v])]
        return it


@pytest.mark.parametrize("kind", ["MultiSlotDataGenerator",
                                  "MultiSlotStringDataGenerator"])
@pytest.mark.parametrize("batch", [1, 2, 32])
def test_data_generators_match_jax(kind, batch):
    outs = []
    for mod in (jutil, tutil):
        cls = type("G", (_Slots, getattr(mod, kind)), {})
        g = cls()
        g.set_batch(batch)
        outs.append(g.run_from_memory())
    assert outs[0] == outs[1] and len(outs[0]) == 3


def test_file_shard_matches_jax_from_the_launcher_env(monkeypatch):
    files = [f"part-{i}" for i in range(11)]
    for world in (1, 2, 3, 4):
        for rank in range(world):
            monkeypatch.setenv("PADDLE_TRAINER_ID", str(rank))
            monkeypatch.setenv("PADDLE_TRAINERS_NUM", str(world))
            assert tutil.UtilBase().get_file_shard(files) == \
                jutil.UtilBase().get_file_shard(files)


def test_util_collectives_over_two_ranks(tmp_path):
    res = torch_dist.spawn("fleet_util", 2, tmp_path, {"mesh": {"dp": 2}})
    x = [np.arange(4.0), np.arange(4.0) * 2]
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["sum"], x[0] + x[1])
        np.testing.assert_array_equal(out["max"], x[1])
        np.testing.assert_array_equal(out["min"], x[0])
        assert out["gather"] == [{"rank": 0}, {"rank": 1}]
    files = [f"f{i}" for i in range(7)]
    assert res[0]["shard"] + res[1]["shard"] == files
    assert res[0]["shard"] == files[:4]


def test_util_without_a_process_group_is_local(capsys, monkeypatch):
    u = tutil.UtilBase()
    np.testing.assert_array_equal(u.all_reduce([1, 2], "max"), [1, 2])
    assert u.all_gather(3) == [3]
    u.barrier()
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    u.print_on_rank("hello", 0)
    u.print_on_rank("not me", 1)
    assert capsys.readouterr().out == "hello\n"


def test_fleet_class_wraps_the_module_functions():
    f = tfleet.Fleet()
    assert isinstance(f.util, tfleet.UtilBase)
    assert f.worker_num is tfleet.fleet.worker_num
    assert f.get_hybrid_communicate_group is \
        tfleet.get_hybrid_communicate_group


def test_local_fs_matches_jax(tmp_path):
    seen = []
    for i, fs in enumerate((jutils.LocalFS(), tutils.LocalFS())):
        base = tmp_path / str(i)
        fs.mkdirs(str(base / "d1"))
        fs.touch(str(base / "f1"))
        with pytest.raises(FileExistsError):
            fs.touch(str(base / "f1"), exist_ok=False)
        fs.mv(str(base / "f1"), str(base / "f2"))
        with pytest.raises(FileExistsError):
            fs.mv(str(base / "d1"), str(base / "f2"))
        listing = fs.ls_dir(str(base))
        seen.append((listing, fs.list_dirs(str(base)),
                     fs.is_file(str(base / "f2")),
                     fs.is_dir(str(base / "d1")),
                     fs.is_exist(str(base / "f1")),
                     fs.need_upload_download()))
        fs.delete(str(base / "d1"))
        fs.delete(str(base / "f2"))
        assert fs.ls_dir(str(base)) == ([], [])
    assert seen[0] == seen[1]
    assert seen[1][0] == (["d1"], ["f2"])


def test_hdfs_raises_and_infer_and_recompute_reexport():
    with pytest.raises(RuntimeError, match="hadoop"):
        tutils.HDFSClient()
    di = tutils.DistributedInfer(main_program="prog")
    assert di.get_dist_infer_program() == "prog"
    assert di.init_distributed_infer_env(None, None) is None
    assert tutils.recompute is tfleet.recompute
    assert set(tutils.__all__) == set(jutils.__all__)


def test_sharding_facade_and_package_exports():
    assert tsharding.group_sharded_parallel is \
        tdist.group_sharded_parallel
    assert tsharding.save_group_sharded_model is \
        tdist.save_group_sharded_model
    for name in ("CheckpointManager", "CheckpointCorruptionError",
                 "save_state_dict", "load_state_dict", "checkpoint",
                 "chaos"):
        assert hasattr(tdist, name), name
    for name in ("MoELayer", "NaiveGate", "GShardGate", "SwitchGate",
                 "recompute", "recompute_sequential", "recompute_hybrid",
                 "UtilBase", "DataGenerator", "MultiSlotDataGenerator",
                 "MultiSlotStringDataGenerator", "Fleet", "utils"):
        assert hasattr(tfleet, name), name
    for name in ("RNGStatesTracker", "get_rng_state_tracker",
                 "model_parallel_random_seed"):
        assert hasattr(tfleet.meta_parallel, name), name


def test_join_bounded_and_checkpoint_timeout(monkeypatch):
    assert issubclass(tdl.CheckpointTimeout, tdl.DeadlineExceeded)
    done = threading.Thread(target=lambda: None)
    done.start()
    tdl.join_bounded(done, "quick")
    stop = threading.Event()
    slow = threading.Thread(target=stop.wait, daemon=True)
    slow.start()
    monkeypatch.setenv("PT_CKPT_WAIT_TIMEOUT", "0.05")
    t0 = time.monotonic()
    with pytest.raises(tdl.DeadlineExceeded, match="wedged"):
        tdl.join_bounded(slow, "slow writer")
    assert time.monotonic() - t0 < 5
    stop.set()
    with pytest.raises(tdl.CheckpointTimeout):
        tdl.Deadline(0.0, "x").check("x", exc=tdl.CheckpointTimeout)
    assert str(tdl.CheckpointTimeout("w", 1.0, "d")) == \
        str(jdl.CheckpointTimeout("w", 1.0, "d"))


def test_chaos_registry_matches_jax():
    import paddle_tpu.distributed.ckpt_manager  # noqa: F401 — registers
    import paddle_tpu_torch.distributed.ckpt_manager  # noqa: F401
    assert tchaos.registered_sites("ckpt.") == \
        jchaos.registered_sites("ckpt.")
    assert set(tchaos.fault_sites("ckpt.")) == \
        set(jchaos.fault_sites("ckpt."))
    for s in tchaos.registered_sites("ckpt."):
        assert tchaos.describe(s) == jchaos.describe(s)
    for s in tchaos.fault_sites("ckpt."):
        assert tchaos.describe_fault(s) == jchaos.describe_fault(s)
    assert tchaos.register("test.site", "d") == "test.site"
    assert "test.site" in tchaos.registered_sites("test.")
    tchaos.crashpoint("test.site")         # unarmed: a no-op
