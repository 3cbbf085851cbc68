"""The port's data pipeline against the JAX package's ``io``.

- Datasets, samplers and the DataLoader: the same dataset, sampler and
  numpy seed give the same batches (compared as numpy), single-process
  and with worker processes; batches are torch tensors on the loader's
  device (``places``).
- ``ShardedSampleStream``: the same sample order, epoch lengths and
  ``(epoch, pos)`` cursors as the JAX stream, rank-striped and global;
  a cursor checkpoint written by either package restores the other's
  stream to the same position; ``StreamLoader`` delivers the same
  batches and advances the cursor only by what it delivered.
- Liveness: a DataLoader worker killed by SIGKILL raises
  ``DataLoaderWorkerError``, a stalled one ``DataLoaderTimeout``; a killed
  stream fetcher raises ``DataLoaderWorkerError`` and ``recover()``
  resumes from the cursor with no duplicate or lost sample.

Exact: integer and float32 samples, compared bitwise.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu.distributed.ckpt_manager import CheckpointManager as JMgr
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.distributed import chaos
from paddle_tpu_torch.distributed.ckpt_manager import CheckpointManager
from paddle_tpu_torch.utils.deadline import DataLoaderTimeout


class _Squares:
    """A map-style dataset for both packages: (x, x**2, label)."""

    def __init__(self, n=23):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        x = np.full((3,), i, np.float32)
        return x, x * x, int(i % 5)


def _np(tree):
    if isinstance(tree, (list, tuple)):
        return [_np(t) for t in tree]
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def _batches(mod, ds, seed, **kw):
    np.random.seed(seed)
    if mod is pio:
        kw["places"] = "cpu"
    return [_np(b) for b in mod.DataLoader(ds, **kw)]


def _bytes(batches):
    return [[a.tobytes() for a in b] for b in batches]


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=False),
    dict(batch_size=5, shuffle=True, drop_last=True),
    dict(batch_size=4, shuffle=True, num_workers=2),
], ids=["sequence", "shuffle_drop_last", "two_workers"])
def test_dataloader_batches_equal_the_jax_loader(kw):
    ds = _Squares()
    want = _batches(jio, ds, 3, **kw)
    got = _batches(pio, ds, 3, **kw)
    assert _bytes(got) == _bytes(want) and len(got) >= 4


def test_samplers_datasets_and_devices():
    ds = _Squares(10)
    for mod_sampler in ("SequenceSampler", "RandomSampler"):
        np.random.seed(1)
        want = list(getattr(jio, mod_sampler)(ds))
        np.random.seed(1)
        assert list(getattr(pio, mod_sampler)(ds)) == want
    dbs = [list(m.DistributedBatchSampler(ds, 3, num_replicas=2, rank=1,
                                          shuffle=True)) for m in (jio, pio)]
    assert dbs[0] == dbs[1]
    parts = [[len(p) for p in m.random_split(ds, [6, 4])] for m in (jio, pio)]
    assert parts[0] == parts[1] == [6, 4]
    cat = pio.ConcatDataset([_Squares(3), _Squares(4)])
    assert len(cat) == 7 and cat[5][2] == 2
    batch = next(iter(pio.DataLoader(ds, batch_size=2, places="cpu")))
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in batch)
    assert batch[2].dtype == torch.int64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pio.DataLoader(ds, batch_size=2)


def _shards(n_shards=5, per=7):
    return [[np.asarray([100 * s + i, s], np.int64) for i in range(per)]
            for s in range(n_shards)]


@pytest.mark.parametrize("world,rank", [(1, 0), (2, 1), (3, 0)])
def test_stream_order_and_cursors_equal_the_jax_stream(world, rank):
    js = jio.ShardedSampleStream(_shards(), world_size=world, rank=rank,
                                 seed=4)
    ps = pio.ShardedSampleStream(_shards(), world_size=world, rank=rank,
                                 seed=4)
    for _ in range(3):                              # three epochs
        assert ps.epoch_len() == js.epoch_len()
        got = [s.tobytes() for s in ps]
        assert got == [s.tobytes() for s in js]
        assert ps.state_dict() == js.state_dict()
        ps.roll_epoch()
        js.roll_epoch()


def test_cursor_checkpoints_read_across_packages(tmp_path):
    """A generation with state and cursor written by one package restores
    the other's fresh stream to the same (epoch, pos)."""
    state = {"w": np.arange(6, dtype=np.float32)}
    for w_mod, w_mgr, r_mod, r_mgr in ((jio, JMgr, pio, CheckpointManager),
                                       (pio, CheckpointManager, jio, JMgr)):
        root = tmp_path / w_mod.__name__.split(".")[0]
        stream = w_mod.ShardedSampleStream(_shards(), seed=2)
        stream.roll_epoch()
        stream.advance(9)
        w_mod.save_stream_checkpoint(w_mgr(str(root)), state, 3, stream)
        fresh = r_mod.ShardedSampleStream(_shards(), seed=2)
        got = {"w": np.zeros(6, np.float32)}
        assert r_mod.restore_stream_checkpoint(r_mgr(str(root)), got,
                                               fresh) == 3
        assert (fresh.epoch, fresh.pos) == (1, 9)
        assert np.array_equal(got["w"], state["w"])


def test_stream_loader_batches_and_cursor_equal_the_jax_loader():
    out = []
    for mod in (jio, pio):
        stream = mod.ShardedSampleStream(_shards(), seed=6)
        kw = {"device": "cpu"} if mod is pio else {}
        loader = mod.StreamLoader(stream, batch_size=4, timeout=20, **kw)
        got = []
        for i, b in enumerate(loader):
            got.append(_np(b).tobytes())
            if i == 3:
                out.append((got, stream.state_dict()))
                break
    assert out[0] == out[1] and out[1][1]["pos"] == 16


def test_dataloader_worker_sigkill_is_typed(monkeypatch):
    monkeypatch.setenv("PT_FAULTPOINT", "io.worker_batch")
    monkeypatch.setenv("PT_FAULTPOINT_MODE", "crash")
    chaos.reset_hits()
    loader = pio.DataLoader(_Squares(), batch_size=2, num_workers=2,
                            places="cpu")
    with pytest.raises(pio.DataLoaderWorkerError, match="signal 9"):
        for _ in loader:
            pass
    chaos.reset_hits()


def test_dataloader_stalled_worker_is_typed_timeout(monkeypatch):
    monkeypatch.setenv("PT_FAULTPOINT", "io.worker_batch")
    monkeypatch.setenv("PT_FAULTPOINT_MODE", "delay:30")
    chaos.reset_hits()
    loader = pio.DataLoader(_Squares(), batch_size=2, num_workers=1,
                            timeout=0.5, places="cpu")
    with pytest.raises(DataLoaderTimeout):
        for _ in loader:
            pass
    chaos.reset_hits()


def test_stream_fetcher_sigkill_then_recover_exactly_once(monkeypatch):
    monkeypatch.setenv("PT_FAULTPOINT", "io.stream_fetch")
    monkeypatch.setenv("PT_FAULTPOINT_MODE", "crash")
    monkeypatch.setenv("PT_FAULTPOINT_SKIP", "2")
    chaos.reset_hits()
    stream = pio.ShardedSampleStream(_shards(), seed=1)
    loader = pio.StreamLoader(stream, batch_size=3, timeout=20,
                              device="cpu")
    seen = []
    with pytest.raises(pio.DataLoaderWorkerError):
        for b in loader:
            seen.extend(int(r[0]) for r in _np(b))
    monkeypatch.delenv("PT_FAULTPOINT")
    # the batches the fetcher queued before its death may die with its
    # queue's feeder thread: the cursor counts what was delivered
    assert stream.pos == len(seen) <= 6 and len(seen) % 3 == 0
    for b in loader.recover():
        seen.extend(int(r[0]) for r in _np(b))
    want = [int(s[0]) for s in pio.ShardedSampleStream(_shards(), seed=1)]
    assert seen == want
    chaos.reset_hits()
