"""The fleet's utility surface: ``UtilBase``, the data generators and the
``Fleet`` class.

Counterpart of ``paddle_tpu/distributed/fleet/util.py`` (after Paddle's
``fleet/base/util_factory.py``, ``fleet/data_generator/data_generator.py``
and ``fleet/fleet.py``). ``UtilBase``'s reductions, gathers and barrier
run over every rank of ``torch.distributed`` (one process a rank) through
the mesh's gloo twin of the world group, so they never touch a device
stream; the JAX class goes through the store, one controller a host.
Without a process group they act on this process alone.
"""
from __future__ import annotations

import os
import sys
from typing import List

import torch.distributed as dist

__all__ = ["UtilBase", "DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator", "Fleet"]


def _world():
    """(rank, world, gloo group of every rank or None)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1, None
    from ...parallel import mesh as mesh_mod
    mesh = mesh_mod.get_mesh()
    group = mesh.cpu_group(None) if mesh is not None and \
        mesh.size == dist.get_world_size() else None
    return dist.get_rank(), dist.get_world_size(), group


class UtilBase:
    """Cluster utilities bound to the collective runtime
    (``util_factory.py`` UtilBase): reductions and a barrier over Python
    values, plus file-list sharding."""

    def __init__(self):
        self.role_maker = None
        self.fs_client = None

    def _set_role_maker(self, role_maker):
        self.role_maker = role_maker

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        import numpy as np
        arr = np.asarray(input)
        _, world, _ = _world()
        if world <= 1:
            return arr
        stack = np.stack([np.asarray(v) for v in self.all_reduce_objects(arr)])
        return {"sum": stack.sum(0), "max": stack.max(0),
                "min": stack.min(0)}[mode]

    def barrier(self, comm_world="worker"):
        _, world, group = _world()
        if world > 1:
            dist.barrier(group=group)

    def all_gather(self, input, comm_world="worker"):
        _, world, _ = _world()
        if world <= 1:
            return [input]
        return list(self.all_reduce_objects(input))

    def all_reduce_objects(self, obj):
        """Every rank's ``obj``, in rank order."""
        _, world, group = _world()
        if world <= 1:
            return [obj]
        out = [None] * world
        dist.all_gather_object(out, obj, group=group)
        return out

    def get_file_shard(self, files: List[str]) -> List[str]:
        """This worker's contiguous share of ``files`` (the first
        ``len % world`` workers take one more): rank and world from
        ``torch.distributed``, else ``PADDLE_TRAINER_ID`` /
        ``PADDLE_TRAINERS_NUM``."""
        rank, world, _ = _world()
        if world <= 1:
            rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
            world = max(1, int(os.environ.get("PADDLE_TRAINERS_NUM", 1)))
        n = len(files)
        base, rem = divmod(n, world)
        start = rank * base + min(rank, rem)
        end = start + base + (1 if rank < rem else 0)
        return list(files)[start:end]

    def print_on_rank(self, message, rank_id=0):
        rank, world, _ = _world()
        if world <= 1:
            rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
        if rank == rank_id:
            print(message)


class DataGenerator:
    """Line -> samples pipeline base (``data_generator.py:28``): subclasses
    override ``generate_sample(line)``; ``run_from_stdin`` streams the
    datafeed text protocol."""

    def __init__(self):
        self.batch_size_ = 32
        self._proto_info = None

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    def generate_sample(self, line):
        raise NotImplementedError(
            "subclass DataGenerator and implement generate_sample(line)")

    def generate_batch(self, samples):
        def local_iter():
            for s in samples:
                yield s
        return local_iter

    def _gen_str(self, line):
        raise NotImplementedError

    def _emit(self, samples):
        batch = []
        for sample in samples:
            batch.append(sample)
            if len(batch) == self.batch_size_:
                yield from (self._gen_str(s)
                            for s in self.generate_batch(batch)())
                batch = []
        if batch:
            yield from (self._gen_str(s) for s in self.generate_batch(batch)())

    def run_from_stdin(self):
        for line in sys.stdin:
            for text in self._emit(self.generate_sample(line)()):
                sys.stdout.write(text)

    def run_from_memory(self):
        return list(self._emit(self.generate_sample(None)()))


class MultiSlotDataGenerator(DataGenerator):
    """Datafeed text protocol: ``[(name, [id, ...]), ...]`` ->
    ``"len id..."`` per slot (``data_generator.py:233``)."""

    def _gen_str(self, line):
        parts = []
        for _name, ids in line:
            parts.append(str(len(ids)))
            parts += [str(i) for i in ids]
        return " ".join(parts) + "\n"


class MultiSlotStringDataGenerator(MultiSlotDataGenerator):
    """The same protocol with string ids."""


class Fleet:
    """Class form of the fleet module API (``fleet/fleet.py:99``): the
    module functions are the instance's methods, so both
    ``distributed.fleet.init(...)`` and ``Fleet().init(...)`` work."""

    def __init__(self):
        self.util = UtilBase()

    def init(self, role_maker=None, is_collective=False, strategy=None,
             log_level="INFO"):
        from . import fleet as _f
        _f.init(role_maker=role_maker, is_collective=is_collective,
                strategy=strategy, log_level=log_level)
        if role_maker is not None:
            self.util._set_role_maker(role_maker)
        return self

    def __getattr__(self, item):
        from . import fleet as _f
        return getattr(_f, item)
