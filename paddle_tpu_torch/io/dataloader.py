"""DataLoader with multiprocess workers + background feed thread.

Counterpart of ``paddle_tpu/io/dataloader.py`` (Paddle's
python/paddle/io/reader.py:216 DataLoader and the C++
LoDTensorBlockingQueue + background feeder,
io/dataloader/dataloader_iter.py:201). Worker processes produce numpy
batches over a multiprocessing queue; a background thread restores their
order and hands them over a bounded blocking queue, backed by the host
runtime's native ring buffer when it is built (``utils.native``), else a
Python queue. The consumer turns each batch into torch tensors on the
loader's device: ``places`` (a device or a list of them, the first taken),
by default the port's default device (``cuda``; pass ``places="cpu"`` for
the CPU). The JAX loader makes ``jnp`` arrays instead.

No hang: the receiver thread polls worker liveness on
every queue timeout, so a SIGKILLed/OOM-killed worker surfaces as a typed
`DataLoaderWorkerError` (worker id + exitcode) at the consumer instead of
spinning on an empty queue forever; `DataLoader(timeout=...)` bounds the
wait for any single batch with a typed `DataLoaderTimeout`; and iterator
teardown joins workers with a timeout, terminates stragglers, and drains
the mp queue so the fork context leaks no semaphores. The worker loop
carries the chaos site `io.worker_batch` (distributed/chaos.py) so the
fault matrix can kill/stall/fail a worker mid-epoch on demand.
"""
from __future__ import annotations

import itertools
import os
import queue as pyqueue
import threading
import time
import traceback

import numpy as np
import torch

from ..utils.deadline import DataLoaderTimeout
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler


class DataLoaderWorkerError(RuntimeError):
    """A DataLoader worker process died without delivering its batches
    (SIGKILL by the OOM killer, a segfault in native decode, a preemption).
    Carries the worker id and exitcode so logs name the culprit."""

    def __init__(self, worker_id: int, exitcode):
        self.worker_id = worker_id
        self.exitcode = exitcode
        desc = f"exitcode {exitcode}"
        if isinstance(exitcode, int) and exitcode < 0:
            desc = f"killed by signal {-exitcode}"
        super().__init__(
            f"DataLoader worker {worker_id} died ({desc}) before delivering "
            f"its batches — data order cannot be preserved; restart the "
            f"epoch (or lower worker memory pressure)")


def default_collate_fn(batch):
    """Stack a list of samples into CPU tensors (tuples, lists and dicts
    collated per field); strings and bytes stay a list."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, np.float32))
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return type(sample)(default_collate_fn(list(s)) for s in transposed)
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (str, bytes)):
        return list(batch)
    return batch


def _np_collate(batch):
    """Collate into numpy (runs in worker processes, which send numpy)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(sample, (list, tuple)):
        return type(sample)(_np_collate(list(s)) for s in zip(*batch))
    if isinstance(sample, dict):
        return {k: _np_collate([b[k] for b in batch]) for k in sample}
    return batch


def _to_tensor_tree(obj, device=None):
    """numpy arrays and tensors of a (nested) batch as tensors on
    ``device`` (left where they are when None)."""
    if isinstance(obj, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(obj))
        return t if device is None else t.to(device)
    if isinstance(obj, torch.Tensor):
        return obj if device is None else obj.to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_tensor_tree(o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_tensor_tree(v, device) for k, v in obj.items()}
    return obj


def _resolve_places(places) -> torch.device:
    """The loader's device: ``places`` (a device, a name, or a list of
    them whose first is taken), else the port's default device."""
    from ..core.device import resolve_device
    if isinstance(places, (list, tuple)):
        places = places[0] if places else None
    return resolve_device(places)


_CLOSED = object()


class _NativeOutQueue:
    """Bounded handoff over the native C++ ring buffer.

    The ring carries 8-byte tokens (bounded blocking semantics live in C++);
    the batch objects themselves stay in-process in a side table, so the
    handoff is zero-copy.
    """

    def __init__(self, depth):
        import struct
        from ..utils.native import BlockingQueue
        self._q = BlockingQueue(depth)
        self._struct = struct
        self._table = {}
        self._lock = threading.Lock()
        self._next = 0

    def put(self, obj) -> bool:
        with self._lock:
            tok = self._next
            self._next += 1
            self._table[tok] = obj
        try:
            self._q.push(self._struct.pack("<q", tok))
            return True
        except RuntimeError:  # closed by consumer
            with self._lock:
                self._table.pop(tok, None)
            return False

    def get(self):
        try:
            blob = self._q.pop()
        except RuntimeError:
            return _CLOSED
        if blob is None:
            return _CLOSED
        (tok,) = self._struct.unpack("<q", blob)
        with self._lock:
            return self._table.pop(tok)

    def close(self):
        self._q.close()


class _PyOutQueue:
    def __init__(self, depth):
        self._q = pyqueue.Queue(maxsize=depth)
        self._closed = False

    def put(self, obj) -> bool:
        while not self._closed:
            try:
                self._q.put(obj, timeout=0.1)
                return True
            except pyqueue.Full:
                continue
        return False

    def get(self):
        while True:
            try:
                return self._q.get(timeout=0.1)
            except pyqueue.Empty:
                if self._closed:
                    # drain: the producer may have put+closed between our
                    # Empty and the _closed check
                    try:
                        return self._q.get_nowait()
                    except pyqueue.Empty:
                        return _CLOSED

    def close(self):
        self._closed = True


def _make_blocking_queue(depth):
    from ..utils import native
    if native.available():
        return _NativeOutQueue(depth)
    return _PyOutQueue(depth)


class WorkerInfo:
    """Worker-process introspection (reference io/dataloader/worker.py:158):
    id / num_workers / seed / dataset, available inside dataset code via
    get_worker_info()."""

    def __init__(self, id, num_workers, seed, dataset):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.seed = seed
        self.dataset = dataset


# the WorkerInfo of this process, set only inside a forked worker
_worker_state = {}

# registered in the PARENT at import so the fault matrix can enumerate it;
# fork inherits the armed environment, so the fault fires in the worker
from ..distributed.chaos import register_fault as _register_fault  # noqa: E402

FP_WORKER_BATCH = _register_fault(
    "io.worker_batch", "DataLoader worker producing one batch")


def get_worker_info():
    """In a DataLoader worker process: that worker's WorkerInfo; in the main
    process: None (reference worker.py:79)."""
    return _worker_state.get("info")


def _worker_loop(dataset, index_queue, data_queue, collate_fn, worker_id, seed,
                 num_workers=0):
    from ..distributed.chaos import faultpoint
    np.random.seed((seed + worker_id) % (2 ** 31))
    _worker_state["info"] = WorkerInfo(worker_id, num_workers,
                                       seed + worker_id, dataset)
    parent = os.getppid()
    while True:
        try:
            item = index_queue.get(timeout=5.0)
        except pyqueue.Empty:
            # a parent that died without teardown re-parents us: exit
            # instead of waiting on a queue nobody will ever feed again
            if os.getppid() != parent:
                return
            continue
        if item is None:
            break
        batch_id, indices = item
        try:
            # chaos site: crash SIGKILLs this worker mid-epoch (the OOM-kill
            # scenario the receiver must detect), delay models a stalled
            # decode, error a poisoned sample
            faultpoint(FP_WORKER_BATCH)
            samples = [dataset[i] for i in indices]
            data = collate_fn(samples)
            data_queue.put((batch_id, data, None))
        except Exception:
            data_queue.put((batch_id, None, traceback.format_exc()))


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2, use_shared_memory=True,
                 timeout=0, worker_init_fn=None, persistent_workers=False):
        self.dataset = dataset
        self.num_workers = int(num_workers)
        self.prefetch_factor = prefetch_factor
        self.collate_fn = collate_fn
        self.device = _resolve_places(places)
        # max seconds to wait for any single batch from the workers
        # (0 = only worker-death detection bounds the wait)
        self.timeout = float(timeout or 0)
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if not self._iterable_mode:
            if batch_sampler is not None:
                self.batch_sampler = batch_sampler
            else:
                self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                                  batch_size=batch_size,
                                                  drop_last=drop_last)
        else:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def __iter__(self):
        if self._iterable_mode:
            return self._iter_iterable()
        if self.num_workers == 0:
            return self._iter_single()
        return self._iter_multiprocess()

    # ---- single process ----
    def _iter_single(self):
        collate = self.collate_fn or default_collate_fn
        for indices in self.batch_sampler:
            yield _to_tensor_tree(collate([self.dataset[i] for i in indices]),
                                  self.device)

    def _iter_iterable(self):
        collate = self.collate_fn or default_collate_fn
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield _to_tensor_tree(collate(batch), self.device)
                batch = []
        if batch and not self.drop_last:
            yield _to_tensor_tree(collate(batch), self.device)

    # ---- multiprocess ----
    def _iter_multiprocess(self):
        import multiprocessing as mp
        ctx = mp.get_context("fork")
        collate = self.collate_fn or _np_collate
        index_queues = []
        data_queue = ctx.Queue()
        workers = []
        seed = np.random.randint(0, 2 ** 31)
        for wid in range(self.num_workers):
            iq = ctx.Queue()
            w = ctx.Process(target=_worker_loop,
                            args=(self.dataset, iq, data_queue, collate, wid,
                                  seed, self.num_workers),
                            daemon=True)
            w.start()
            index_queues.append(iq)
            workers.append(w)

        batches = list(self.batch_sampler)
        n = len(batches)
        depth = max(1, self.num_workers * self.prefetch_factor)
        # A background receiver thread drains the mp queue, restores batch
        # order, and feeds a bounded blocking queue (native C++ ring when
        # built — the LoDTensorBlockingQueue pattern: host decode overlaps
        # the consumer's host->device transfer).
        out_q = _make_blocking_queue(depth)
        state = {"send_idx": 0, "error": None, "stop": False}
        lock = threading.Lock()

        def submit():
            with lock:
                if state["send_idx"] < n and not state["stop"]:
                    i = state["send_idx"]
                    index_queues[i % self.num_workers].put((i, batches[i]))
                    state["send_idx"] += 1
                    return True
            return False

        for _ in range(min(n, depth)):
            submit()

        def receiver():
            buffered = {}
            recv_idx = 0
            last_progress = time.monotonic()
            # round-robin assignment (submit): worker w owns batch ids
            # congruent to w mod num_workers. O(1) owes-accounting: its
            # death is fatal only while it still has undelivered batches
            # (delivered counts cover submitted AND not-yet-submitted ids)
            owed = [len(range(w, n, self.num_workers))
                    for w in range(self.num_workers)]

            def worker_owes_batches(wid):
                return owed[wid] > 0

            try:
                while recv_idx < n and not state["stop"]:
                    while recv_idx not in buffered:
                        try:
                            bid, data, err = data_queue.get(timeout=0.2)
                        except pyqueue.Empty:
                            if state["stop"]:
                                return
                            # liveness poll: a SIGKILLed/OOM-killed worker
                            # can never feed this queue again — spinning on
                            # Empty forever was the hang; name the culprit
                            for wid, w in enumerate(workers):
                                if not w.is_alive() \
                                        and worker_owes_batches(wid):
                                    raise DataLoaderWorkerError(wid,
                                                                w.exitcode)
                            if self.timeout > 0 and time.monotonic() \
                                    - last_progress > self.timeout:
                                raise DataLoaderTimeout(
                                    f"DataLoader batch {recv_idx}",
                                    self.timeout,
                                    detail="workers alive but no batch "
                                           "arrived (stalled dataset?)")
                            continue
                        if err is not None:
                            raise RuntimeError(f"DataLoader worker failed:\n{err}")
                        buffered[bid] = data
                        owed[bid % self.num_workers] -= 1
                        last_progress = time.monotonic()
                        submit()
                    if not out_q.put(buffered.pop(recv_idx)):
                        return  # consumer abandoned the iterator
                    recv_idx += 1
                    last_progress = time.monotonic()
            except BaseException as e:  # surfaced to the consumer below
                state["error"] = e
            finally:
                out_q.close()

        rt = threading.Thread(target=receiver, daemon=True)
        rt.start()
        try:
            for _ in range(n):
                # unbounded by design: the receiver's finally always closes
                # out_q (worker death and timeout included), which turns
                # this get into _CLOSED
                data = out_q.get()
                if data is _CLOSED:
                    break
                yield _to_tensor_tree(data, self.device)
            if state["error"] is not None:
                raise state["error"]
        finally:
            state["stop"] = True
            out_q.close()
            # best-effort sentinels: a full queue (or a dead worker's
            # feeder) must never block teardown — put_nowait, not put
            for iq in index_queues:
                try:
                    iq.put_nowait(None)
                except Exception:
                    pass
            rt.join(timeout=2.0)
            deadline = time.monotonic() + 2.0
            for w in workers:
                w.join(timeout=max(0.1, deadline - time.monotonic()))
            for w in workers:
                if w.is_alive():
                    w.terminate()
                    w.join(timeout=1.0)
            # drain + close the fork-context queues so their feeder threads
            # and semaphores don't leak past the iterator's lifetime
            try:
                while True:
                    data_queue.get_nowait()
            except Exception:  # noqa: BLE001 — Empty, or a terminated
                pass           # worker's torn pickle; teardown never raises
            data_queue.close()
            data_queue.cancel_join_thread()
            for iq in index_queues:
                iq.close()
                iq.cancel_join_thread()
