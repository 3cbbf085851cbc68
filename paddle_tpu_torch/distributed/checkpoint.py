"""Distributed (sharded, mesh-aware) checkpointing.

Counterpart of ``paddle_tpu/distributed/checkpoint.py``, with its on-disk
format (``paddle_tpu.dist_ckpt.v1``), so a checkpoint written by either
package restores in the other:

    path/shard-<rank>.npz     this rank's pieces, keyed "name|start:stop,..."
                              (the global slice), or "name|full"
    path/shard-<rank>.npz.crc32   "<crc32 hex> <size>" sidecar
    path/metadata.json        {"format", "params": {name: {"shape", "dtype",
                              "spec"[, "scalar"]}}}, written last

Every file is written atomically (tmp + fsync + rename + directory
fsync); five named crash sites cover the dangerous windows of the save.

**Which rank writes what.** A leaf is a torch tensor (this rank's piece
of a global array), a numpy array or a Python number. A tensor tells the
save its global shape and its piece through ``dist_layout``
(``set_layout(t, shape, spec, mesh)``: the JAX-style spec names the mesh
axes each global dim is split over, and the piece is this rank's block of
them); a tensor with none is whole (with ``split_axis``, the mp layers'
tag, it is this rank's block of that dim over the mesh's mp axis). A
tensor that ZeRO stage 3 released between steps is saved from, and
loaded into, its slice (``zero_master``, with its own layout). Each rank
writes each piece it holds once, and a piece that other ranks hold too is
written by the rank whose coordinate is 0 on every mesh axis that
replicates it (JAX: ``replica_id == 0`` over ``addressable_shards``).
Numpy and number leaves are written by the coordinator.

**Load** assembles this rank's piece of each leaf's global array from the
saved pieces that overlap it and copies it into the leaf, in place: a
mesh other than the one saved re-slices on load.

**bfloat16 without ml_dtypes.** ``np.savez`` of a bfloat16 array writes
2-byte void records (``V2``) while ``metadata.json`` says ``"bfloat16"``.
The port writes bfloat16 leaves as those same records and reads
``"bfloat16"`` as a ``torch.bfloat16`` view of the bytes, never through
``np.dtype("bfloat16")``.

**The barrier.** Every rank's shard must be durable before the
coordinator writes ``metadata.json``. The barrier may run on the async
writer thread, so it never shares a process group with the training
collectives (which run on the main thread and could interleave in other
orders on other ranks): it is a gloo group of its own over every rank,
made on the main thread at the first save.
"""
from __future__ import annotations

import io
import json
import os
import threading
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .chaos import crashpoint, register as _register_crashpoint

__all__ = ["save_state_dict", "load_state_dict", "wait",
           "reshard_checkpoint", "CheckpointCorruptionError", "DistLayout",
           "set_layout", "shard_bricks"]

FORMAT = "paddle_tpu.dist_ckpt.v1"


class CheckpointCorruptionError(RuntimeError):
    """Bytes on disk do not match the checksum recorded at save time: a
    shard whose CRC32 disagrees with its sidecar (or the generation
    manifest) was half written, bit-flipped or overwritten."""


CP_SHARD_TMP = _register_crashpoint(
    "ckpt.shard_tmp_written", "shard staged+fsynced under tmp name, not renamed")
CP_SHARD_FINAL = _register_crashpoint(
    "ckpt.shard_renamed", "shard at final name, checksum sidecar not written")
CP_SIDECAR = _register_crashpoint(
    "ckpt.sidecar_written", "shard + sidecar durable, metadata not written")
CP_META_TMP = _register_crashpoint(
    "ckpt.metadata_tmp_written", "metadata staged under tmp name, not renamed")
CP_META_FINAL = _register_crashpoint(
    "ckpt.metadata_written", "metadata durable (flat-dir checkpoint complete)")


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: str, data: bytes, crash_after_tmp: Optional[str] = None):
    """tmp + fsync + rename + directory fsync: ``path`` holds the whole of
    ``data`` or its previous content. Returns the CRC32 of ``data``."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    if crash_after_tmp is not None:
        crashpoint(crash_after_tmp)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))
    return zlib.crc32(data) & 0xFFFFFFFF


def _sidecar_path(shard_path: str) -> str:
    return shard_path + ".crc32"


def _write_sidecar(shard_path: str, crc: int, size: int):
    _atomic_write(_sidecar_path(shard_path), f"{crc:08x} {size}\n".encode())


def _crc32_file(path: str, chunk: int = 1 << 20) -> tuple[int, int]:
    """(crc32, size) of a file, streamed."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
            size += len(buf)
    return crc & 0xFFFFFFFF, size


def _read_sidecar(path: str) -> Optional[tuple[int, int]]:
    """``path``'s checksum sidecar as (crc32, size), None if absent; a
    garbled sidecar is corruption too."""
    sc = _sidecar_path(path)
    if not os.path.exists(sc):
        return None
    try:
        with open(sc) as f:
            parts = f.read().split()
        return int(parts[0], 16), int(parts[1])
    except (OSError, ValueError, IndexError) as e:
        raise CheckpointCorruptionError(
            f"{sc}: unreadable checksum sidecar ({e}) — cannot verify "
            f"{path}") from e


def _verify_file(path: str):
    """Check a file against its sidecar (none: nothing to check)."""
    want = _read_sidecar(path)
    if want is None:
        return
    got = _crc32_file(path)
    if got != want:
        raise CheckpointCorruptionError(
            f"{path}: checksum mismatch (got crc32={got[0]:08x} "
            f"size={got[1]}, sidecar says crc32={want[0]:08x} "
            f"size={want[1]}) — torn or corrupted shard")


# ---------------------------------------------------------------------------
# the async writer and the barrier
# ---------------------------------------------------------------------------

class _AsyncWriter:
    """The in-flight writer thread, the error it hit and the barrier
    group, under one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._group = None
        self._group_world = None

    def group(self):
        """The checkpoint barrier's own gloo group over every rank (made on
        the first call, which every rank makes at the same point on its
        main thread), or None in a world of one."""
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() <= 1:
            return None
        with self._lock:
            world = (id(dist.group.WORLD), dist.get_world_size())
            if self._group is None or self._group_world != world:
                self._group = dist.new_group(backend="gloo")
                self._group_world = world
            return self._group

    def thread(self) -> Optional[threading.Thread]:
        with self._lock:
            return self._thread

    def launch(self, target) -> None:
        t = threading.Thread(target=target, daemon=False)
        with self._lock:
            self._thread = t
        t.start()

    def record_error(self, e: BaseException) -> None:
        with self._lock:
            self._error = e

    def finish(self, t: Optional[threading.Thread]) -> Optional[BaseException]:
        with self._lock:
            if self._thread is t:
                self._thread = None
            err, self._error = self._error, None
            return err


_writer = _AsyncWriter()


def _barrier_group():
    """The barrier's group; call on the main thread before a writer
    thread may need it."""
    return _writer.group()


def _host_barrier(group) -> None:
    """Every rank reaches this point (over the checkpoint's own gloo
    group; nothing with one rank)."""
    if group is not None:
        dist.barrier(group=group)


def _rank_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def wait():
    """Join an in-flight async save (bounded by PT_CKPT_WAIT_TIMEOUT,
    default 600 s); re-raise what the writer hit, once."""
    from ..utils.deadline import join_bounded
    t = _writer.thread()
    if t is not None:
        join_bounded(t, "async checkpoint writer")
    err = _writer.finish(t)
    if err is not None:
        raise RuntimeError("async checkpoint save failed") from err


# ---------------------------------------------------------------------------
# leaves and their layouts
# ---------------------------------------------------------------------------

class DistLayout(NamedTuple):
    """A tensor's place in its global array: the global ``shape``, this
    rank's ``index`` ((start, stop) per global dim) and the JAX-style
    ``spec`` (the mesh axes each dim is split over, or None)."""
    shape: tuple
    index: tuple
    spec: tuple


def _spec_axes(s) -> tuple:
    if s is None:
        return ()
    return (s,) if isinstance(s, str) else tuple(s)


def shard_index(shape, spec, mesh=None) -> tuple:
    """This rank's block of each global dim under ``spec`` on ``mesh``."""
    from ..parallel import mesh as mesh_mod
    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    out = []
    for i, g in enumerate(shape):
        axes = _spec_axes(spec[i] if i < len(spec) else None)
        n, r = 1, 0
        for a in axes:
            size = mesh_mod.mesh_axis_size(a, mesh)
            n, r = n * size, r * size + mesh_mod.axis_index(a, mesh)
        m = int(g) // n
        out.append((r * m, (r + 1) * m))
    return tuple(out)


def set_layout(t: torch.Tensor, shape, spec, mesh=None) -> torch.Tensor:
    """Tag ``t`` as this rank's piece of a global array of ``shape`` split
    as ``spec`` over ``mesh`` (default: the installed one)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    t.dist_layout = DistLayout(tuple(int(s) for s in shape),
                               shard_index(shape, spec, mesh), spec)
    return t


def _master(t):
    """The tensor a leaf's values live in: ZeRO stage 3's slice for a
    parameter it shards."""
    m = getattr(t, "zero_master", None)
    return t if m is None else m


def layout_of(t: torch.Tensor) -> DistLayout:
    lay = getattr(t, "dist_layout", None)
    if lay is not None:
        return lay
    split = getattr(t, "split_axis", None)
    if split is not None:
        from ..parallel import mesh as mesh_mod
        shape = list(t.shape)
        shape[split] *= mesh_mod.mesh_axis_size("mp")
        spec = [None] * t.dim()
        spec[split] = "mp"
        return DistLayout(tuple(shape), shard_index(shape, spec), tuple(spec))
    return DistLayout(tuple(t.shape), tuple((0, s) for s in t.shape),
                      (None,) * t.dim())


def _writes(lay: DistLayout) -> bool:
    """Whether this rank writes its piece: coordinate 0 on every mesh axis
    that replicates it (rank 0 of a world without a mesh)."""
    from ..parallel import mesh as mesh_mod
    mesh = mesh_mod.get_mesh()
    rank, world = _rank_world()
    if mesh is None or mesh.size != world:
        return rank == 0
    split = {a for s in lay.spec for a in _spec_axes(s)}
    return all(c == 0 for a, c in mesh.coords.items() if a not in split)


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=t.dtype).numpy().dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor's bytes as numpy (never a view of a live CPU
    tensor: an async save writes it later); bfloat16 as 2-byte void
    records."""
    t = t.detach()
    t = t.contiguous().cpu() if t.device.type != "cpu" \
        else t.clone(memory_format=torch.contiguous_format)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _np_dtype(name: str) -> np.dtype:
    return np.dtype("V2") if name == "bfloat16" else np.dtype(name)


def _to_torch(a: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _is_leaf(v):
    return isinstance(v, torch.Tensor) or hasattr(v, "shape")


def _walk(tree, prefix=""):
    if _is_leaf(tree):
        yield prefix.rstrip("."), tree
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}.")
    elif tree is not None:
        yield prefix.rstrip("."), tree


def _set_in(tree, name, value):
    """Set ``name`` (a dot-joined ``_walk`` path) in ``tree``; dict keys
    may hold dots, so the longest matching key wins."""
    parts = name.split(".")
    cur = tree
    i = 0
    while i < len(parts):
        if isinstance(cur, dict):
            for j in range(len(parts), i, -1):
                k = ".".join(parts[i:j])
                if k in cur:
                    if j == len(parts):
                        cur[k] = value
                        return
                    cur = cur[k]
                    i = j
                    break
            else:
                raise KeyError(f"{name!r}: no key matching "
                               f"{'.'.join(parts[i:])!r} in {list(cur)[:8]}")
        else:
            k = int(parts[i])
            if i == len(parts) - 1:
                cur[k] = value
                return
            cur = cur[k]
            i += 1


def _index_key(index, shape) -> str:
    """A piece's global slice as 'start:stop,start:stop,...' ("full" for
    a 0-dim array)."""
    parts = [f"{a}:{b}" for a, b in index]
    return ",".join(parts) if parts else "full"


def shard_bricks(state_dict, coordinator_rank: int = 0):
    """``(bricks, params)``: the pieces this rank writes of every leaf of
    ``state_dict``, keyed ``name|start:stop,...`` (or ``name|full``), and
    every leaf's metadata entry. What ``save_state_dict`` writes to this
    rank's file, and what ``CheckpointManager.save_sharded`` takes."""
    rank, _ = _rank_world()
    params, bricks = {}, {}
    for name, t in _walk(state_dict):
        if isinstance(t, torch.Tensor):
            t = _master(t)
            lay = layout_of(t)
            params[name] = {"shape": list(lay.shape), "dtype": _dtype_name(t),
                            "spec": [list(s) if isinstance(s, tuple) else s
                                     for s in lay.spec]}
            if _writes(lay):
                piece = tuple(b - a for a, b in lay.index)
                bricks[f"{name}|{_index_key(lay.index, lay.shape)}"] = \
                    _to_numpy(t).reshape(piece)
            continue
        scalar = None
        val = t
        if not hasattr(val, "shape"):
            if isinstance(val, bool) or not isinstance(
                    val, (int, float, np.integer, np.floating)):
                continue
            scalar = "int" if isinstance(val, (int, np.integer)) else "float"
            val = np.asarray(val)
        params[name] = {"shape": list(np.shape(val)),
                        "dtype": str(np.dtype(val.dtype)), "spec": []}
        if scalar is not None:
            params[name]["scalar"] = scalar
        if rank == coordinator_rank:
            bricks[f"{name}|full"] = np.asarray(val)
    return bricks, params


def save_state_dict(state_dict, path, process_group=None, coordinator_rank=0,
                    async_save: bool = False):
    """Write a sharded checkpoint directory: ``shard-<rank>.npz`` with the
    pieces this rank writes, its sidecar, and (after every rank's shard is
    durable) the coordinator's ``metadata.json``. Every rank calls it.
    With ``async_save`` the files are written on a background thread;
    ``wait()`` (or the next save or load) joins it."""
    wait()
    os.makedirs(path, exist_ok=True)
    rank, world = _rank_world()
    group = _barrier_group()
    if rank == coordinator_rank:
        # a previous save under a larger world may have left higher shard
        # indices; only those can be stale
        import glob as _glob
        import re as _re
        for old in _glob.glob(os.path.join(path, "shard-*.npz")):
            m = _re.search(r"shard-(\d+)\.npz$", old)
            if m and int(m.group(1)) >= world:
                os.remove(old)
                if os.path.exists(_sidecar_path(old)):
                    os.remove(_sidecar_path(old))
    bricks, params = shard_bricks(state_dict, coordinator_rank)
    meta = {"format": FORMAT, "params": params}

    def _write():
        shard_path = os.path.join(path, f"shard-{rank}.npz")
        buf = io.BytesIO()
        np.savez(buf, **bricks)
        data = buf.getvalue()
        crc = _atomic_write(shard_path, data, crash_after_tmp=CP_SHARD_TMP)
        crashpoint(CP_SHARD_FINAL)
        _write_sidecar(shard_path, crc, len(data))
        crashpoint(CP_SIDECAR)
        _host_barrier(group)
        if rank == coordinator_rank:
            _atomic_write(os.path.join(path, "metadata.json"),
                          json.dumps(meta).encode(),
                          crash_after_tmp=CP_META_TMP)
            crashpoint(CP_META_FINAL)

    if async_save:
        def _write_guarded():
            try:
                _write()
            except BaseException as e:  # noqa: BLE001 — re-raised in wait()
                _writer.record_error(e)
        _writer.launch(_write_guarded)
    else:
        _write()


class _ShardIndex:
    """Index over a checkpoint's npz files: name -> [(file, key)]."""

    def __init__(self, path, verify: bool = True):
        import glob
        self._files = []
        for p in sorted(glob.glob(os.path.join(path, "shard-*.npz"))):
            if verify:
                _verify_file(p)
            self._files.append(np.load(p))
        if not self._files:
            raise FileNotFoundError(f"no shard files under {path}")
        self._by_name = {}
        for f in self._files:
            for key in f.files:
                name = key.rsplit("|", 1)[0]
                self._by_name.setdefault(name, []).append((f, key))

    def assemble(self, name, meta_p, index=None) -> np.ndarray:
        """The global array of ``name``, or its block ``index`` ((start,
        stop) per dim), read from the pieces that overlap it only
        (bfloat16 as ``V2`` records)."""
        shape = tuple(meta_p["shape"])
        dtype = _np_dtype(meta_p["dtype"])
        index = tuple((0, s) for s in shape) if index is None \
            else tuple(index)
        want = tuple(slice(a, b) for a, b in index)
        entries = self._by_name.get(name)
        if not entries:
            raise KeyError(f"checkpoint missing parameter {name!r}")
        for f, key in entries:
            if key.endswith("|full"):
                return np.asarray(f[key], dtype=dtype).reshape(shape)[want]
        block = tuple(b - a for a, b in index)
        out = np.zeros(block, dtype=dtype)
        covered = np.zeros(block, dtype=bool)
        for f, key in entries:
            idx = key.rsplit("|", 1)[1]
            have = [tuple(map(int, p.split(":"))) for p in idx.split(",")]
            lo = [max(a, c) for (a, _), (c, _) in zip(have, index)]
            hi = [min(b, d) for (_, b), (_, d) in zip(have, index)]
            if any(h <= low for low, h in zip(lo, hi)):
                continue
            src = tuple(slice(low - a, h - a)
                        for low, h, (a, _) in zip(lo, hi, have))
            dst = tuple(slice(low - c, h - c)
                        for low, h, (c, _) in zip(lo, hi, index))
            out[dst] = f[key][src]
            covered[dst] = True
        if not covered.all():
            missing = covered.size - int(covered.sum())
            raise RuntimeError(
                f"checkpoint for {name!r} is incomplete: {missing}/"
                f"{covered.size} elements uncovered (lost shard file?)")
        return out

    def close(self):
        for f in self._files:
            f.close()


def _load_leaf(t: torch.Tensor, index: "_ShardIndex", name: str,
               meta_p: dict) -> None:
    """Copy this rank's piece of ``name``'s global array into ``t`` in
    place, reading only the saved pieces that overlap it."""
    t = _master(t)
    lay = layout_of(t)
    if tuple(meta_p["shape"]) != tuple(lay.shape):
        raise ValueError(f"{name}: checkpoint shape {meta_p['shape']} != "
                         f"global shape {list(lay.shape)} of the leaf")
    piece = index.assemble(name, meta_p, lay.index)
    src = _to_torch(piece, meta_p["dtype"]).reshape(t.shape)
    with torch.no_grad():
        t.copy_(src.to(device=t.device, dtype=t.dtype))


def load_state_dict(state_dict, path, process_group=None, coordinator_rank=0):
    """Fill ``state_dict``'s leaves from a checkpoint directory: each
    tensor in place with its piece under its CURRENT layout (the mesh may
    differ from save time), numpy and number leaves by replacement."""
    wait()
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    index = _ShardIndex(path)
    try:
        for name, t in _walk(state_dict):
            if name not in meta["params"]:
                continue
            mp = meta["params"][name]
            if isinstance(t, torch.Tensor):
                _load_leaf(t, index, name, mp)
                continue
            full = index.assemble(name, mp)
            sc = mp.get("scalar")
            if sc == "int":
                full = int(full)
            elif sc == "float":
                full = float(full)
            _set_in(state_dict, name, full)
    finally:
        index.close()
    return state_dict


def reshard_checkpoint(src_path, dst_path, new_specs=None):
    """Offline re-partition: rewrite a sharded checkpoint as one
    consolidated shard (``name|full``), usable under any mesh; optionally
    with new specs in its metadata."""
    with open(os.path.join(src_path, "metadata.json")) as f:
        meta = json.load(f)
    index = _ShardIndex(src_path)
    os.makedirs(dst_path, exist_ok=True)
    out = {}
    try:
        for name, meta_p in meta["params"].items():
            out[f"{name}|full"] = index.assemble(name, meta_p)
            if new_specs and name in new_specs:
                meta["params"][name]["spec"] = new_specs[name]
    finally:
        index.close()
    buf = io.BytesIO()
    np.savez(buf, **out)
    data = buf.getvalue()
    dst_shard = os.path.join(dst_path, "shard-0.npz")
    crc = _atomic_write(dst_shard, data)
    _write_sidecar(dst_shard, crc, len(data))
    _atomic_write(os.path.join(dst_path, "metadata.json"),
                  json.dumps(meta).encode())
