"""Durable checkpoint generations (an orbax-style CheckpointManager).

Counterpart of ``paddle_tpu/distributed/ckpt_manager.py``, with its
directory protocol, so a generation written by either package restores in
the other. ``save_state_dict`` makes every FILE atomic; a checkpoint is a
SET of files, so the manager adds the directory-level protocol:

    root/
      step-40/   shard-*.npz + *.crc32 + metadata.json + manifest.json + COMMIT
      step-50/   ...                                                     COMMIT
      step-60/   shard-0.npz.tmp.1234          <- writer died here: no COMMIT

- each save gets its own generation directory ``step-<N>``; nothing is
  rewritten in place;
- the coordinator records every file's CRC32 and size in
  ``manifest.json``, then writes ``COMMIT`` as the last durable act;
- ``latest()`` walks the generations newest first and skips uncommitted or
  broken ones; ``restore()`` re-verifies the checksums and raises
  ``CheckpointCorruptionError`` rather than load torn data;
- keep-last-K GC runs after the commit and never deletes the newest
  committed generation.

The owner-sharded layout (``save_sharded``: ``stage_shards`` by every
owner, then ``commit_sharded`` by the committer or ``wait_commit``) stages
each owner's bricks and a receipt, and the committer cross-checks the
receipts against the sidecars before it writes metadata, manifest and
COMMIT. Owners meet through the shared file system only.

Rank and world come from ``torch.distributed`` (the JAX module reads
``jax.process_index/count``); the gather layout's barriers run over the
checkpoint's own gloo group (``checkpoint._barrier_group``), made on the
main thread before an async writer starts.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..utils.deadline import (CheckpointTimeout, Deadline, env_timeout,
                              join_bounded)
from . import checkpoint as _ckpt
from .chaos import (FaultDrop, crashpoint, faultpoint,
                    register as _register_crashpoint, register_fault)

CP_GEN_STAGED = _register_crashpoint(
    "ckpt.generation_staged", "all files durable, manifest not written")
CP_MANIFEST = _register_crashpoint(
    "ckpt.manifest_written", "manifest durable, COMMIT not written")
CP_COMMIT = _register_crashpoint(
    "ckpt.commit_written", "generation committed, GC not run")
CP_GC = _register_crashpoint(
    "ckpt.gc_done", "commit + GC complete")

# sharded two-phase commit sites: faultpoints (crash/delay/error/drop),
# rows of the crash matrix
FP_SHARD_STAGED = register_fault(
    "ckpt.shard_staged", "owner bricks durable, receipt not yet written")
FP_RECEIPTS = register_fault(
    "ckpt.receipts", "receipt collection / commit-marker wait")

_GEN_RE = re.compile(r"^step-(\d+)$")
MANIFEST = "manifest.json"
COMMIT = "COMMIT"
_OWNER_RE = re.compile(r"^[A-Za-z0-9_.\-]+$")
RECEIPT_FORMAT = "paddle_tpu.ckpt_receipt.v1"
SHARDED_LAYOUT = "owner-sharded"


def _fault_site(site: str, dl: Deadline, what: str):
    """One chaos-visible blocking edge of the sharded commit: a dropped
    wire is absorbed by retry-once (receipt files are idempotent), a stall
    becomes the typed CheckpointTimeout via the commit Deadline."""
    for attempt in (0, 1):
        try:
            faultpoint(site)
            break
        except FaultDrop:
            if attempt:
                raise
    dl.check(what, exc=CheckpointTimeout)


class CheckpointManager:
    """Generation-directory checkpointing with commit markers and GC."""

    def __init__(self, root: str, keep_last_k: int = 2,
                 coordinator_rank: int = 0):
        if keep_last_k < 1:
            raise ValueError("keep_last_k must be >= 1: the newest committed "
                             "generation is never garbage-collected")
        self.root = root
        self.keep_last_k = keep_last_k
        self.coordinator_rank = coordinator_rank
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)

    # ---- naming ----
    def gen_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step-{int(step)}")

    def _scan(self) -> list[int]:
        steps = []
        try:
            entries = os.listdir(self.root)
        except FileNotFoundError:
            return []
        for name in entries:
            m = _GEN_RE.match(name)
            if m and os.path.isdir(os.path.join(self.root, name)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    # ---- read side ----
    def all_steps(self, committed_only: bool = True) -> list[int]:
        steps = self._scan()
        if committed_only:
            steps = [s for s in steps if self._committed_and_sound(s)]
        return steps

    def _committed_and_sound(self, step: int) -> bool:
        """COMMIT present, manifest parses, and every manifested file exists
        with the recorded size. Cheap (stat-level) — full CRC verification
        happens on restore()."""
        d = self.gen_dir(step)
        if not os.path.exists(os.path.join(d, COMMIT)):
            return False
        try:
            with open(os.path.join(d, MANIFEST)) as f:
                man = json.load(f)
            for fname, rec in man["files"].items():
                st = os.stat(os.path.join(d, fname))
                if st.st_size != rec["size"]:
                    return False
        except (OSError, ValueError, KeyError):
            return False
        return True

    def latest(self) -> Optional[int]:
        """Newest committed, structurally sound generation (None if none).
        Uncommitted directories — a writer died mid-save — are skipped, as
        are committed ones whose files have since gone missing/truncated."""
        for step in reversed(self._scan()):
            if self._committed_and_sound(step):
                return step
        return None

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.gen_dir(step), MANIFEST)) as f:
            return json.load(f)

    def restore(self, state_dict, step: Optional[int] = None) -> int:
        """Fill `state_dict` from generation `step` (default: latest()).
        Shard checksums are re-verified against the save-time sidecars;
        torn bytes raise CheckpointCorruptionError instead of loading."""
        if step is None:
            step = self.latest()
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint generation under {self.root}")
        d = self.gen_dir(step)
        if not os.path.exists(os.path.join(d, COMMIT)):
            raise FileNotFoundError(f"generation step-{step} was never "
                                    f"committed (writer died mid-save?)")
        self._verify_against_manifest(d)
        _ckpt.load_state_dict(state_dict, d)
        return step

    def read_param(self, name: str, step: Optional[int] = None):
        """Assemble ONE parameter (the global array) from a committed
        generation, without deserializing the whole state. Shard files
        are CRC verified; torn bytes raise CheckpointCorruptionError."""
        return self.read_params([name], step=step)[name]

    def read_params(self, names, step: Optional[int] = None) -> dict:
        """Batch form of read_param: ONE CRC-verified pass over the
        generation's shard files serves every requested name (verifying
        per name would make it O(params x shards))."""
        if step is None:
            step = self.latest()
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint generation under {self.root}")
        d = self.gen_dir(step)
        if not os.path.exists(os.path.join(d, COMMIT)):
            raise FileNotFoundError(f"generation step-{step} was never "
                                    f"committed")
        with open(os.path.join(d, "metadata.json")) as f:
            meta = json.load(f)
        missing = [n for n in names if n not in meta["params"]]
        if missing:
            raise KeyError(f"generation step-{step} has no parameter(s) "
                           f"{missing!r}")
        # same guarantees as restore(): the commit-time manifest is the
        # ground truth, so a shard whose sidecar was lost (rsync'd without
        # *.crc32) still gets a full CRC check instead of loading torn
        # bytes
        self._verify_against_manifest(d)
        index = _ckpt._ShardIndex(d)
        try:
            return {n: index.assemble(n, meta["params"][n]) for n in names}
        finally:
            index.close()

    def _verify_against_manifest(self, d: str):
        """The manifest's CRCs are the commit-time ground truth. For files
        whose sidecar survives, checking sidecar == manifest is enough (the
        load path re-verifies bytes against the sidecar); a file whose
        sidecar was lost (rsync'd without *.crc32, object-store sync) gets
        a full streamed CRC here — its corruption must not load silently."""
        with open(os.path.join(d, MANIFEST)) as f:
            man = json.load(f)
        for fname, rec in man["files"].items():
            path = os.path.join(d, fname)
            want = (int(rec["crc32"], 16), int(rec["size"]))
            side = _ckpt._read_sidecar(path)
            if side is not None:
                if side != want:
                    raise _ckpt.CheckpointCorruptionError(
                        f"{path}: sidecar ({side[0]:08x},{side[1]}) disagrees "
                        f"with the committed manifest ({want[0]:08x},"
                        f"{want[1]})")
                continue
            got = _ckpt._crc32_file(path)
            if got != want:
                raise _ckpt.CheckpointCorruptionError(
                    f"{path}: checksum mismatch vs committed manifest (got "
                    f"crc32={got[0]:08x} size={got[1]}, manifest says "
                    f"crc32={want[0]:08x} size={want[1]})")

    # ---- write side ----
    def save(self, state_dict, step: int, user_data: Optional[dict] = None,
             async_save: bool = False):
        """Write generation `step-<step>`: stage every file, manifest it,
        COMMIT it, then GC old generations. With async_save the whole
        protocol runs on a background thread; wait() (or the next save)
        joins it and re-raises any writer failure."""
        self.wait()
        group = _ckpt._barrier_group()
        if async_save:
            def _guarded():
                try:
                    self._save_and_commit(state_dict, step, user_data, group)
                except BaseException as e:  # noqa: BLE001 — re-raised in wait()
                    with self._lock:
                        self._pending_error = e
            t = threading.Thread(target=_guarded, daemon=False)
            with self._lock:
                self._pending = t
            t.start()
        else:
            self._save_and_commit(state_dict, step, user_data, group)

    def wait(self):
        """Join an in-flight async save; re-raise its failure exactly once.
        The join is bounded (PT_CKPT_WAIT_TIMEOUT, default 600s): a writer
        wedged on dead network storage surfaces as a typed DeadlineExceeded
        instead of hanging every subsequent save forever."""
        with self._lock:
            t = self._pending
        if t is not None:
            join_bounded(t, "async checkpoint generation writer")
        with self._lock:
            if self._pending is t:
                self._pending = None
            err, self._pending_error = self._pending_error, None
        if err is not None:
            raise RuntimeError("async checkpoint generation failed") from err

    def _save_and_commit(self, state_dict, step: int,
                         user_data: Optional[dict], group=None):
        d = self.gen_dir(step)
        os.makedirs(d, exist_ok=True)
        # stage: per-file atomicity + sidecars come from the hardened
        # save_state_dict; sync mode so the files are durable before manifest
        _ckpt.save_state_dict(state_dict, d,
                              coordinator_rank=self.coordinator_rank)
        crashpoint(CP_GEN_STAGED)
        proc, _ = _ckpt._rank_world()
        _ckpt._host_barrier(group)
        if proc == self.coordinator_rank:
            self._write_manifest(d, step, user_data)
            crashpoint(CP_MANIFEST)
            # the COMMIT marker is the LAST durable act: its atomic rename
            # is the single instant the generation starts to exist
            _ckpt._atomic_write(os.path.join(d, COMMIT),
                                f"{int(step)}\n".encode())
            crashpoint(CP_COMMIT)
            self._gc()
            crashpoint(CP_GC)
        # readers on any rank may rely on the commit being visible once
        # their own save() returned
        _ckpt._host_barrier(group)

    def _write_manifest(self, d: str, step: int, user_data: Optional[dict],
                        layout: Optional[str] = None):
        files = {}
        for name in sorted(os.listdir(d)):
            if name in (MANIFEST, COMMIT) or name.endswith(".crc32") \
                    or ".tmp." in name:
                continue
            path = os.path.join(d, name)
            side = _ckpt._read_sidecar(path)
            if side is not None:
                crc, size = side
                if os.stat(path).st_size != size:
                    raise _ckpt.CheckpointCorruptionError(
                        f"{path}: size disagrees with its sidecar — refusing "
                        f"to commit a torn generation")
            else:
                crc, size = _ckpt._crc32_file(path)
            files[name] = {"crc32": f"{crc:08x}", "size": size}
        man = {"format": "paddle_tpu.ckpt_gen.v1", "step": int(step),
               "files": files, "user_data": user_data or {}}
        if layout is not None:
            man["layout"] = layout
        _ckpt._atomic_write(os.path.join(d, MANIFEST),
                            json.dumps(man, indent=1, sort_keys=True).encode())

    # ---- sharded write side (two-phase: stage -> receipts -> marker) ----

    def _receipt_path(self, d: str, owner: str) -> str:
        return os.path.join(d, f"receipt-{owner}.json")

    def _shard_path(self, d: str, owner: str) -> str:
        return os.path.join(d, f"shard-{owner}.npz")

    @staticmethod
    def _check_owner(owner: str):
        if not _OWNER_RE.match(owner):
            raise ValueError(f"owner id {owner!r} is not filesystem-safe")

    def stage_shards(self, step: int, owner: str,
                     shards: Dict[str, np.ndarray],
                     budget: Optional[float] = None) -> dict:
        """Phase 1, run by EVERY owner: write this owner's bricks as one
        slice-keyed shard file (key `name|lo:hi,...` or `name|full`, the
        same convention the gather layout's reader assembles) plus its CRC
        sidecar, then the owner's receipt. The receipt's atomic rename is
        the owner's stage-complete instant: a death before it leaves an
        attempt the committer never counts. Returns per-owner commit
        accounting ({"bytes", "wall_s"})."""
        self._check_owner(owner)
        t0 = time.monotonic()
        dl = Deadline(budget if budget is not None
                      else env_timeout("PT_CKPT_COMMIT_TIMEOUT", 600.0),
                      f"sharded stage of step-{step} by {owner}")
        d = self.gen_dir(step)
        os.makedirs(d, exist_ok=True)
        # a stale receipt from a dead earlier attempt of this same step
        # must never vouch for the NEW bytes — drop it before staging
        for stale in (self._receipt_path(d, owner),):
            try:
                os.unlink(stale)
            except FileNotFoundError:
                pass
        path = self._shard_path(d, owner)
        crc, size = _ckpt._atomic_write_npz(
            path, {k: _ckpt._to_numpy(v) if hasattr(v, "detach")
                   else np.asarray(v) for k, v in shards.items()})
        _ckpt._write_sidecar(path, crc, size)
        _fault_site(FP_SHARD_STAGED, dl,
                    f"sharded stage of step-{step} by {owner}")
        receipt = {"format": RECEIPT_FORMAT, "owner": owner,
                   "step": int(step),
                   "files": {os.path.basename(path):
                             {"crc32": f"{crc:08x}", "size": size}},
                   "keys": sorted(shards)}
        _ckpt._atomic_write(self._receipt_path(d, owner),
                            json.dumps(receipt, indent=1,
                                       sort_keys=True).encode())
        return {"bytes": size, "wall_s": time.monotonic() - t0}

    def _read_receipt(self, d: str, owner: str) -> dict:
        path = self._receipt_path(d, owner)
        try:
            with open(path, encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError) as e:
            raise _ckpt.CheckpointCorruptionError(
                f"{path}: unreadable receipt — refusing to commit") from e
        if rec.get("format") != RECEIPT_FORMAT or rec.get("owner") != owner:
            raise _ckpt.CheckpointCorruptionError(
                f"{path}: receipt does not identify owner {owner!r} "
                f"(format={rec.get('format')!r}, owner={rec.get('owner')!r})")
        for fname, want in rec.get("files", {}).items():
            fpath = os.path.join(d, fname)
            side = _ckpt._read_sidecar(fpath)
            got = side if side is not None else (
                _ckpt._crc32_file(fpath) if os.path.exists(fpath) else None)
            if got != (int(want["crc32"], 16), int(want["size"])):
                raise _ckpt.CheckpointCorruptionError(
                    f"{fpath}: staged bytes disagree with {owner}'s receipt "
                    f"(receipt says crc32={want['crc32']} "
                    f"size={want['size']}, file has {got}) — a torn or "
                    f"replayed stage must not commit")
        return rec

    def commit_sharded(self, step: int, owners: List[str],
                       param_meta: Dict[str, dict],
                       user_data: Optional[dict] = None,
                       budget: Optional[float] = None,
                       abort: Optional[Callable[[], bool]] = None):
        """Phase 2, run by the single committer: wait (bounded) for every
        owner's receipt over the shared checkpoint filesystem, cross-check
        each against the staged sidecars, then write metadata + the
        unified manifest + the atomic COMMIT marker. `abort` lets the
        caller stop waiting early (an owner died, the roster changed)
        without burning the whole budget — the attempt stays uncommitted
        and GC reaps it after the next successful commit."""
        for o in owners:
            self._check_owner(o)
        dl = Deadline(budget if budget is not None
                      else env_timeout("PT_CKPT_COMMIT_TIMEOUT", 600.0),
                      f"receipt collection for step-{step}")
        d = self.gen_dir(step)
        while True:
            missing = [o for o in owners
                       if not os.path.exists(self._receipt_path(d, o))]
            if not missing:
                break
            _fault_site(FP_RECEIPTS, dl,
                        f"receipt collection for step-{step} "
                        f"(missing {missing})")
            if abort is not None and abort():
                raise CheckpointTimeout(
                    f"receipt collection for step-{step}",
                    timeout=dl.timeout,
                    detail=f"aborted: still missing receipts from {missing}")
            dl.sleep(0.01)
        receipts = {o: self._read_receipt(d, o) for o in owners}
        keys = set()
        for rec in receipts.values():
            keys.update(rec.get("keys", ()))
        self._check_key_coverage(step, keys, param_meta)
        # files from owners outside this commit (a dead earlier attempt)
        # must not ride into the manifest: the generation is exactly what
        # the collected receipts vouch for
        expected = {MANIFEST, COMMIT, "metadata.json"}
        for o, rec in receipts.items():
            expected.add(os.path.basename(self._receipt_path(d, o)))
            expected.update(rec.get("files", ()))
        for name in os.listdir(d):
            if name.endswith(".crc32") or ".tmp." in name:
                continue
            if name not in expected:
                for p in (os.path.join(d, name),
                          os.path.join(d, name) + ".crc32"):
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
        params = {n: {"shape": list(rec.get("shape", ())),
                      "dtype": str(rec.get("dtype", "float32")),
                      "spec": list(rec.get("spec") or [])}
                  for n, rec in param_meta.items()}
        meta = {"format": "paddle_tpu.dist_ckpt.v1", "params": params}
        _ckpt._atomic_write(os.path.join(d, "metadata.json"),
                            json.dumps(meta, indent=1,
                                       sort_keys=True).encode())
        crashpoint(CP_GEN_STAGED)
        self._write_manifest(d, step, user_data, layout=SHARDED_LAYOUT)
        crashpoint(CP_MANIFEST)
        _ckpt._atomic_write(os.path.join(d, COMMIT),
                            f"{int(step)}\n".encode())
        crashpoint(CP_COMMIT)
        self._gc()
        crashpoint(CP_GC)

    @staticmethod
    def _check_key_coverage(step: int, keys, param_meta: Dict[str, dict]):
        """Every parameter must be fully covered by the staged bricks
        (volume check over the distinct slice keys — owners stage disjoint
        bricks). An under-covered commit would only fail at restore time,
        long after the writers are gone."""
        vol: Dict[str, int] = {n: 0 for n in param_meta}
        full = set()
        for key in keys:
            name, _, idx = key.rpartition("|")
            if name not in vol:
                continue
            if idx == "full":
                full.add(name)
                continue
            v = 1
            for part in [p for p in idx.split(",") if p]:
                lo, hi = part.split(":")
                v *= max(0, int(hi) - int(lo))
            vol[name] += v
        for n, rec in param_meta.items():
            total = 1
            for dim in rec.get("shape", ()):  # scalars: empty shape -> 1
                total *= int(dim)
            if n in full or vol[n] >= total:
                continue
            raise _ckpt.CheckpointCorruptionError(
                f"step-{step}: parameter {n!r} is under-covered by the "
                f"staged bricks ({vol[n]}/{total} elements) — refusing to "
                f"commit a generation that cannot restore")

    def wait_commit(self, step: int, budget: Optional[float] = None,
                    abort: Optional[Callable[[], bool]] = None):
        """Non-committer's bounded wait for the COMMIT marker: save()
        returning implies the generation is visible, same as the gather
        layout's commit barrier."""
        dl = Deadline(budget if budget is not None
                      else env_timeout("PT_CKPT_COMMIT_TIMEOUT", 600.0),
                      f"COMMIT wait for step-{step}")
        path = os.path.join(self.gen_dir(step), COMMIT)
        while not os.path.exists(path):
            _fault_site(FP_RECEIPTS, dl, f"COMMIT wait for step-{step}")
            if abort is not None and abort():
                raise CheckpointTimeout(
                    f"COMMIT wait for step-{step}", timeout=dl.timeout,
                    detail="aborted: committer is gone")
            dl.sleep(0.01)

    def save_sharded(self, step: int, owner: str, owners: List[str],
                     shards: Dict[str, np.ndarray],
                     param_meta: Dict[str, dict],
                     user_data: Optional[dict] = None,
                     budget: Optional[float] = None,
                     abort: Optional[Callable[[], bool]] = None,
                     committer: Optional[str] = None) -> dict:
        """One owner's whole sharded commit: stage this owner's bricks,
        then either collect receipts + commit (the committer — by default
        the lowest owner id) or wait for the marker. Every participant
        calls this with the SAME owners list; the per-owner staging stats
        come back for commit accounting."""
        self.wait()
        stats = self.stage_shards(step, owner, shards, budget=budget)
        if committer is None:
            committer = sorted(owners)[0]
        if owner == committer:
            self.commit_sharded(step, owners, param_meta,
                                user_data=user_data, budget=budget,
                                abort=abort)
        else:
            self.wait_commit(step, budget=budget, abort=abort)
        return stats

    # ---- gc ----
    def _gc(self):
        committed = [s for s in self._scan() if self._committed_and_sound(s)]
        if not committed:
            return
        newest = committed[-1]
        doomed = committed[:-self.keep_last_k] if \
            len(committed) > self.keep_last_k else []
        for s in self._scan():
            if s in doomed and s != newest:
                shutil.rmtree(self.gen_dir(s), ignore_errors=True)
            elif s < newest and not self._committed_and_sound(s):
                # a dead writer's uncommitted leftovers; anything newer than
                # the newest commit might be an IN-FLIGHT save and is spared
                shutil.rmtree(self.gen_dir(s), ignore_errors=True)
