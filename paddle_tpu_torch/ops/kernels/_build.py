"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``paddle_tpu_torch/csrc/`` have a plain ``extern "C"``
interface; they are compiled on first use, on the machine with the card,
into ``build/paddle_tpu_torch/libpt_kernels.so`` at the repo root: one
nvcc per source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c paddle_tpu_torch/csrc/<name>.cu -o <name>.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/paddle_tpu_torch/libpt_kernels.so *.o

A stamp file beside the library records a hash of the sources and the
headers they include, so an edited source is rebuilt and an unchanged one
is loaded as it is. The stamp check and the build run under an exclusive
``fcntl`` lock on ``libpt_kernels.lock`` beside the library, so processes
that reach the build together (the ranks of a job) build once and the
others load what it left; the kernel drops the lock when a process dies,
so a leftover lock file blocks nothing. Nothing here runs at import time: this module is
imported on machines without nvcc, and only a launch on a CUDA tensor
calls ``library()``.

    python -m paddle_tpu_torch.ops.kernels._build --report

prints, per kernel instance, what ptxas says (registers, spill stores and
loads, and the codes of its performance notes such as C7512 "wgmma
serialized"; ``-Xptxas -v``) and how many HGMMA and WARPGROUP.DEPBAR
instructions its SASS holds (``cuobjdump -sass``): a pipelined wgmma
product shows one DEPBAR per batch of HGMMA, a serialised one one per
HGMMA.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["library", "build", "LIB_PATH", "SOURCES", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[2]          # paddle_tpu_torch/
CSRC = _PKG / "csrc"
LIB_PATH = _PKG.parent / "build" / "paddle_tpu_torch" / "libpt_kernels.so"
SOURCES = ("decode_attention.cu", "flash_attention.cu", "fused_ce.cu",
           "multi_tensor.cu")
HEADERS = ("tma.cuh", "wgmma.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin): the port's CUDA kernels are "
                       "built from source at first use")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> float:
    """Compile the sources into LIB_PATH unless an up-to-date build is
    there. Returns the seconds nvcc took (0.0 when nothing was built).
    Holds the build directory's file lock throughout."""
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(LIB_PATH.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_locked(force)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_locked(force: bool) -> float:
    stamp = LIB_PATH.with_suffix(".sha256")
    digest = _source_hash()
    if not force and LIB_PATH.is_file() and stamp.is_file() \
            and stamp.read_text().strip() == digest:
        return 0.0
    tag = f"{os.getpid()}.tmp"
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{tag}")
    nvcc = _nvcc()
    objs = [LIB_PATH.with_name(f"{Path(s).stem}.{tag}.o") for s in SOURCES]
    t0 = time.perf_counter()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
            for s, o in zip(SOURCES, objs)]
    jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
            for cmd in cmds]
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    try:
        for cmd, proc in jobs:
            out = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"{proc.stderr}")
    except BaseException:
        for _, p in jobs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    took = time.perf_counter() - t0
    os.replace(tmp, LIB_PATH)
    stamp.write_text(digest)
    return took


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.pt_ragged_decode_attention
    fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ctypes.c_float,
                   ci, vp]
    fn.restype = ci
    # B, Sq, Sk, H, Hkv, D, scale, causal, dtype, stream
    shape = [ci, ci, ci, ci, ci, ci, ctypes.c_float, ci, ci, vp]
    lib.pt_flash_attention_fwd.argtypes = [vp] * 5 + shape
    lib.pt_flash_attention_bwd_dq.argtypes = [vp] * 7 + shape
    lib.pt_flash_attention_bwd_dkv.argtypes = [vp] * 8 + shape
    # h, w, labels, offset, ...
    lib.pt_fused_ce_fwd.argtypes = [vp, vp, vp, ci] + [vp] * 4 + [ci] * 5 \
        + [vp]                        # part, m, l, z; N, H, V, splits, dtype
    lib.pt_fused_ce_fwd_splits.argtypes = [vp, vp] + [ci] * 4  # N, H, V, dtype
    lib.pt_fused_ce_bwd_dh.argtypes = [vp, vp, vp, ci] + [vp] * 3 \
        + [ci] * 4 + [vp]             # lse, g, out; N, H, V, dtype
    lib.pt_fused_ce_bwd_dw.argtypes = lib.pt_fused_ce_bwd_dh.argtypes
    pv, pll = ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_longlong)
    lib.pt_multi_tensor_sumsq_workspace.argtypes = [pll, ci]
    lib.pt_multi_tensor_sumsq_workspace.restype = ctypes.c_longlong
    # g, n, dtype, count, inv, sumsq, total, finite, first, work, bytes
    lib.pt_multi_tensor_sumsq_finite.argtypes = [
        pv, pll, ctypes.POINTER(ci), ci, vp, vp, vp, vp, ci, vp,
        ctypes.c_longlong, vp]
    # p, g, m, v, n, count, dtype, 9 scalars, decoupled, inv, clip, finite
    lib.pt_multi_tensor_adam.argtypes = [pv] * 4 + [pll, ci, ci] \
        + [ctypes.c_float] * 9 + [ci, vp, vp, vp, vp]
    for name in ("pt_flash_attention_fwd", "pt_flash_attention_bwd_dq",
                 "pt_flash_attention_bwd_dkv", "pt_fused_ce_fwd",
                 "pt_fused_ce_fwd_splits", "pt_fused_ce_bwd_dh",
                 "pt_fused_ce_bwd_dw", "pt_multi_tensor_sumsq_finite",
                 "pt_multi_tensor_adam"):
        getattr(lib, name).restype = ci


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            _declare(lib)
            _lib = lib
        return _lib


def _tool(name: str) -> str:
    return str(Path(_nvcc()).with_name(name))


def report() -> str:
    """One line per kernel instance of every source: its registers and
    spill bytes (ptxas) and its HGMMA / WARPGROUP.DEPBAR counts (SASS)."""
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for src in SOURCES:
            cubin = Path(tmp) / f"{Path(src).stem}.cubin"
            ptxas = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-cubin",
                 str(CSRC / src), "-o", str(cubin)],
                capture_output=True, text=True, check=True).stderr
            stats, name = {}, None
            for line in ptxas.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    name = m.group(1)
                    stats[name] = {}
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m and name:
                    stats[name]["spills"] = (int(m.group(1)), int(m.group(2)))
                m = re.search(r"Used (\d+) registers", line)
                if m and name:
                    stats[name]["registers"] = int(m.group(1))
                m = re.search(r"\((C\d+)\).*in the function '(\S+)'", line)
                if m:      # e.g. C7512, "wgmma serialized"
                    stats.setdefault(m.group(2), {}).setdefault(
                        "ptxas", []).append(m.group(1))
            sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            for chunk in sass.split("Function : ")[1:]:
                fn = chunk.split(None, 1)[0]
                stats.setdefault(fn, {}).update(
                    hgmma=chunk.count("HGMMA."),
                    depbar=chunk.count("WARPGROUP.DEPBAR"))
            names = subprocess.run([_tool("cu++filt")], input="\n".join(stats),
                                   capture_output=True, text=True).stdout
            for fn, pretty in zip(stats, names.splitlines() or list(stats)):
                st = stats[fn]
                lines.append(f"{src}: {pretty} registers={st.get('registers')} "
                             f"spill_stores/loads={st.get('spills')} "
                             f"HGMMA={st.get('hgmma')} "
                             f"DEPBAR={st.get('depbar')}"
                             + (f" ptxas={','.join(st['ptxas'])}"
                                if st.get("ptxas") else ""))
    return "\n".join(lines)


if __name__ == "__main__":
    if sys.argv[1:] != ["--report"]:
        sys.exit("usage: python -m paddle_tpu_torch.ops.kernels._build "
                 "--report")
    print(report())
