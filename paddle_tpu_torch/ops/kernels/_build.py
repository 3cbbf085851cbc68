"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``paddle_tpu_torch/csrc/`` have a plain ``extern "C"``
interface; they are compiled on first use, on the machine with the card,
into ``build/paddle_tpu_torch/libpt_kernels.so`` at the repo root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/paddle_tpu_torch/libpt_kernels.so \\
         paddle_tpu_torch/csrc/decode_attention.cu \\
         paddle_tpu_torch/csrc/flash_attention.cu

A stamp file beside the library records a hash of the sources, so an
edited source is rebuilt and an unchanged one is loaded as it is. Nothing
here runs at import time: this module is imported on machines without
nvcc, and only a launch on a CUDA tensor calls ``library()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["library", "build", "LIB_PATH", "SOURCES", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[2]          # paddle_tpu_torch/
CSRC = _PKG / "csrc"
LIB_PATH = _PKG.parent / "build" / "paddle_tpu_torch" / "libpt_kernels.so"
SOURCES = ("decode_attention.cu", "flash_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

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
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> float:
    """Compile the sources into LIB_PATH unless an up-to-date build is
    there. Returns the seconds nvcc took (0.0 when nothing was built)."""
    stamp = LIB_PATH.with_suffix(".sha256")
    digest = _source_hash()
    if not force and LIB_PATH.is_file() and stamp.is_file() \
            and stamp.read_text().strip() == digest:
        return 0.0
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    took = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
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
    for name in ("pt_flash_attention_fwd", "pt_flash_attention_bwd_dq",
                 "pt_flash_attention_bwd_dkv"):
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
