"""Build the port's CUDA sources at first use and load them with ctypes.

Each library is compiled by nvcc for ``sm_90a`` from ``csrc/`` into a plain
C-ABI shared object under ``build/kernels/`` at the root of the checkout.
The file name carries a hash of the sources, of every header under
``csrc/`` (which the sources include) and of the flags, so an edited source
or header rebuilds and an unchanged one loads what is already there. Nothing
here runs at import time, so the module imports on a host without nvcc
(the CPU tests).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> nvcc's output for the last build in this process (ptxas prints
# each kernel's registers, shared memory and spills there)
BUILD_LOGS: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}
# one lock per library, so different libraries build in parallel threads
_locks: Dict[str, threading.Lock] = collections.defaultdict(threading.Lock)
_locks_guard = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the port's CUDA "
            "kernels are built from csrc/ at first use and need the CUDA "
            "toolkit")
    return nvcc


def _library_path(name: str, sources: Sequence[str],
                  csrc: Path = CSRC_DIR) -> Path:
    """The library's file under BUILD_DIR, named by a hash of the flags,
    the sources and every header under `csrc` (only the sources go to
    nvcc)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in csrc.iterdir()
                     if p.suffix in (".cuh", ".h"))
    for src in (*sources, *headers):
        digest.update(src.encode())
        digest.update((csrc / src).read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


# the element types every kernel of the port takes, in the order of
# csrc/elem.cuh's codes (0, 1, 2)
KERNEL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
DTYPE_CODES = {dtype: code for code, dtype in enumerate(KERNEL_DTYPES)}


def dtype_code(dtype: torch.dtype) -> int:
    """The csrc/elem.cuh code of a torch dtype (bf16, fp16 or fp32)."""
    return DTYPE_CODES[dtype]


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """The shared library `name` built from `sources` (paths under csrc/)."""
    with _locks_guard:
        lock = _locks[name]
    with lock:
        if name in _libs:
            return _libs[name]
        so = _library_path(name, sources)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *(str(CSRC_DIR / s) for s in sources)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            BUILD_LOGS[name] = res.stdout + res.stderr
            if res.returncode:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed ({res.returncode}) building "
                                   f"{name}:\n{BUILD_LOGS[name]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib
