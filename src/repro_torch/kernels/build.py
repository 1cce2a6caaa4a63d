"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point, so it compiles in
seconds without PyTorch's headers.  The first call to ``library`` builds
every source that has no up-to-date library yet, one ``nvcc`` process
per source, all started together, into ``_build/`` beside this file
(named by a hash of the sources and flags, so an edit rebuilds).
Nothing is built when the package is imported: the CPU tests import
every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")
SOURCES = ("decode_attention", "flash_attention", "paged_decode_attention",
           "paged_verify_attention", "verify_attention", "linear_scan",
           "int8_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# name -> (build seconds, nvcc output incl. ptxas register/spill report)
build_log: dict[str, tuple[float, str]] = {}


def nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin/ on PATH")
    return found


def _library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cuh"))) + [
            os.path.join(CSRC, f"{name}.cu")]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all() -> dict[str, tuple[float, str]]:
    """Compile every kernel source that lacks a current library; the
    ``nvcc`` processes run in parallel.  Returns ``build_log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in SOURCES:
        so = _library_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        jobs.append((name, so, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, so, tmp, t0, proc in jobs:
        out, _ = proc.communicate()
        build_log[name] = (time.perf_counter() - t0, out)
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return build_log


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on first
    use, together with every other source)."""
    with _lock:
        if name not in _libs:
            so = _library_path(name)
            if not os.path.exists(so):
                build_all()
            _libs[name] = ctypes.CDLL(so)
        return _libs[name]


DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(t) -> int:
    """The C entry points' dtype code for a tensor's dtype."""
    name = str(t.dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero return of a C entry point."""
    if err == -1:
        raise ValueError(f"{what}: shape or dtype not instantiated")
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
