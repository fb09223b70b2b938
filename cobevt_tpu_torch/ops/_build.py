"""Build and load the hand-written CUDA kernels of ``cobevt_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` (with the shared ``csrc/*.cuh`` headers: ``mma.cuh``,
``rowops.cuh``, ``flash.cuh``, ``swap_state.cuh`` and ``hopper.cuh``, the
TMA / ``wgmma`` building blocks) exposes
plain C functions and compiles with ``nvcc`` for Hopper (``sm_90a``) into
``cobevt_tpu_torch/_build/`` the first time a kernel is launched; the
shared library is then loaded with ``ctypes``.  No PyTorch headers and no
ninja are involved, so a build takes seconds.  Nothing is linked beyond the
CUDA runtime: the TMA tensor-map encoder, a libcuda function, is reached at
run time through ``cudaGetDriverEntryPoint`` (``hopper.cuh``).  The library name carries a
hash of the sources and the flags, so a changed source is rebuilt and a
stale library is never loaded.

Nothing here runs when the module is imported: CPU-only hosts import every
module of the package and never call :func:`load`.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# the CUDA toolkit's default install prefix, tried after CUDA_HOME and PATH
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"


@dataclasses.dataclass(frozen=True)
class Build:
    path: str
    seconds: float    # 0.0 when the library was already built
    log: str          # nvcc's output, including ptxas' register report


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), _DEFAULT_NVCC]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless a library of the same sources and
    flags exists.  Raises with nvcc's output when the compile fails."""
    src = source_path(name)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    log_path = lib + ".log"
    if os.path.exists(lib):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return Build(lib, 0.0, log)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, lib)
    return Build(lib, seconds, log)


def build_all(names) -> dict:
    """:func:`build` of every name, one nvcc process each, all started
    together.  Returns {name: Build}; raises on the first failure."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, compiled on first use."""
    return ctypes.CDLL(build(name).path)


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
