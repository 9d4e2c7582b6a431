"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface under ``build/repro_torch_kernels/`` at the repository
root (listed in ``.gitignore``).  The file name carries a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused.  The libraries do not include PyTorch's headers, which keeps a
build to seconds; the wrappers pass every pointer and the stream as
``c_void_p`` and each C entry returns ``cudaGetLastError()``.
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
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("countsketch_scatter", "countsketch_query", "countsketch_update",
           "ppswor_transform", "segment_sum")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}


class Built(NamedTuple):
    name: str
    path: Path
    log: str        # nvcc/ptxas output: registers, shared memory, spills
    seconds: float  # compile time; 0.0 when an earlier build was reused


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is absent."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built on the machine with the card")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cuh", ".h") or f.name == f"{name}.cu":
            h.update(f.name.encode() + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every named source that has no current library, all nvcc
    processes started together.  Returns ``{name: Built}``; raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, done = {}, {}
    for name in names:
        path = _lib_path(name)
        log_path = path.with_suffix(".log")
        if path.exists():
            log = log_path.read_text() if log_path.exists() else ""
            done[name] = Built(name, path, log, 0.0)
            continue
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, path, tmp, time.perf_counter())
    failures = []
    for name, (proc, path, tmp, t0) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, path)
        path.with_suffix(".log").write_text(out)
        done[name] = Built(name, path, out, time.perf_counter() - t0)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return done


def function(name: str, symbol: str, argtypes: list):
    """The C entry ``symbol`` of library ``name`` (built on first use), with
    ``argtypes`` set and an int return code."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all((name,))[name].path))
            _loaded[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def kernel_info(name: str, variant: int, threads: int,
                smem_bytes: int = 0) -> dict:
    """Registers a thread, static shared memory, resident blocks per SM and
    dynamic shared memory limit of kernel ``variant`` of source ``name``
    at ``threads`` threads and ``smem_bytes`` of dynamic shared memory
    (``worp_<name>_info``, through the CUDA occupancy calculator)."""
    fn = function(name, f"worp_{name}_info",
                  [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = (ctypes.c_int * 4)()
    err = fn(variant, threads, smem_bytes, ctypes.addressof(out))
    if err:
        raise RuntimeError(f"{name} kernel info failed: CUDA error {err}")
    return dict(zip(("registers", "static_smem", "blocks_per_sm",
                     "max_dynamic_smem"), out))
