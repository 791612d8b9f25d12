"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C entry point and is compiled at
first use into a shared library under `cobs_tpu_torch/_build/` (listed in
`.gitignore`), named by a hash of its source, the headers beside it and
the flags, so an edited source or header is rebuilt. `load` and `build`
also take another source directory (an experiment's own kernels). The
library links the CUDA runtime statically and shares the device's
primary context with PyTorch, so tensor pointers and PyTorch's stream can
be passed straight in. Nothing here runs at import: the CPU-only test
machine has no nvcc and never calls `load` or `build`.
"""

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

#: every CUDA source of the port (csrc/<name>.cu)
SOURCES = ("gather_count", "device_hash", "dma_gather",
           "construct_scatter")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[tuple[str, Path], ctypes.CDLL] = {}
#: one lock per library path: threads of one process that reach a kernel
#: first together (the construction's page workers) build it once; the
#: temporary file is per process, so processes do not collide either
_path_locks: dict[Path, threading.Lock] = {}
_path_locks_guard = threading.Lock()
#: nvcc's output (with -Xptxas -v: registers, shared memory and spills
#: per kernel) of each library built by this process
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of cobs_tpu_torch are built from source at first "
                       "use")


def _so_path(name: str, csrc: Path = _CSRC) -> Path:
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _path_lock(path: Path) -> threading.Lock:
    with _path_locks_guard:
        return _path_locks.setdefault(path, threading.Lock())


def _compile(name: str, csrc: Path = _CSRC) -> float:
    """Compile `<csrc>/<name>.cu` unless its build exists; returns the
    seconds nvcc took (0.0 when nothing was built). Thread-safe."""
    so = _so_path(name, csrc)
    with _path_lock(so):
        if so.exists():
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(csrc / f"{name}.cu")],
                              capture_output=True, text=True)
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {name}.cu:\n"
                               f"{build_logs[name]}")
        os.replace(tmp, so)  # atomic: another process sees all or none
        return time.perf_counter() - t0


def build(names=SOURCES, csrc: Path = _CSRC) -> dict[str, float]:
    """Compile the named sources that have no build yet, one nvcc process
    each, all started together. Returns each source's nvcc seconds;
    raises RuntimeError if any build fails."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {n: pool.submit(_compile, n, csrc) for n in names}
    return {n: f.result() for n, f in futures.items()}


def load(name: str, csrc: Path = _CSRC) -> ctypes.CDLL:
    """The ctypes library built from `<csrc>/<name>.cu`, compiled first if
    this source has no build yet. Raises RuntimeError if nvcc fails."""
    lib = _libs.get((name, csrc))
    if lib is None:
        _compile(name, csrc)
        lib = ctypes.CDLL(str(_so_path(name, csrc)))
        _libs[name, csrc] = lib
    return lib
