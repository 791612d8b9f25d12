"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C entry point and is compiled at
first use into a shared library under `cobs_tpu_torch/_build/` (listed in
`.gitignore`), named by a hash of its source and flags so an edited
source is rebuilt. The library links the CUDA runtime statically and
shares the device's primary context with PyTorch, so tensor pointers and
PyTorch's stream can be passed straight in. Nothing here runs at import:
the CPU-only test machine has no nvcc and never calls `load`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
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


def load(name: str) -> ctypes.CDLL:
    """The ctypes library built from `csrc/<name>.cu`, compiled first if
    this source has no build yet. Raises RuntimeError if nvcc fails."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {src.name}:\n"
                               f"{build_logs[name]}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    lib = ctypes.CDLL(str(so))
    _libs[name] = lib
    return lib
