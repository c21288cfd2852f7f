"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources in ``csrc/`` are compiled at first use into
``build/nmch_tpu_torch/<hash>/libnmch_tpu_torch.so`` beside the package,
where ``<hash>`` covers the sources and the flags, so an edit rebuilds
and an unchanged tree reuses the library.  The library has a plain C
interface (no PyTorch headers), which keeps the build to seconds.

``-fmad=false`` keeps nvcc from contracting a*b+c into one rounding:
every float operation then matches the plain PyTorch version's.  A
failed build raises with nvcc's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

_PKG = pathlib.Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "fe_philox.cu",)
BUILD_ROOT = _PKG.parent / "build" / "nmch_tpu_torch"
LIB_NAME = "libnmch_tpu_torch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: pathlib.Path
    seconds: float   # time spent compiling in this process (0 if reused)
    log: str         # nvcc's output, ptxas register/spill lines included


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, on PATH "
                       "and in /usr/local/cuda/bin): the CUDA kernels "
                       "cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> BuildInfo:
    """Compile the kernels unless a library of the same sources exists."""
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return BuildInfo(lib, 0.0, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent build sees all or none
    return BuildInfo(lib, seconds, proc.stdout + proc.stderr)


@functools.cache
def load_library() -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (if needed) and load the kernel library once per process."""
    info = build_library()
    lib = ctypes.CDLL(str(info.path))
    lib.nmch_fe_philox_moments.argtypes = (
        [ctypes.c_float] * 8
        + [ctypes.c_uint32] * 4
        + [ctypes.c_int64, ctypes.c_int64]
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    lib.nmch_fe_philox_moments.restype = ctypes.c_int
    lib.nmch_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nmch_cuda_error_string.restype = ctypes.c_char_p
    return lib, info
