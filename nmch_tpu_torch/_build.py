"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources in ``csrc/`` are compiled at first use into
``build/nmch_tpu_torch/<hash>/libnmch_tpu_torch.so`` beside the package,
where ``<hash>`` covers the sources, their headers and the flags, so an
edit rebuilds and an unchanged tree reuses the library.  Each source is
compiled by its own nvcc process, all started together, and the objects
are linked into one library.  The library has a plain C interface (no
PyTorch headers), which keeps the build to seconds.

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
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "fe.cu", CSRC / "fe_device.cu", CSRC / "em.cu",
           CSRC / "sweep.cu", CSRC / "fe_stateful.cu", CSRC / "qmc.cu",
           CSRC / "reduction.cu", CSRC / "qmc_fused.cu",
           CSRC / "chain_probe.cu", CSRC / "fe_greeks.cu",
           CSRC / "em_lrm.cu")
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
BUILD_ROOT = _PKG.parent / "build" / "nmch_tpu_torch"
LIB_NAME = "libnmch_tpu_torch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    for src in SOURCES + HEADERS:
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
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(outs)
        for cmd, p, out in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}): "
                                   f"{' '.join(cmd)}\n{out}")
        so = os.path.join(tmp, LIB_NAME)
        cmd = [nvcc, "-shared", "-o", so, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(so, lib)   # atomic: a concurrent build sees all or none
    return BuildInfo(lib, time.perf_counter() - t0, log)


@functools.cache
def load_library() -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (if needed) and load the kernel library once per process."""
    info = build_library()
    lib = ctypes.CDLL(str(info.path))
    lib.nmch_fe_moments.argtypes = (
        [ctypes.c_float] * 8
        + [ctypes.c_uint32] * 4
        + [ctypes.c_int64, ctypes.c_int64] + [ctypes.c_int] * 4
        + [ctypes.c_void_p] * 3)
    lib.nmch_fe_moments.restype = ctypes.c_int
    lib.nmch_em_moments.argtypes = (
        [ctypes.POINTER(ctypes.c_float)]
        + [ctypes.c_uint32] * 4
        + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 5)
    lib.nmch_em_moments.restype = ctypes.c_int
    lib.nmch_em_schedule.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_void_p]
    lib.nmch_em_schedule.restype = ctypes.c_int
    sweep_head = [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_uint32] * 3 \
        + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    lib.nmch_fe_sweep_moments.argtypes = sweep_head + [ctypes.c_void_p] * 3
    lib.nmch_fe_sweep_moments.restype = ctypes.c_int
    lib.nmch_em_sweep_moments.argtypes = (
        sweep_head[:1] + [ctypes.c_void_p] + sweep_head[1:] + [ctypes.c_int]
        + [ctypes.c_void_p] * 5)
    lib.nmch_em_sweep_moments.restype = ctypes.c_int
    lib.nmch_fe_stateful_moments.argtypes = (
        [ctypes.c_float] * 8 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        + [ctypes.c_void_p] * 5)
    lib.nmch_fe_stateful_moments.restype = ctypes.c_int
    lib.nmch_stateful_init.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_uint32] * 7
        + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p])
    lib.nmch_stateful_init.restype = ctypes.c_int
    lib.nmch_stateful_advance.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int64]
        + [ctypes.c_void_p] * 3)
    lib.nmch_stateful_advance.restype = ctypes.c_int
    lib.nmch_qmc_payoff_sums.argtypes = (
        [ctypes.c_float] * 8 + [ctypes.c_void_p] * 2
        + [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 3)
    lib.nmch_qmc_payoff_sums.restype = ctypes.c_int
    lib.nmch_red_sum.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 3)
    lib.nmch_red_sum.restype = ctypes.c_int
    lib.nmch_qmc_fused_sums.argtypes = (
        [ctypes.c_float] * 8 + [ctypes.c_void_p] * 4
        + [ctypes.c_int64] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
        + [ctypes.c_int64] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
        + [ctypes.c_void_p])
    lib.nmch_qmc_fused_sums.restype = ctypes.c_int
    lib.nmch_chain.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int64] + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.nmch_chain.restype = ctypes.c_int
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.nmch_em_law.argtypes = (
        [f32p] + [ctypes.c_uint32] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_int]
        + [ctypes.c_void_p] * 4)
    lib.nmch_em_law.restype = ctypes.c_int
    lib.nmch_fe_greeks.argtypes = (
        [f32p] * 2 + [ctypes.c_uint32] * 4 + [ctypes.c_int64] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4)
    lib.nmch_fe_greeks.restype = ctypes.c_int
    lib.nmch_em_lrm.argtypes = (
        [f32p] * 2 + [ctypes.c_uint32] * 4 + [ctypes.c_int64] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int64]
        + [ctypes.c_void_p] * 2)
    lib.nmch_em_lrm.restype = ctypes.c_int
    lib.nmch_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nmch_cuda_error_string.restype = ctypes.c_char_p
    return lib, info
