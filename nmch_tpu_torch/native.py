"""ctypes bindings to the native C++ runtime library (native/).

The port's copy of ``nmch_tpu/native.py``, bound to the same library
(``native/Makefile``, ``native/nmch_native.cpp``): an independent
cross-validation (another language, another RNG family, other quadrature
code) of the Python oracle and the Monte Carlo engines.  The library is
optional: every entry point falls back to the port's ``oracle/`` and
``results.py``, or returns None, without it.

``load()`` builds it on first use, never at import: ``make -C native
BUILD=<temporary directory under native/build/>``, then the library is
renamed into ``native/build/libnmch_native.so`` under an ``fcntl`` lock,
so that processes building side by side never see a half-written file.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_LIB_NAME = "libnmch_native.so"
_LIB_PATH = os.path.join(_BUILD_DIR, _LIB_NAME)

_lock = threading.Lock()
_lib = None
_tried = False


def _build(force: bool = False) -> bool:
    """Build the library into a temporary directory and rename it into
    place, holding the lock file; True on success, or if another process
    built it while this one waited for the lock (unless ``force``)."""
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not force and os.path.exists(_LIB_PATH):
                return True
            tmp = tempfile.mkdtemp(prefix="tmp-", dir=_BUILD_DIR)
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR, f"BUILD={tmp}"],
                               check=True, capture_output=True, timeout=300)
                os.replace(os.path.join(tmp, _LIB_NAME), _LIB_PATH)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _bind(lib):
    """Declare signatures; raises AttributeError on a stale library
    that predates a symbol."""
    D = ctypes.c_double
    lib.nmch_heston_call.restype = D
    lib.nmch_heston_call.argtypes = [D] * 10 + [ctypes.c_int]
    lib.nmch_norm_cdf_as.restype = D
    lib.nmch_norm_cdf_as.argtypes = [D]
    lib.nmch_reference_true_price.restype = D
    lib.nmch_reference_true_price.argtypes = [D] * 4
    lib.nmch_reference_err.restype = D
    lib.nmch_reference_err.argtypes = [D, D, ctypes.c_longlong]
    lib.nmch_cpu_fe_moments.restype = None
    lib.nmch_cpu_fe_moments.argtypes = (
        [D] * 9 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_uint64,
                   ctypes.POINTER(D)])
    lib.nmch_cpu_em_moments.restype = None
    lib.nmch_cpu_em_moments.argtypes = (
        [D] * 9 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_uint64,
                   ctypes.c_int, ctypes.POINTER(D)])


def load():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            _bind(lib)
        except OSError:
            return None
        except AttributeError:
            # a library built before a symbol was added: rebuild it for
            # the next process (dlopen keeps the loaded image, so a retry
            # here would bind the stale one again) and fall back for this
            # one
            _build(force=True)
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def heston_call(params, K: float | None = None, u_max: float = 200.0,
                n_nodes: int = 2000) -> float:
    """Native semi-analytic Heston call; falls back to the Python oracle."""
    lib = load()
    K = params.K if K is None else K
    if lib is None:
        from .oracle.heston import heston_call as py_oracle
        return py_oracle(params, K, u_max=u_max, n_nodes=n_nodes)
    return lib.nmch_heston_call(params.T, params.S_0, params.v_0, params.r,
                                params.k, params.rho, params.theta,
                                params.sigma, K, u_max, n_nodes)


def cpu_fe_moments(params, N: int, n_paths: int, seed: int = 1234):
    """Independent CPU Monte Carlo (E[X], E[X^2]); None if lib missing."""
    lib = load()
    if lib is None:
        return None
    out = (ctypes.c_double * 2)()
    lib.nmch_cpu_fe_moments(params.T, params.S_0, params.v_0, params.r,
                            params.k, params.rho, params.theta, params.sigma,
                            params.K, N, n_paths, seed, out)
    return float(out[0]), float(out[1])


def cpu_em_moments(params, N: int, n_paths: int, seed: int = 1234,
                   conditional: bool = False):
    """Independent CPU Broadie-Kaya exact-method Monte Carlo
    (E[X], E[X^2]) using libstdc++'s own poisson/gamma samplers; it
    cross-validates the EM engines.  None if lib missing."""
    lib = load()
    if lib is None:
        return None
    out = (ctypes.c_double * 2)()
    lib.nmch_cpu_em_moments(params.T, params.S_0, params.v_0, params.r,
                            params.k, params.rho, params.theta,
                            params.sigma, params.K, N, n_paths, seed,
                            1 if conditional else 0, out)
    return float(out[0]), float(out[1])


def reference_err_native(mean: float, mean_sq: float, n: int) -> float:
    lib = load()
    if lib is None:
        from .results import reference_err
        return reference_err(mean, mean_sq, n)
    return lib.nmch_reference_err(mean, mean_sq, n)
