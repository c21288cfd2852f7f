"""The kernel library's calling convention on the Python side.

Every ``ops/*_cuda.py`` wrapper validates its arguments, allocates its
scratch and calls the library (``_build.py::load_library``) through this
module: the ``rng`` index the kernels take (``csrc/counter_rng.cuh``), the
checks of the arguments they share, the float64 ``partials`` and ``out``
pair of a kernel that sums per-block partials, the launch counters, and
the two ways to launch.  ``call_kernel`` passes a one-shot argument list.
``BoundLaunch`` binds K1's or K2's static arguments, buffers and entry
point once, so that each later call converts only its parameters and
epoch; a wrapper called without one binds a fresh launch.  This module
imports no wrapper and no pricer.
"""

from __future__ import annotations

import torch

from .._build import load_library
from ..utils.timing import span
from .fe import DEVICE_NOT_TPU, LANES

_MAX_N = 1 << 30
# the kernels' `rng` argument is the index (csrc/counter_rng.cuh)
RNGS = ("philox", "threefry4", "threefry", "device")
COUNTER_RNGS = ("philox", "threefry4")     # K2, K4 (and K3 with "device")


def check_u32(name: str, x) -> int:
    x = int(x)
    if not 0 <= x <= 0xFFFFFFFF:
        raise ValueError(f"{name}={x} is not a uint32")
    return x


def check_rng(rng: str, kernel: str, allowed=COUNTER_RNGS) -> None:
    """Refuse a generator the kernel does not take."""
    if rng == "tpu":
        raise ValueError(DEVICE_NOT_TPU)
    if rng not in allowed:
        names = [repr(r) for r in allowed]
        raise ValueError(f"rng={rng!r}: the {kernel} kernel takes "
                         f"{', '.join(names[:-1])} or {names[-1]}")


def check_device(device) -> torch.device:
    """``device`` as a torch device; raise unless it is a cpu or cuda
    one."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device {device} is neither cpu nor cuda")
    return device


def check_sizes(N, n_paths, device):
    """Validate a wrapper's device and sizes; returns (device, N, n_paths)
    with the integers as Python ints."""
    device = check_device(device)
    N, n_paths = int(N), int(n_paths)
    if not 1 <= N <= _MAX_N:
        raise ValueError(f"N={N} must be in [1, 2^30]")
    if n_paths <= 0 or n_paths % LANES or n_paths > 1 << 32:
        raise ValueError(f"n_paths={n_paths} must be a positive multiple "
                         f"of {LANES}, at most 2^32")
    return device, N, n_paths


def check_params(params) -> None:
    """Raise unless ``params`` is a float32 tensor of shape (8,) on the
    CPU."""
    if not isinstance(params, torch.Tensor) or params.dtype != torch.float32 \
            or params.shape != (8,) or params.device.type != "cpu":
        raise ValueError("params must be a float32 tensor of shape (8,) on "
                         "the CPU")


def check_args(params, seed_words, epoch, base_path, N, n_paths, device):
    """Validate the arguments of a kernel wrapper; returns (device, N,
    n_paths, k0, k1, epoch, base_path), the integers as Python ints."""
    device, N, n_paths = check_sizes(N, n_paths, device)
    check_params(params)
    k0, k1 = (check_u32("seed word", w) for w in seed_words)
    return (device, N, n_paths, k0, k1, check_u32("epoch", epoch),
            check_u32("base_path", base_path))


def count_launch(fn, name: str) -> None:
    """Add one to a wrapper's ``launches`` and ``variant_launches[name]``."""
    fn.launches += 1
    fn.variant_launches[name] = fn.variant_launches.get(name, 0) + 1


def device_key(device) -> tuple:
    """(type, index) of the device a wrapper called with ``device`` runs
    on now: a CUDA device that names no index is the current one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return device.type, torch.cuda.current_device()
    return device.type, device.index


def scratch(device, n_partials: int, out_shape):
    """A kernel's float64 per-block ``partials`` (n_partials,) and its
    ``out`` of ``out_shape``, both on ``device``."""
    return (torch.empty(n_partials, dtype=torch.float64, device=device),
            torch.empty(out_shape, dtype=torch.float64, device=device))


def pinned_like(t: torch.Tensor) -> torch.Tensor:
    """A pinned host buffer of ``t``'s shape and dtype."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _on_current_stream(fn, index: int, args):
    """``fn(*args, stream)`` on the current stream of CUDA device
    ``index``; returns (its return code, that stream).  The device guard is
    entered only where ``index`` is not the current device."""
    if torch.cuda.current_device() == index:
        stream = torch.cuda.current_stream(index)
        return fn(*args, stream.cuda_stream), stream
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index)
        return fn(*args, stream.cuda_stream), stream


def _raise_on_error(rc: int, name: str) -> None:
    if rc != 0:
        lib, _ = load_library()
        msg = lib.nmch_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def call_kernel(entry: str, name: str, device, *args) -> None:
    """Call the kernel library's C entry point ``entry`` with ``args`` and
    the device's current stream; raise if it returns a CUDA error.  Span
    ``prepare.enqueue``: the library lookup, the stream and the call."""
    with span("prepare.enqueue"):
        lib, _ = load_library()
        rc, _ = _on_current_stream(getattr(lib, entry),
                                   device_key(device)[1], args)
    _raise_on_error(rc, name)


class BoundLaunch:
    """One kernel launch of K1 or K2, bound once and reused by every call
    whose static arguments are those it was bound for.

    A wrapper given a pricer's launch (``fe_moments_cuda(..., launch=)``,
    ``em_moments_cuda(..., launch=)``) compares the call's static
    arguments, as passed, with ``key`` (one tuple comparison) and binds
    anew where they differ: the seed words, base_path, N, n_paths, the
    device and the kernel variant.  A wrapper given none binds a fresh
    launch for the one call.  Binding keeps the library's entry point, the
    device's index, the variant's name, the converted arguments, the
    ``partials`` and ``out`` buffers on the card and the kernel's further
    outputs (``after``); ``binds`` counts the bindings.  Each call then
    passes only what it brings (the parameters or their loop constants,
    and the epoch) to ``enqueue``, and ``fetch`` brings ``out`` to the
    host in one copy into a pinned buffer, made at the first fetch, and
    one wait.  The buffers are reused from call to call: each call waits
    for its launch before the next one is queued (``NMCH.compute``), or
    queues its launches in one stream's order."""

    def __init__(self):
        self.key = None
        self.binds = 0
        self.release()

    def bind(self, key, entry: str, name: str, device, head, tail,
             n_partials: int, n_out: int, after=()) -> None:
        """Bind the library's ``entry`` on ``device`` (a validated CUDA
        device) for the static arguments ``key``: a call passes its lead
        arguments, then ``head``, the epoch, ``tail``, the partials' and
        out's pointers, the pointers of the tensors ``after`` (None for
        an output not asked for) and the stream."""
        self.release()
        self.index = device_key(device)[1]
        self.partials, self.out = scratch(torch.device("cuda", self.index),
                                          n_partials, n_out)
        lib, _ = load_library()
        self.fn = getattr(lib, entry)
        self.name = name
        self.after = tuple(after)
        self.head = tuple(head)
        self.tail = (*tail, self.partials.data_ptr(), self.out.data_ptr(),
                     *(None if t is None else t.data_ptr() for t in after))
        self.key = key
        self.binds += 1

    def enqueue(self, lead, epoch: int) -> None:
        """Queue the launch for this call's ``lead`` arguments and
        ``epoch`` on the device's current stream (span
        ``prepare.enqueue``); raise if the library returns a CUDA
        error."""
        with span("prepare.enqueue"):
            rc, self.stream = _on_current_stream(
                self.fn, self.index, (*lead, *self.head, epoch, *self.tail))
        _raise_on_error(rc, self.name)

    def fetch(self) -> list[float]:
        """``out`` of the last launch as Python floats: one asynchronous
        copy into the pinned buffer on the launch's stream, and one wait
        for that stream."""
        if self.host is None:
            self.host = pinned_like(self.out)
            self._host = self.host.numpy()
        self.host.copy_(self.out, non_blocking=True)
        self.stream.synchronize()
        return self._host.tolist()

    def release(self) -> None:
        """Drop the buffers and the key: the next call binds anew."""
        self.key = None
        self.fn = self.stream = None
        self.partials = self.out = self.host = self._host = None
        self.after = ()
