"""FE moments through the hand-written CUDA kernel ``csrc/fe.cu``.

The counterpart of ``nmch_tpu/ops/fe_pallas.py::fe_moments_pallas`` in
every variant it takes: rng philox, threefry, threefry4, and the card's
own device stream in place of the TPU's hardware generator; rot 1, 2, 4,
8 (``antithetic`` is rot 2); box hc or turns, and with the device stream
also the packed hc16/hc16f and ``fast_sqrt``.  On a CUDA device the
wrapper launches the kernel (one thread per path group, then one block
that sums the per-block partials) or raises; on the CPU it runs the
plain version, ``ops/fe.py::fe_moments_kernel_plain``, which computes the
same payoffs operation for operation.  Parameters and streams are runtime
arguments, so a parameter sweep never rebuilds the kernel.
``fe_moments_pallas``'s TPU tuning knobs (``tile_rows``, ``unroll``,
``interpret``) are not taken.

A pricer passes its ``BoundLaunch`` (``launch=``): the launch's static
arguments, buffers and entry point are then validated, allocated and
looked up once, and each call converts only its parameters and epoch.
``call_kernel`` is the launch every other wrapper uses.
"""

from __future__ import annotations

import torch

from .._build import load_library
from ..utils.timing import span
from .fe import BOXES, DEVICE_NOT_TPU, LANES, fe_moments_kernel_plain

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


def resolve_rot(rot, antithetic: bool) -> int:
    """rot from ``rot`` and ``antithetic`` as nmch_tpu resolves them: None
    is 2 if antithetic else 1; antithetic with rot=1 is refused."""
    if rot is None:
        rot = 2 if antithetic else 1
    elif antithetic and rot == 1:
        raise ValueError("antithetic=True contradicts rot=1 (antithetic IS "
                         "rot=2; pass one of them)")
    if rot not in (1, 2, 4, 8):
        raise ValueError(f"rot must be 1, 2, 4 or 8, got {rot}")
    return rot


def check_variant(rng: str, rot, antithetic: bool, box: str,
                  fast_sqrt: bool) -> int:
    """``fe_moments_pallas``'s checks of a K1 variant, with "device" where
    nmch_tpu says "tpu"; returns the resolved rot."""
    rot = resolve_rot(rot, antithetic)
    if rng == "tpu":
        raise ValueError(DEVICE_NOT_TPU)
    if rng not in RNGS:
        raise ValueError(f"unknown rng {rng!r} (expected 'philox', "
                         f"'threefry', 'threefry4' or 'device')")
    if box not in BOXES:
        raise ValueError(f"unknown box {box!r} (expected one of {BOXES})")
    if box in ("hc16", "hc16f") and rng != "device":
        raise ValueError(f"box={box!r} (packed 16-bit phases) only applies "
                         f"to rng='device': the counter-based engines keep "
                         f"the 4-word consumption contract (bitwise "
                         f"golden==kernel parity)")
    if fast_sqrt and rng != "device":
        raise ValueError("fast_sqrt=True (v * rsqrt(v)) only applies to "
                         "rng='device': rsqrt is not correctly rounded, so "
                         "the reproducible engines keep IEEE sqrt")
    return rot


def variant_name(rng: str, rot: int = 1, box: str = "hc",
                 fast_sqrt: bool = False) -> str:
    """The name under which a K1 variant is counted and reported, e.g.
    fe_philox (rot 1, box hc), fe_philox_rot4,
    fe_device_hc16f_fastsqrt_rot4."""
    return (f"fe_{rng}" + ("" if box == "hc" else f"_{box}")
            + ("_fastsqrt" if fast_sqrt else "")
            + (f"_rot{rot}" if rot > 1 else ""))


def check_sizes(N, n_paths, device):
    """Validate a wrapper's device and sizes; returns (device, N, n_paths)
    with the integers as Python ints."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device {device} is neither cpu nor cuda")
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


def device_key(device) -> tuple:
    """(type, index) of the device a wrapper called with ``device`` runs
    on now: a CUDA device that names no index is the current one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return device.type, torch.cuda.current_device()
    return device.type, device.index


def call_kernel(entry: str, name: str, device, *args) -> None:
    """Call the kernel library's C entry point ``entry`` with ``args`` and
    the device's current stream; raise if it returns a CUDA error.  Span
    ``prepare.enqueue``: the library lookup, the stream and the call."""
    with span("prepare.enqueue"):
        lib, _ = load_library()
        rc, _ = _on_current_stream(getattr(lib, entry),
                                   device_key(device)[1], args)
    _raise_on_error(rc, name)


def launch_buffers(n_partials: int, n_out: int, index: int):
    """A bound launch's buffers: float64 ``partials`` and ``out`` on CUDA
    device ``index``, and a pinned host buffer for ``out``."""
    device = torch.device("cuda", index)
    return (torch.empty(n_partials, dtype=torch.float64, device=device),
            torch.empty(n_out, dtype=torch.float64, device=device),
            torch.empty(n_out, dtype=torch.float64, pin_memory=True))


class BoundLaunch:
    """One pricer's kernel launch, bound once and reused by every call
    whose static arguments are those it was bound for.

    A wrapper given the launch (``fe_moments_cuda(..., launch=)``,
    ``em_moments_cuda(..., launch=)``) compares the call's static
    arguments, as passed, with ``key`` (one tuple comparison) and binds
    anew where they differ: the seed words, base_path, N, n_paths, the
    device and the kernel variant.  Binding validates them and keeps the
    library's entry point, the device's index, the variant's name, the
    converted arguments, the ``partials`` and ``out`` buffers on the card
    and a pinned host buffer for ``out``; ``binds`` counts the bindings.
    Each call then passes only what it brings (the parameters or their
    loop constants, and the epoch) to ``enqueue``, and ``fetch`` brings
    ``out`` to the host in one copy and one wait.  The buffers are reused
    from call to call: each call waits for its launch before the next one
    is queued (``NMCH.compute``), or queues its launches in one stream's
    order."""

    def __init__(self):
        self.key = None
        self.binds = 0
        self.release()

    def bind(self, key, entry: str, name: str, device, head, tail,
             n_partials: int, n_out: int, after=()) -> None:
        """Bind the library's ``entry`` on ``device`` (a validated CUDA
        device) for the static arguments ``key``: a call passes its lead
        arguments, then ``head``, the epoch, ``tail``, the partials' and
        out's pointers, ``after`` and the stream."""
        self.release()
        lib, _ = load_library()
        self.fn = getattr(lib, entry)
        self.name = name
        self.index = device_key(device)[1]
        self.partials, self.out, self.host = launch_buffers(
            n_partials, n_out, self.index)
        self._host = self.host.numpy()
        self.head = tuple(head)
        self.tail = (*tail, self.partials.data_ptr(), self.out.data_ptr(),
                     *after)
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
        self.host.copy_(self.out, non_blocking=True)
        self.stream.synchronize()
        return self._host.tolist()

    def release(self) -> None:
        """Drop the buffers and the key: the next call binds anew."""
        self.key = None
        self.fn = self.stream = None
        self.partials = self.out = self.host = self._host = None


def fe_moments_cuda(params, seed_words, epoch, base_path, *, N: int,
                    n_paths: int, device, rng: str = "philox",
                    rot: int | None = None, antithetic: bool = False,
                    box: str = "hc", fast_sqrt: bool = False,
                    launch: BoundLaunch | None = None):
    """(E[Y], E[Y^2]) over n_paths FE path groups, as float64 0-dim
    tensors on ``device``; Y is the mean payoff of a group's rot coupled
    copies (Y = X at rot 1).

    params: float32 tensor (8,) on the CPU, (T, S_0, v_0, r, k, rho,
    theta, sigma); the kernel receives the values by argument.
    seed_words: the (k0, k1) u32 key pair; epoch and base_path: u32
    stream coordinates (group p draws from path base_path + p's stream);
    rng, rot, antithetic, box, fast_sqrt: as ``fe_moments_pallas``, with
    rng "device" for its "tpu" (``check_variant``).  Each launch adds one
    to ``fe_moments_cuda.launches`` and to
    ``fe_moments_cuda.variant_launches[variant_name(rng, rot, box,
    fast_sqrt)]``.

    launch: a pricer's ``BoundLaunch``.  On a CUDA device the call then
    reuses it where its static arguments (all but params and epoch) are
    those it was bound for, and binds it anew where they are not; only
    params and the epoch are converted in each call.  The return is then
    the launch's ``out``, one float64 vector (2,) on ``device``, (E[Y],
    E[Y^2]), which the next launch overwrites.  On the CPU the launch is
    left unbound and the plain version runs."""
    if launch is not None:
        key = (tuple(seed_words), base_path, N, n_paths, device_key(device),
               rng, rot, antithetic, box, fast_sqrt)
        if key == launch.key:
            return _fe_bound(launch, params, epoch)
    device, N, n_paths, k0, k1, epoch, base_path = check_args(
        params, seed_words, epoch, base_path, N, n_paths, device)
    rot = check_variant(rng, rot, antithetic, box, fast_sqrt)
    if device.type == "cpu":
        return fe_moments_kernel_plain(
            params, (k0, k1), epoch, base_path, N=N, n_paths=n_paths,
            rng=rng, rot=rot, box=box, fast_sqrt=fast_sqrt)

    name = variant_name(rng, rot, box, fast_sqrt)
    tail = (base_path, N, n_paths, RNGS.index(rng), rot, BOXES.index(box),
            int(bool(fast_sqrt)))
    if launch is not None:
        launch.bind(key, "nmch_fe_moments", name, device, (k0, k1), tail,
                    2 * (n_paths // LANES), 2)
        return _fe_bound(launch, params, epoch)
    partials = torch.empty(2 * (n_paths // LANES), dtype=torch.float64,
                           device=device)
    out = torch.empty(2, dtype=torch.float64, device=device)
    call_kernel("nmch_fe_moments", name, device, *params.tolist(),
                k0, k1, epoch, *tail, partials.data_ptr(), out.data_ptr())
    count_launch(fe_moments_cuda, name)
    return out[0], out[1]


def _fe_bound(launch: BoundLaunch, params, epoch):
    """K1 through a bound launch: the call's parameters and epoch."""
    check_params(params)
    launch.enqueue(params.tolist(), check_u32("epoch", epoch))
    count_launch(fe_moments_cuda, launch.name)
    return launch.out


fe_moments_cuda.launches = 0
fe_moments_cuda.variant_launches = {}
