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

A pricer passes its ``BoundLaunch`` (``launch=``, ``ops/launch.py``):
the launch's static arguments, buffers and entry point are then
validated, allocated and looked up once, and each call converts only its
parameters and epoch.  A call without one binds a fresh launch.
"""

from __future__ import annotations

from .fe import BOXES, DEVICE_NOT_TPU, LANES, fe_moments_kernel_plain
from .launch import RNGS, BoundLaunch, check_args, check_params, \
    check_u32, count_launch, device_key


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
    one_shot = launch is None
    if one_shot:
        launch, key = BoundLaunch(), None
    name = variant_name(rng, rot, box, fast_sqrt)
    tail = (base_path, N, n_paths, RNGS.index(rng), rot, BOXES.index(box),
            int(bool(fast_sqrt)))
    launch.bind(key, "nmch_fe_moments", name, device, (k0, k1), tail,
                2 * (n_paths // LANES), 2)
    out = _fe_bound(launch, params, epoch)
    return (out[0], out[1]) if one_shot else out


def _fe_bound(launch: BoundLaunch, params, epoch):
    """K1 through a bound launch, the tail of every call on a card: the
    call's parameters and epoch."""
    check_params(params)
    launch.enqueue(params.tolist(), check_u32("epoch", epoch))
    count_launch(fe_moments_cuda, launch.name)
    return launch.out


fe_moments_cuda.launches = 0
fe_moments_cuda.variant_launches = {}
