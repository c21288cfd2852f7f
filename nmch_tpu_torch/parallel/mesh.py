"""Path-sharded pricing over ``torch.distributed`` ranks.

The counterpart of ``nmch_tpu/parallel/mesh.py``.  Monte Carlo paths are
data-parallel, so the path axis is split over the ranks of a process
group: rank r simulates paths [r * per, (r + 1) * per) of the same
streams (base_path = r * per, per = n_paths / ranks), so a sharded run
draws exactly the per-path randomness of a single run with the same
(seed, epoch).  Each rank runs the kernel of its engine on its own card:
K1 (``fe_moments_cuda``) or K2 (``em_moments_cuda``) for engine="cuda",
the plain goldens for engine="scan", and for engine="qmc" the increments
of its range of Sobol' point indices and K6.

The ranks then exchange one small float64 tensor each, their per-rank
means (m, m2) (QMC: the n_shifts per-replicate payoff sums), with
``dist.all_gather``, and every rank sums the gathered tensors in rank
order (``combine_moments``).  ``nmch_tpu`` reduces with ``psum``; a float
``all_reduce`` leaves the order of the sum to the backend, the gather
fixes it.  With NCCL the tensors stay on the card; with gloo the 2 or
n_shifts values go through the CPU (gloo is for ranks on the CPU, or
ranks that share one card).

A rank is what a device of ``nmch_tpu``'s mesh is, and the checks of
``sharded_moments`` are ``nmch_tpu``'s, in its order and words, with the
port's engine names ("cuda" for "pallas", the card's device stream for
the TPU's).  The stateful families (xorwow, mrg32k3a) shard on the scan
engine only, as in ``nmch_tpu``: their skip-ahead gives random access to
any (path, epoch), so the stateful kernel K5 could host a rank's range
too, but neither package shards it.

Verified on one H100 (``chip_smoke.py``, the "scaleout" group): NCCL at a
world of one, and four gloo ranks that share the card.  NCCL across
several cards is unverified.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..ops.em import FAST_POISSON_CUT, em_moments_scan
from ..ops.em_cuda import em_moments_cuda
from ..ops.fe import DEVICE_NOT_TPU, LANES, fe_moments_rot_scan, \
    fe_moments_scan, path_index_grid
from ..ops.fe_cuda import fe_moments_cuda
from ..ops.fe_qmc import DEFAULT_N_SHIFTS, qmc_range_sums, \
    rqmc_moments_from_means
from ..ops.sampling import STATEFUL_RNGS
from ..rng.philox import split_seed

ENGINES = ("cuda", "scan", "qmc")
EM_RNGS = ("philox", "threefry4", *STATEFUL_RNGS)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ranks: the process group (None for the default group
    or for a world of one with no group), this rank, the world size, this
    rank's device, and the group's backend (None without a group)."""

    group: object
    rank: int
    world: int
    device: torch.device
    backend: str | None


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of ``group`` (the default group if None).  With no process
    group initialised the mesh is a world of one.  device: this rank's
    device; None means cuda:(LOCAL_RANK % device_count), LOCAL_RANK from
    the environment (torchrun sets it) or else the rank.  A rank that asks
    for a card and finds none raises; device="cpu" runs the plain
    versions."""
    if dist.is_available() and dist.is_initialized():
        rank = dist.get_rank(group)
        world = dist.get_world_size(group)
        backend = str(dist.get_backend(group))
    elif group is not None:
        raise ValueError("a process group was given but torch.distributed "
                         "is not initialised")
    else:
        rank, world, backend = 0, 1, None
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card (torch.cuda.is_available() is "
                               "False); pass device='cpu' to shard on the "
                               "CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device {device} is neither cpu nor cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} but torch.cuda."
                               f"is_available() is False")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs each rank on a card")
    return Mesh(group, rank, world, device, backend)


def check_sharded(world: int, epoch, *, N: int, n_paths: int,
                  method: str = "fe", engine: str = "cuda",
                  rng: str = "philox", rot: int = 1,
                  conditional: bool = False, scramble: str = "auto",
                  poisson_cut: float | None = None):
    """``nmch_tpu``'s checks of a sharded run, in its order and words, for
    ``world`` ranks; returns the resolved (scramble, poisson_cut).  Every
    rank runs them on the same arguments, so all raise or none does."""
    if n_paths % (world * LANES):
        raise ValueError(
            f"n_paths={n_paths} must be a multiple of 128*n_devices"
            f"={LANES * world}")
    if n_paths > 1 << 32:
        raise ValueError(f"n_paths={n_paths}: the last rank's base_path + "
                         f"paths per rank must stay within the 2^32 path "
                         f"indices of a stream")
    if method not in ("fe", "em"):
        raise ValueError(f"unknown method {method!r} (expected 'fe' or "
                         f"'em')")
    if method == "em" and rng not in EM_RNGS:
        raise ValueError("method='em' supports rng='philox'/'threefry4'/"
                         "'mrg32k3a'/'xorwow'")
    if method == "fe" and rng == "tpu":
        raise ValueError(DEVICE_NOT_TPU)
    if method == "fe" and engine == "scan" and rng == "device":
        raise ValueError("rng='device' requires engine='cuda'")
    if rng in STATEFUL_RNGS:
        # the stateful families shard like the counter rngs on the scan
        # engine: their skip-ahead gives each rank its own path range of
        # the same per-path streams
        if engine != "scan":
            raise ValueError(f"rng={rng!r} shards with engine='scan' "
                             f"only (the stateful recurrences live in "
                             f"the scan carry)")
        if rot != 1:
            raise ValueError(f"rng={rng!r} has no rot variants")
        if n_paths >= (1 << 31):
            raise ValueError(f"rng={rng!r} supports n_paths < 2^31 "
                             f"(path-jump bit range)")
        from ..rng.streams import stateful_max_epoch
        bound = stateful_max_epoch(rng)
        if int(epoch) >= bound:
            raise ValueError(f"epoch={int(epoch)} exceeds the {rng} "
                             f"stream layout's {bound} epochs per "
                             f"path block")
    if scramble not in ("auto", "lms-shift") and engine != "qmc":
        raise ValueError("scramble= applies to engine='qmc' only")
    if scramble == "auto":
        # nmch_tpu's measured crossover, on the global point count: shared
        # LMS below ~2^21 points, independent Owen scrambles above
        scramble = ("owen" if n_paths >= (1 << 21) else "lms-shift")
    if engine not in ENGINES:
        raise ValueError(
            f"unknown engine {engine!r} for sharded_moments (expected "
            "'cuda', 'scan' or 'qmc')")
    if engine == "qmc" and method != "fe":
        raise ValueError("engine='qmc' is FE-only")
    if engine == "qmc" and rot != 1:
        raise ValueError("engine='qmc' has no rot variants")
    if method == "em" and rot != 1:
        raise ValueError("rot is FE-only")
    if method == "fe" and conditional:
        raise ValueError("conditional is EM-only")
    if poisson_cut is not None and method != "em":
        raise ValueError("poisson_cut is EM-only")
    if method == "em" and poisson_cut is None:
        poisson_cut = FAST_POISSON_CUT   # NMCH_EM's default, not 4000
    # QMC: n_paths a multiple of 128 * world makes the points a replicate,
    # n_paths / 8, a multiple of 16 * world, so each rank takes an equal
    # range (nmch_tpu's check of it, mesh.py:135-137, cannot fire)
    return scramble, poisson_cut


def _params(params_vec) -> torch.Tensor:
    """The float32 (8,) parameter vector on the CPU."""
    pv = torch.as_tensor(params_vec, dtype=torch.float32).detach().cpu()
    if pv.shape != (8,):
        raise ValueError(f"params_vec must have shape (8,), not "
                         f"{tuple(pv.shape)}")
    return pv


def rank_moments(rank: int, world: int, params_vec, seed: int, epoch, *,
                 N: int, n_paths: int, method: str = "fe",
                 engine: str = "cuda", rng: str = "philox", rot: int = 1,
                 conditional: bool = False, scramble: str = "auto",
                 poisson_cut: float | None = None, device) -> torch.Tensor:
    """One rank's part of a sharded run, a float64 tensor on ``device``:
    its per-rank means (m, m2) over paths [rank * per, (rank + 1) * per),
    per = n_paths / world; for engine="qmc" its per-replicate payoff sums
    over Sobol' points [rank * count, (rank + 1) * count) of each of the
    n_shifts replicates, count = n_paths / n_shifts / world.
    ``combine_moments`` of the world's parts in rank order gives the
    sharded moments.  Arguments as ``sharded_moments``; on a CPU device
    engine="cuda" runs the kernels' plain versions."""
    if not 0 <= rank < world:
        raise ValueError(f"rank={rank} is not in [0, {world})")
    scramble, poisson_cut = check_sharded(
        world, epoch, N=N, n_paths=n_paths, method=method, engine=engine,
        rng=rng, rot=rot, conditional=conditional, scramble=scramble,
        poisson_cut=poisson_cut)
    device = torch.device(device)
    pv = _params(params_vec)
    k0, k1 = split_seed(seed)
    epoch = int(epoch)
    if engine == "qmc":
        count = n_paths // DEFAULT_N_SHIFTS // world
        return qmc_range_sums(pv, epoch, k0, k1, N=N, count=count,
                              base=rank * count, n_shifts=DEFAULT_N_SHIFTS,
                              sim="cuda", scramble=scramble, device=device)
    per = n_paths // world
    base = rank * per
    if engine == "cuda":
        if method == "fe":
            m, m2 = fe_moments_cuda(pv, (k0, k1), epoch, base, N=N,
                                    n_paths=per, device=device, rng=rng,
                                    rot=rot)
        else:
            m, m2 = em_moments_cuda(pv, (k0, k1), epoch, base, N=N,
                                    n_paths=per, device=device, rng=rng,
                                    conditional=conditional,
                                    poisson_cut=poisson_cut)
        return torch.stack([m, m2])
    pidx = path_index_grid(per, base, device)
    pv_dev = pv.to(device)
    if method == "fe" and rng in STATEFUL_RNGS:
        if rng == "mrg32k3a":
            from ..ops.fe_mrg import fe_moments_mrg as stateful
        else:
            from ..ops.fe_xorwow import fe_moments_xorwow as stateful
        m, m2 = stateful(pv_dev, N, pidx, epoch, seed)
    elif method == "fe" and rot > 1:
        m, m2 = fe_moments_rot_scan(pv_dev, N, pidx, epoch, k0, k1, rng=rng,
                                    rot=rot)
    elif method == "fe":
        m, m2 = fe_moments_scan(pv_dev, N, pidx, epoch, k0, k1, rng=rng)
    else:
        m, m2 = em_moments_scan(
            pv_dev, N, pidx, epoch, k0, k1, rng=rng,
            conditional=conditional, poisson_cut=poisson_cut,
            seed=seed if rng in STATEFUL_RNGS else None)
    return torch.stack([m, m2])


def combine_moments(parts, *, engine: str = "cuda",
                    n_paths: int | None = None):
    """(m, m2), float64 0-dim tensors, from the ranks' parts in rank order
    (``rank_moments``): summed in that order, then divided by the world
    size (FE/EM: each part is a rank's means over equally many paths).
    engine="qmc": the parts are per-replicate payoff sums, whose total
    over n_paths / n_shifts points per replicate gives the replicate
    means and ``rqmc_moments_from_means`` the moments (n_paths needed)."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    if engine == "qmc":
        if n_paths is None:
            raise ValueError("engine='qmc' needs n_paths")
        n_shifts = total.numel()
        return rqmc_moments_from_means(total / (n_paths // n_shifts),
                                       n_paths, n_shifts)
    # a 0-dim divisor: true division (torch on a card multiplies by the
    # reciprocal of a Python number)
    means = total / torch.tensor(float(len(parts)), dtype=total.dtype,
                                 device=total.device)
    return means[0], means[1]


def sharded_moments(mesh: Mesh, params_vec, seed: int, epoch, *, N: int,
                    n_paths: int, method: str = "fe", engine: str = "cuda",
                    rng: str = "philox", rot: int = 1,
                    conditional: bool = False, scramble: str = "auto",
                    poisson_cut: float | None = None):
    """(E[X], E[X^2]) over n_paths sharded across the mesh's ranks, as
    float64 0-dim tensors on the rank's device, the same on every rank.

    Each rank prices its share (``rank_moments``), the parts ride one
    ``dist.all_gather`` and every rank combines them in rank order
    (``combine_moments``).  The draws are a single run's with the same
    (seed, epoch): sharding changes the schedule, not the paths; only the
    grouping of the float64 sums differs.

    method "fe" or "em"; engine "cuda" (K1/K2 on each rank's card, their
    plain versions on a CPU rank), "scan" (the goldens) or "qmc" (FE by
    randomized QMC, K6); rng, rot, conditional, scramble as ``NMCH_FE`` /
    ``NMCH_EM``.  poisson_cut (EM only): None resolves to NMCH_EM's
    default, FAST_POISSON_CUT, so a default sharded EM run draws what a
    default NMCH_EM run draws (``em_moments_cuda``'s own None means the
    strict cut 4000); pass 4000.0 for curand's switch."""
    kw = dict(N=N, n_paths=n_paths, method=method, engine=engine, rng=rng,
              rot=rot, conditional=conditional, scramble=scramble,
              poisson_cut=poisson_cut)
    part = rank_moments(mesh.rank, mesh.world, params_vec, seed, epoch,
                        device=mesh.device, **kw)
    if mesh.backend is None:
        parts = [part]
    else:
        # NCCL gathers on the card; gloo through the CPU
        send = part if mesh.backend == "nccl" else part.cpu()
        parts = [torch.empty_like(send) for _ in range(mesh.world)]
        dist.all_gather(parts, send, group=mesh.group)
    m, m2 = combine_moments(parts, engine=engine, n_paths=n_paths)
    return m.to(mesh.device), m2.to(mesh.device)
