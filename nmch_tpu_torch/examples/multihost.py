"""Multi-process (multi-host) pricing over torch.distributed.

The counterpart of ``examples/multihost.py``: the same
``sharded_moments`` call prices over every rank of every host, one card a
rank.  The only traffic between ranks is one gather of a 2-float tensor a
rank at the end (8 * n_shifts bytes with the QMC engine), so the
interconnect's latency does not matter.

Run one process per card of every host under ``torchrun`` (which sets
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT):

    torchrun --nnodes 2 --nproc-per-node 8 ... \\
        -m nmch_tpu_torch.examples.multihost --engine cuda

or let this script start P processes on this machine, which meet through
a ``file://`` store in a temporary directory:

    python -m nmch_tpu_torch.examples.multihost --cpu --processes 2
    python -m nmch_tpu_torch.examples.multihost --processes 4 \\
        --backend gloo --device cuda:0 --engine cuda

The first runs gloo ranks on the CPU (the plain versions); the second four
gloo ranks that share one card, each launching the kernels on its own
share of the paths (NCCL refuses two ranks on one card).  Rank 0 prints
the JAX example's line, ``hosts=H chips=C paths=P fe/scan: price=...
(E[X^2]=...)``, with C the number of ranks; ``--json`` adds one JSON line
a rank with its moments at full precision, its kernels' launch counts in
the call, the time of its share and the directory of the package it
imported.  Each rank's paths are a disjoint
range of the same per-path streams, so the price is a single run's.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

# this package's directory, and the one that holds it: the ranks this
# script starts import the package from there, whatever their working
# directory
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PACKAGE)


def _kernel_wrappers():
    from ..ops.em_cuda import em_moments_cuda
    from ..ops.fe_cuda import fe_moments_cuda
    from ..ops.fe_qmc_cuda import qmc_payoff_sums_cuda
    return fe_moments_cuda, em_moments_cuda, qmc_payoff_sums_cuda


def _print_line(text: str) -> None:
    """One line to stdout in one write, so that the ranks' lines, which
    share the launcher's stdout, never interleave."""
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), (text + "\n").encode())


def worker(args) -> None:
    """One rank: join the group (the launcher's store, or torchrun's
    environment), price, print."""
    import torch
    import torch.distributed as dist

    from ..params import HestonParams
    from ..parallel.mesh import make_mesh, rank_moments, sharded_moments

    backend = args.backend or ("gloo" if args.cpu else "nccl")
    device = args.device or ("cpu" if args.cpu else None)
    timeout = datetime.timedelta(seconds=args.timeout)
    if args.process_id is not None:
        dist.init_process_group(backend, init_method=f"file://{args.store}",
                                rank=args.process_id,
                                world_size=args.processes, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    try:
        mesh = make_mesh(device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        n_paths = args.paths_per_chip * mesh.world
        kw = dict(N=args.N, n_paths=n_paths, method=args.method,
                  engine=args.engine, rng=args.rng, rot=args.rot,
                  conditional=args.conditional)
        pv = HestonParams().as_tensor("cpu")
        wrappers = _kernel_wrappers()
        for fn in wrappers:
            fn.launches, fn.variant_launches = 0, {}
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        m, m2 = sharded_moments(mesh, pv, seed=1234, epoch=0, **kw)
        m, m2 = m.item(), m2.item()
        wall_s = time.perf_counter() - t0
        launches = {k: v for fn in wrappers
                    for k, v in fn.variant_launches.items()}
        if mesh.rank == 0:
            _print_line(f"hosts={mesh.world // local} chips={mesh.world} "
                        f"paths={n_paths} {args.method}/{args.engine}: "
                        f"price={m:.9f} (E[X^2]={m2:.6f})")
        if args.json:
            rec = {"rank": mesh.rank, "world": mesh.world,
                   "backend": mesh.backend, "device": str(mesh.device),
                   "package": _PACKAGE,
                   "n_paths": n_paths, "m": m, "m2": m2,
                   "launches": launches, "wall_s": wall_s}
            if mesh.device.type == "cuda":
                # this rank's share once more (its kernel launch, and the
                # increments with engine="qmc"), on CUDA events
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                rank_moments(mesh.rank, mesh.world, pv, 1234, 0,
                             device=mesh.device, **kw)
                e1.record()
                e1.synchronize()
                rec["rank_ms"] = e0.elapsed_time(e1)
            _print_line(json.dumps(rec))
    finally:
        dist.destroy_process_group()


def launch(argv, processes: int, timeout: float) -> int:
    """Start ``processes`` ranks of this script on this machine, meeting
    through a file store in a temporary directory, each importing this
    package (started in the directory that holds it, which leads their
    PYTHONPATH); wait for all of them.  A rank that fails, or a run past
    ``timeout`` seconds, stops the others.  Returns the largest exit code
    (124 at the timeout)."""
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_ROOT] + ([path] if path else [])))
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "nmch_tpu_torch.examples.multihost",
             *argv, f"--processes={processes}", f"--process-id={i}",
             f"--store={store}"], cwd=_ROOT, env=env)
            for i in range(processes)]
        deadline = time.monotonic() + timeout
        rc = 0
        try:
            while any(p.poll() is None for p in procs):
                failed = [p.returncode for p in procs
                          if p.returncode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    rc = max(failed) if failed else 124
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        return max([rc] + [p.returncode for p in procs])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m nmch_tpu_torch.examples.multihost")
    ap.add_argument("--cpu", action="store_true",
                    help="ranks on the CPU (gloo, the plain versions)")
    ap.add_argument("--processes", type=int, default=None,
                    help="start this many ranks here (default 2 with "
                         "--cpu); without it and without --cpu the ranks "
                         "come from torchrun's environment")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="default: gloo with --cpu, else nccl")
    ap.add_argument("--device", default=None,
                    help="every rank's device, e.g. cuda:0 for gloo ranks "
                         "that share one card (default: cpu with --cpu, "
                         "else cuda:(LOCAL_RANK %% cards))")
    ap.add_argument("--paths-per-chip", type=int, default=1024)
    ap.add_argument("--N", type=int, default=50)
    ap.add_argument("--method", choices=["fe", "em"], default="fe")
    ap.add_argument("--engine", choices=["cuda", "scan", "qmc"],
                    default="scan")
    ap.add_argument("--rng", default="philox",
                    help="stream family (incl. the stateful pair "
                         "mrg32k3a/xorwow on the scan engine: their "
                         "skip-ahead shards like the counter rngs)")
    ap.add_argument("--rot", type=int, default=1,
                    help="FE rotation sampling: 1, 2, 4 or 8")
    ap.add_argument("--conditional", action="store_true",
                    help="EM: closed-form conditional payoff")
    ap.add_argument("--json", action="store_true",
                    help="also print one JSON line a rank")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the ranks may take")
    ap.add_argument("--process-id", type=int, default=None,
                    help="(internal) set by the launcher")
    ap.add_argument("--store", default=None,
                    help="(internal) the launcher's file store")
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.process_id is None and (args.cpu or args.processes is not None):
        processes = 2 if args.processes is None else args.processes
        # the ranks get this argv and, last (so it wins), their own
        # --processes, --process-id and --store
        return launch(argv, processes, args.timeout)
    worker(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
