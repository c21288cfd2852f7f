"""Multi-card scale-out example: shard paths over every visible card.

The counterpart of ``examples/multichip.py``.  One rank per visible card
on NCCL, each running kernel K1 on its share of the paths, or gloo ranks
on the CPU, which run the plain goldens:

    python -m nmch_tpu_torch.examples.multichip                  # cards
    python -m nmch_tpu_torch.examples.multichip --cpu --ranks 8  # CPU

The ranks meet through a ``file://`` store in a temporary directory, so
runs side by side never contend for a port.  Rank 0 hands its moments to
the launching process, which prints the four lines of the JAX example.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import tempfile

import torch

SEED, N = 1234, 200
PATHS_PER_RANK = 128 * 64
TIMEOUT_S = 600.0        # how long a rank waits for the others


def _rank(rank: int, world: int, backend: str, store: str, device,
          engine: str, out: str, timeout_s: float) -> None:
    """One rank: join the group, price its share, rank 0 writes the
    result to ``out``."""
    import torch.distributed as dist

    from ..params import HestonParams
    from ..parallel.mesh import make_mesh, sharded_moments

    if device == "cpu":
        # the ranks share this machine's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = make_mesh(device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        m, m2 = sharded_moments(mesh, HestonParams().as_tensor("cpu"),
                                seed=SEED, epoch=0, N=N,
                                n_paths=PATHS_PER_RANK * world, method="fe",
                                engine=engine)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"m": m.item(), "m2": m2.item(),
                           "device": str(mesh.device),
                           "backend": backend}, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> dict:
    """Spawn the ranks, wait for all of them, print the four lines and
    return {"devices", "platform", "n_paths", "m", "m2", "price", "err",
    "oracle"}.  A failed rank raises (torch.multiprocessing stops the
    others)."""
    ap = argparse.ArgumentParser(
        prog="python -m nmch_tpu_torch.examples.multichip")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU instead of one NCCL rank "
                         "per card")
    ap.add_argument("--ranks", type=int, default=8,
                    help="ranks with --cpu (default 8)")
    args = ap.parse_args(argv)

    from ..oracle import heston_call_undiscounted
    from ..params import HestonParams
    from ..results import SimResult

    if args.cpu:
        world, backend, device, engine = args.ranks, "gloo", "cpu", "scan"
        platform = "cpu"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card (torch.cuda.is_available() is "
                               "False); pass --cpu to run gloo ranks on "
                               "the CPU")
        world, backend, device, engine = (torch.cuda.device_count(), "nccl",
                                          None, "cuda")
        platform = "gpu"
    n_paths = PATHS_PER_RANK * world
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        torch.multiprocessing.start_processes(
            _rank, args=(world, backend, os.path.join(tmp, "store"), device,
                         engine, out, TIMEOUT_S),
            nprocs=world, join=True, start_method="spawn")
        with open(out) as f:
            rec = json.load(f)
    params = HestonParams()
    res = SimResult(rec["m"], rec["m2"], n_paths)
    oracle = heston_call_undiscounted(params)
    print(f"devices: {world} x {platform} ({backend})")
    print(f"paths:   {n_paths} (sharded {n_paths // world}/chip)")
    print(f"price:   {res.price:.6f} +/- {res.err:.2e}")
    print(f"oracle:  {oracle:.6f}")
    return {"devices": world, "platform": platform, "n_paths": n_paths,
            "m": rec["m"], "m2": rec["m2"], "price": res.price,
            "err": res.err, "oracle": oracle}


if __name__ == "__main__":
    main()
