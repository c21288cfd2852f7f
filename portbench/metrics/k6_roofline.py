"""k6_roofline: K6 (csrc/qmc.cu, ``qmc_sim_paths``: the QMC engine's path
simulator), in % of its roofline, which bytes bound: the 8 N M bytes of
increments that a call of M = n_paths paths reads, over all its launches
(``portbench/roofline_qmc.py``), times the calls completed in the window,
at 3.35 TB/s, over the kernel's summed time in the trace (kernels matched
by name), so that splitting a call's paths into launches leaves the
reading as it is.  Nothing when the window launched none."""

import re

from portbench import roofline_qmc

KERNEL = re.compile(r"\bqmc_sim_paths\b")


def read(ctx):
    if ctx.trace is None:
        return None
    times = [e - s for name, s, e in ctx.trace.ops if KERNEL.search(name)]
    if not times:
        return None
    nbytes = ctx.window.units * roofline_qmc.k6_bytes(ctx.N, ctx.n_paths)
    return roofline_qmc.bytes_share_pct(nbytes, sum(times) / 1e9)
