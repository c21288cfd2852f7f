"""k1_roofline: K1 (csrc/fe.cu, ``fe_paths``: FE philox rot 1), in % of its
roofline: the frozen work of its launches in the traced window
(``portbench/roofline.py``) at the card's peak issue rate, over the kernel's
time in the trace (kernels matched by name). Nothing when the window
launched none."""

import re

from portbench import roofline

KERNEL = re.compile(r"\bfe_paths\b")


def read(ctx):
    if ctx.trace is None:
        return None
    times = [e - s for name, s, e in ctx.trace.ops if KERNEL.search(name)]
    if not times:
        return None
    per_path = roofline.fe_path_work(ctx.N)
    work = len(times) * ctx.n_paths * per_path
    return roofline.share_pct(work, sum(times) / 1e9)
