"""k2_roofline: K2 (csrc/em.cu, ``em_paths``: EM philox, Poisson cut 128;
the work per path is the reference's count over its checked calls), in % of
its roofline: the frozen work of its launches in the traced window
(``portbench/roofline.py``) at the card's peak issue rate, over the kernel's
time in the trace (kernels matched by name). Nothing when the window
launched none."""

import re

from portbench import roofline

KERNEL = re.compile(r"\bem_paths\b")


def read(ctx):
    em = ctx.counts.get("em")
    if ctx.trace is None or not em:
        return None
    times = [e - s for name, s, e in ctx.trace.ops if KERNEL.search(name)]
    if not times:
        return None
    per_path = roofline.em_work(em, ctx.N) / em["paths"]
    work = len(times) * ctx.n_paths * per_path
    return roofline.share_pct(work, sum(times) / 1e9)
