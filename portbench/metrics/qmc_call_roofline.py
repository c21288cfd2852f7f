"""qmc_call_roofline: the QMC engine's whole call in % of its roofline: the
frozen work of the Sobol' points that the traced window's calls drew
(n_paths points a ``compute`` record whose ops are summed, times
``roofline_qmc.point_work(N)``) at the card's peak issue rate, over the
summed device time of the operations launched inside those ``compute``
spans (``portbench/span_ops.py``).  Nothing where the program records no
such span."""

from portbench import roofline, roofline_qmc, span_ops


def read(ctx):
    p = span_ops.placed(ctx)
    if p is None:
        return None
    ops, records = p
    calls, ns = set(), 0
    for (s, e, _), i in ops:
        i = span_ops.enclosing(records, i, "compute")
        if i >= 0:
            calls.add(i)
            ns += e - s
    if not calls:
        return None
    work = len(calls) * ctx.n_paths * roofline_qmc.point_work(ctx.N)
    return roofline.share_pct(work, ns / 1e9)
