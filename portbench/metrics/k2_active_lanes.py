"""k2_active_lanes: the share of K2's lane-slots that draw (csrc/em.cu,
``em_paths``): 100 x the counter blocks its lanes drew over 32 x the block
draws its warps executed, summed over the ``compute`` spans of the traced
window whose records carry both of K2's counts (``k2.blocks``,
``k2.warp_iters``: launches on its round schedule; the program's spans,
found as ``host_spans.program_spans`` finds them), in %.  Nothing where the
program records no such counts."""

from portbench import host_spans

WARP = 32


def read(ctx):
    if ctx.trace is None:
        return None
    blocks = iters = 0
    for r in host_spans.program_spans() or ():
        counts = getattr(r, "counts", None) or {}
        if r.name == "compute" and "k2.warp_iters" in counts:
            blocks += counts["k2.blocks"]
            iters += counts["k2.warp_iters"]
    return 100.0 * blocks / (WARP * iters) if iters else None
