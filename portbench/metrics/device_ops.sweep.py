"""device_ops.sweep: device operations (kernels, memsets, copies) in the
traced window per point completed."""


def read(ctx):
    if ctx.trace is None or ctx.unit != "point" or not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / ctx.window.units
