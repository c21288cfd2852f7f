"""device_ops.call: device operations (kernels, memsets, copies) in the
traced window per call completed."""


def read(ctx):
    if ctx.trace is None or ctx.unit != "call" or not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / ctx.window.units
