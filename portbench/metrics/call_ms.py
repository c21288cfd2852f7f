"""call_ms: the window's wall time over the user calls completed in it."""


def read(ctx):
    return ctx.window.ms_per_unit() if ctx.unit == "call" else None
