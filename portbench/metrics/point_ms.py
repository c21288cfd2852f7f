"""point_ms: the window's wall time over the grid points priced in it, a
point priced by every method of the sweep counting once."""


def read(ctx):
    return ctx.window.ms_per_unit() if ctx.unit == "point" else None
