"""call_ms_p95: the nearest-rank 95th percentile of every call of the
window, each timed by the host clock (a call ends synchronised)."""


def read(ctx):
    if ctx.unit != "call":
        return None
    return ctx.window.step_ms_percentile(95.0)
