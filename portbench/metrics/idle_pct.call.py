"""idle_pct.call: the share of the traced window in which no operation ran
on the card, in %."""


def read(ctx):
    if ctx.trace is None or ctx.unit != "call" or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.window.seconds)
