"""idle_caller_pct.call: the share of the traced window in which the card was
idle while the host was inside none of the program's spans: the caller's
own code, in % (``portbench/host_spans.py``).  What ``idle_pct`` has
beyond this and ``idle_prep_pct`` is idle time inside ``compute`` but
outside ``prepare`` (the syncs, the copy back), or before the first or
after the last operation."""

from portbench import host_spans


def read(ctx):
    return host_spans.idle_caller_pct(ctx, "call")
