"""idle_prep_pct.sweep: the share of the traced window in which the card was
idle while the host was inside a ``prepare`` span (``prepare`` or one of
its ``prepare.*`` parts), in % (``portbench/host_spans.py``)."""

from portbench import host_spans


def read(ctx):
    return host_spans.idle_prep_pct(ctx, "point")
