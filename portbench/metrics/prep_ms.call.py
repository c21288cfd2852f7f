"""prep_ms.call: the host's preparation a call: the union of the program's
``prepare`` spans (``prepare.*`` lie inside them) of the requests in the traced
window, over the calls completed in it, in ms (``portbench/host_spans.py``)."""

from portbench import host_spans


def read(ctx):
    return host_spans.prep_ms(ctx, "call")
