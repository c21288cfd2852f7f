"""qmc_bridge_ms.call: the Brownian bridge's device time a call: the summed
time of the device operations launched inside the program's
``prepare.bridge`` spans (the bridge matrix's upload, the two products and
the sqrt(dt) scaling; ``portbench/span_ops.py``), over the calls completed
in the traced window, in ms.  Nothing where the program records no such
span."""

from portbench import span_ops


def read(ctx):
    return span_ops.device_ms_per_unit(ctx, "prepare.bridge") \
        if ctx.unit == "call" else None
