"""qmc_points_ms.call: the QMC point set's device time a call: the summed
time of the device operations launched inside the program's
``prepare.points`` spans (the directions, the Sobol' words, the scramble
and the normals; ``portbench/span_ops.py``), over the calls completed in
the traced window, in ms.  Nothing where the program records no such
span."""

from portbench import span_ops


def read(ctx):
    return span_ops.device_ms_per_unit(ctx, "prepare.points") \
        if ctx.unit == "call" else None
