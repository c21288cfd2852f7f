"""setup_s: process start to the first timed step (import, the kernel
library's build or load, pricer construction, the cell's warm-up)."""


def read(ctx):
    return ctx.setup_s
