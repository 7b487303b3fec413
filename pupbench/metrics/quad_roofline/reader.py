"""``quad_roofline``: the profiled jobs' accumulation bound over the
device time of the kernels listed in ``kernels/``."""

from pupbench.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "quad_roofline")
