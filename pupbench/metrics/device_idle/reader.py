"""``device_idle``: the share of the profiled window with no kernel or copy
on the device."""

from pupbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
