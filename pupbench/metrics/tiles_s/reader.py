"""``tiles_s``: the engine's ``tiles`` phase, seconds a job."""

from pupbench.readers import phase_per_job


def read(ctx):
    return phase_per_job(ctx, "tiles")
