"""``coverage_s``: the engine's ``coverage`` phase (a region's coverage
vectors and its coverage side sums, under ``coverage_norm``), seconds a
job; None where no job opened it (a program without the phase)."""

from pupbench.readers import phase_per_job


def read(ctx):
    if not any("coverage" in p for p in ctx.phases):
        return None
    return phase_per_job(ctx, "coverage")
