"""launches_per_step: device kernels in the profiled steps' trace per
step (memory copies and fills left out)."""


def read(ctx):
    return ctx["profile"]["kernels"] / ctx["profile_steps"]
