"""idle_pct: the share of the profiled steps' wall time in which no
operation ran on the device, in %."""


def read(ctx):
    return 100.0 * (1.0 - ctx["profile"]["busy_s"] / ctx["profile_s"])
