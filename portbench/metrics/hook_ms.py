"""hook_ms: densify / opacity-reset / outlier hook time per step of the
traced run's window (each firing synchronised on both sides, host clock),
summed over the window and divided by its steps."""


def read(ctx):
    if "hook_s" not in ctx:
        return None
    return ctx["hook_s"] * 1e3 / ctx["steps"]
