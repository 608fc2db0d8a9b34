"""opt_ms: device ms per step of the optimisers' updates (Stage 3: the
surfel Adam and the warp AdamW; Stage 2: the model's AdamW), from the
profiled steps' trace."""


def read(ctx):
    r = ctx["profile"]["ranges"].get("opt")
    return r["device_us"] / 1e3 / ctx["profile_steps"] if r else None
