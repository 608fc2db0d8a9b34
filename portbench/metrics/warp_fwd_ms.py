"""warp_fwd_ms: device ms per step of the operations launched inside the
deformer's warp calls of the forward (`warp_surfels`, `flow_surfels`,
`cycle_loss`), from the profiled steps' trace. Their backward is not
included."""


def read(ctx):
    r = ctx["profile"]["ranges"].get("warp_fwd")
    return r["device_us"] / 1e3 / ctx["profile_steps"] if r else None
