"""k1_roofline: the forward compositor's share of its roofline, in %: the
bounds of the sampled calls (`portbench.bounds.kernel_bounds` on their
inputs, the pairs counted by the frozen plain compositor) over their
device times (CUDA events around the entry point `tile_forward.forward_tiles`,
whatever implements it, called on each sampled call's inputs)."""


def read(ctx):
    times = ctx.get("kernel_ms", {}).get("k1")
    if not times or None in times or not ctx["bounds"]:
        return None
    bound = sum(b["tile_forward"]["bound_ms"] for b in ctx["bounds"][:len(times)])
    return 100.0 * bound / sum(times[:len(ctx["bounds"])])
