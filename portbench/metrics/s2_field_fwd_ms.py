"""s2_field_fwd_ms: device ms per step of the operations launched inside
the field's MLP queries of the Stage-2 forward (`DynNeRF.query`,
`visibility`, `features`: at the samples and at the regularisers' points;
the eikonal's SDF left out), from the profiled steps' trace. Their backward
is not included."""


def read(ctx):
    r = ctx["profile"]["ranges"].get("s2_field_fwd")
    return r["device_us"] / 1e3 / ctx["profile_steps"] if r else None
