"""fwd_ms: device ms per step of the operations launched inside the step's
loss (Stage 3: `Stage3Trainer.loss`; Stage 2: `DvrModel.loss`), from the
profiled steps' trace."""


def read(ctx):
    r = ctx["profile"]["ranges"].get("fwd")
    return r["device_us"] / 1e3 / ctx["profile_steps"] if r else None
