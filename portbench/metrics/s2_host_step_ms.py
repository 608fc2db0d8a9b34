"""s2_host_step_ms: host ms per step of the program's Stage-2 step less its
batch read (its ``s2.step`` span less the ``data.batch`` inside it), from
the collector's records over the traced run's window; None where the
program has no such spans."""

from portbench import spans


def read(ctx):
    records = ctx.get("spans_host")
    host = spans.window(records)["host_ms"] if records else {}
    if "s2.step" not in host or "data.batch" not in host:
        return None
    return (host["s2.step"] - host["data.batch"]) / ctx["steps"]
