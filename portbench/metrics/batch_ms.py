"""batch_ms: host ms per batch read (the trainer's `_next_batch`: the
pair draw, the memory-map reads and the copy to the card), the mean over
the traced run's window."""


def read(ctx):
    t = ctx.get("batch_s")
    return sum(t) * 1e3 / len(t) if t else None
