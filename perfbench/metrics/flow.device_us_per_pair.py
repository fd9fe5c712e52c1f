"""flow.device_us_per_pair (us/pair): the summed duration of every device
kernel and copy in the traced slice over the slice's pairs."""


def read(ctx):
    if ctx.trace is None or ctx.pairs <= 0:
        return None
    t = ctx.trace.device_time_s()
    return 1e6 * t / ctx.pairs if t > 0 else None
