"""flow.host_launches_per_pair (launches/pair): the CUDA runtime and
driver calls that put work on the device (kernel and graph launches,
copies, memsets) in the traced slice, over the slice's pairs."""


def read(ctx):
    if ctx.trace is None or ctx.pairs <= 0:
        return None
    n = ctx.trace.launch_calls()
    return n / ctx.pairs if n > 0 else None
