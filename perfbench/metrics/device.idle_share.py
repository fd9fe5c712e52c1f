"""device.idle_share (%): 1 - (the union of the device's kernel and copy
intervals over the traced slice's wall time)."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_share()
