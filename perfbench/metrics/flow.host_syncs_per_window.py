"""flow.host_syncs_per_window (syncs/window): the CUDA calls that make the
host wait for the card (stream, device and event synchronisation,
blocking copies: ``bench.spans.SYNC_CALLS``) that start inside the
program's ``ff.window.*`` spans in the traced slice, over the slice's
windows. 0.0 where the spans hold none; nothing to read where the
program records no such span."""

from perfbench.bench.spans import SYNC_CALLS, WINDOW, calls_inside


def read(ctx):
    windows = sum(c.windows for c in ctx.clips)
    if ctx.trace is None or windows <= 0:
        return None
    n = calls_inside(ctx.trace, SYNC_CALLS, WINDOW)
    return None if n is None else n / windows
