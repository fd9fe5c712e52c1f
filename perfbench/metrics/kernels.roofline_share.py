"""kernels.roofline_share (%): the hand kernels' share of their roofline
in the traced slice: for every launch of a kernel that ``kernels/*.json``
names, the least time its bytes and f32 operations need at the chip's
peaks (``peaks.json``), summed, over the summed device time of those
launches. A launch captured into a CUDA graph counts once per replay.
Nothing to read where the trace shows no hand kernel."""

from perfbench.bench.trace import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline(ctx.trace, ctx.kernels, ctx.launches, ctx.peaks)
