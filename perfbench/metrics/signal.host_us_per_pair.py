"""signal.host_us_per_pair (us/pair): the time in the program's
``ff.signal_chain`` spans (the host or device signal chain and the
keyframes, opened inside ``runner.compute_actions``) in the traced slice,
over the slice's pairs. Nothing to read where the program records no such
span."""

from perfbench.bench.spans import us_per_pair


def read(ctx):
    return us_per_pair(ctx, "ff.signal_chain")
