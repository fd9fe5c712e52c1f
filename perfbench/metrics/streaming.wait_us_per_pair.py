"""streaming.wait_us_per_pair (us/pair): the host's time in the program's
``ff.window.wait`` spans (a window's results copied back: the host waits
for the card, then copies) in the traced slice, over the slice's pairs.
Nothing to read where the program records no such span."""

from perfbench.bench.spans import us_per_pair


def read(ctx):
    return us_per_pair(ctx, "ff.window.wait")
