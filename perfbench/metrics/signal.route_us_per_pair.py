"""signal.route_us_per_pair (us/pair): the time in the program's
``ff.signal.route`` spans (``auto``'s host integration of the whole clip
and its discontinuity check, inside ``ff.signal_chain``; opened only on
clips of 65,536 samples or more) in the traced slice, over the slice's
pairs. Nothing to read where the program records no such span."""

from perfbench.bench.spans import us_per_pair


def read(ctx):
    return us_per_pair(ctx, "ff.signal.route")
