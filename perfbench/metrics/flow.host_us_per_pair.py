"""flow.host_us_per_pair (us/pair): the host's cost of issuing the flow
program, its time in the program's ``ff.window.program`` spans in the
traced slice, over the slice's pairs (beside ``flow.device_us_per_pair``,
the card's time for the same work). Nothing to read where the program
records no such span."""

from perfbench.bench.spans import us_per_pair


def read(ctx):
    return us_per_pair(ctx, "ff.window.program")
