"""streaming.upload_us_per_pair (us/pair): the host's time in the
program's ``ff.window.upload`` spans (a window assembled in pinned memory
and its copy to the card enqueued) in the traced slice, over the slice's
pairs. Nothing to read where the program records no such span."""

from perfbench.bench.spans import us_per_pair


def read(ctx):
    return us_per_pair(ctx, "ff.window.upload")
