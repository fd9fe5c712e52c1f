"""runner.host_us_per_pair (us/pair): the runner's own host time in the
traced slice, over the slice's pairs: the program's ``ff.clip`` spans less
the ``ff.decode_wait``, ``ff.window.*`` and ``ff.signal_chain`` spans
inside them (set-up, the funscript write and the loop's bookkeeping
stay). Nothing to read where the program records no ``ff.clip`` span."""

from perfbench.bench.spans import CLIP, CLIP_CHILDREN, self_us


def read(ctx):
    if ctx.trace is None or ctx.pairs <= 0:
        return None
    us = self_us(ctx.trace, CLIP, CLIP_CHILDREN)
    return None if us is None else us / ctx.pairs
