"""signal.device_us_per_pair (us/pair): the time in the program's
``ff.signal.device`` spans (the float32 signal chain on the card and the
copies of its curve and keyframe mask back to the host, inside
``ff.signal_chain``) in the traced slice, over the slice's pairs.
Nothing to read where the program records no such span."""

from perfbench.bench.spans import us_per_pair


def read(ctx):
    return us_per_pair(ctx, "ff.signal.device")
