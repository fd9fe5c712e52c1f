"""streaming.windows_per_kpair (windows/kpair): flow windows dispatched
per thousand pairs (the runner's ``Flow windows dispatched: N (P pairs)``
line, summed over every clip of the run's window, traced or not). Ramp
and tail buckets raise it."""


def read(ctx):
    pairs = sum(c.pairs for c in ctx.window_clips)
    if pairs <= 0:
        return None
    return 1000.0 * sum(c.windows for c in ctx.window_clips) / pairs
