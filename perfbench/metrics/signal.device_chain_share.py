"""signal.device_chain_share (%): the share of the run's window's pairs
whose clip ran the signal chain on the card: the pairs of the clips that
logged ``Signal chain: device`` (``runner.compute_actions`` takes that
chain, in ``auto``, for clips of 65,536 samples or more with no step in
their integrated flow), over the pairs of every clip that logged a
``Signal chain:`` line, traced or not. 0.0 where every clip took the
host chain; nothing to read where no clip logs such a line."""

_ANY = "Signal chain: "
_DEVICE = "Signal chain: device"


def read(ctx):
    device = total = 0
    for clip in ctx.window_clips:
        routes = [line for line in clip.logs if line.startswith(_ANY)]
        if routes:
            total += clip.pairs
            if any(line.startswith(_DEVICE) for line in routes):
                device += clip.pairs
    if total <= 0:
        return None
    return 100.0 * device / total
